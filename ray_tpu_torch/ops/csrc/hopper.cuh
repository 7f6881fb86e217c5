// Hopper (sm_90a) building blocks shared by the port's attention kernels
// (flash_fwd.cu, flash_bwd.cu, splash.cu): mbarriers, TMA loads and the
// tensor maps they read, wgmma shared-memory descriptors and products,
// named barriers, and the online-softmax step in the wgmma accumulator
// layout. Each kernel source includes it once; cuda_build hashes it with
// the source, so an edit here rebuilds every kernel that includes it.
//
// The accumulator layout of an m64nN product, per thread of a warpgroup
// (warp w, lane = 4g + tg): d[4j + e] is row 16w + g + 8(e >> 1), column
// 8j + 2tg + (e & 1).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWg = 128;  // threads of a warpgroup

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the SFU's ex2.approx (flushing subnormals): one instruction,
// where exp2f adds a range fix-up around it. Relative error ~2^-22.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                      float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Write one thread's rows of a (64 x D) accumulator in the mma / wgmma
// layout (acc[4j + e]: row half e >> 1, column 8j + 2tg + (e & 1)) to rows
// row[0], row[1] of `out` (those below `rows`), in pairs of columns.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(T* out, long long row_stride,
                                           const int (&row)[2], int rows,
                                           int tg, const float (&acc)[NO]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    T* orow = out + row[i] * row_stride;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      store2<T>(orow + j * 8 + tg * 2, acc[4 * j + 2 * i],
                acc[4 * j + 2 * i + 1]);
  }
}

// ------------------------------------------------------ mbarriers, TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A debug build
// (nvcc -DRTT_FLASH_WAIT_LIMIT=10000000000ll, ~6 s of SM cycles) traps in
// a wait that outlives the limit, so a lost arrival fails the launch
// instead of hanging the card. Not in the shipped build: a trap is a
// sticky error that ends the process's CUDA context, and a long but
// legitimate stall (a debugger, compute preemption on a shared card) must
// wait instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  if (done) return;
#ifdef RTT_FLASH_WAIT_LIMIT
  const long long t0 = clock64();
#endif
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
#ifdef RTT_FLASH_WAIT_LIMIT
    if (!done && clock64() - t0 > RTT_FLASH_WAIT_LIMIT) __trap();
#endif
  } while (!done);
}

// One box of a 4-D (D, S, H, B) tensor map into shared memory, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int d0, int row,
                                            int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// One box of a 1-D tensor map (fp32 from element x).
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x)
      : "memory");
}

// ------------------------------------------------------------- wgmma

// wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Named barriers between the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * kWg) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * kWg) : "memory");
}

#define RTT_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define RTT_W8(d, i)                                                    \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),           \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

#define RTT_SS_N128                                                        \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"

#define RTT_SS_N64                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"

// d(64 x 128, f32) (+)= A(64 x 16) B(16 x 128)^T, both K-major in shared
// memory. Without kAccumulate, d is only written (scale-d 0, "=f"), so its
// old values are dead before the product, not kept live into it.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  if constexpr (kAccumulate)
    asm volatile(RTT_SS_N128
                 : RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24),
                   RTT_F8(d, 32), RTT_F8(d, 40), RTT_F8(d, 48), RTT_F8(d, 56)
                 : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(RTT_SS_N128
                 : RTT_W8(d, 0), RTT_W8(d, 8), RTT_W8(d, 16), RTT_W8(d, 24),
                   RTT_W8(d, 32), RTT_W8(d, 40), RTT_W8(d, 48), RTT_W8(d, 56)
                 : "l"(da), "l"(db), "r"(0));
}

// d(64 x 64, f32) (+)= A(64 x 16) B(16 x 64)^T, both K-major in shared
// memory; kAccumulate as above.
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if constexpr (kAccumulate)
    asm volatile(RTT_SS_N64
                 : RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24)
                 : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(RTT_SS_N64
                 : RTT_W8(d, 0), RTT_W8(d, 8), RTT_W8(d, 16), RTT_W8(d, 24)
                 : "l"(da), "l"(db), "r"(0));
}

// d(64 x 128, f32) += A(64 x 16, registers) B(16 x 128), B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24),
        RTT_F8(d, 32), RTT_F8(d, 40), RTT_F8(d, 48), RTT_F8(d, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d(64 x 64, f32) += A(64 x 16, registers) B(16 x 64), B MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_F8(d, 0), RTT_F8(d, 8), RTT_F8(d, 16), RTT_F8(d, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Issue d(64 x 64) = A(64 x D) B(64 x D)^T, both K-major tiles of 64-column
// boxes (`a_box` / `b_box` bytes apart; 128-byte rows, 8-row groups 1024
// bytes apart): a 16-wide k step is 32 bytes into the swizzled row. The
// caller fences before and commits after.
template <int D>
__device__ __forceinline__ void ss_product(float (&d)[32], uint32_t a_base,
                                           uint32_t a_box, uint32_t b_base,
                                           uint32_t b_box) {
  const uint64_t da = smem_desc(a_base, 16, 1024);
  const uint64_t db = smem_desc(b_base, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t oa = ((kk / 4) * a_box + (kk % 4) * 32) >> 4;
    const uint32_t ob = ((kk / 4) * b_box + (kk % 4) * 32) >> 4;
    if (kk == 0)
      wgmma_ss_n64<false>(d, da + oa, db + ob);
    else
      wgmma_ss_n64<true>(d, da + oa, db + ob);
  }
}

// Issue d(64 x D) += A(64 x 64, registers: the bf16 pairs of a 64 x 64
// accumulator, a[4kk..4kk+3] the fragment of k step kk, i.e. of n8 tiles 2kk
// and 2kk + 1) B(64 x D), B a tile of (row, d) in 64-row boxes read
// MN-major by the B-transpose bit: 8-row groups 1024 bytes apart (SBO),
// 64-column boxes 8 KB apart (LBO), a 16-row k step 2048 bytes.
template <int D>
__device__ __forceinline__ void rs_product(float (&d)[D / 2],
                                           const uint32_t (&a)[16],
                                           uint32_t b_base) {
  const uint64_t db = smem_desc(b_base, 64 * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    const uint64_t dk = db + ((kk * 2048) >> 4);
    if constexpr (D == 128)
      wgmma_rs_n128(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                    dk);
    else
      wgmma_rs_n64(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                   dk);
  }
}

// The bf16 pairs of a 64 x 64 accumulator: the A operand of rs_product.
__device__ __forceinline__ void pack_a(uint32_t (&a)[16], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// ------------------------------------------------------------ softmax

// Online softmax over one tile of scores that `scale` takes to log2 units
// (a positive factor, so it commutes with the max). `s` holds n8 tiles of
// the accumulator layout; a row is shared by the 4 threads of a quad.
// Turns `s` into P, updates the running max and sum, and returns in `corr`
// the factor the output accumulator must be scaled by (which the caller
// applies once no product into it is in flight).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mc[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mc[0] = fmaxf(mc[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mc[1] = fmaxf(mc[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float msafe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
    mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2)) * scale;
    const float mn = fmaxf(m[i], mc[i]);
    msafe[i] = fmaxf(mn, kNegInf / 2);
    corr[i] = fast_exp2(fmaxf(m[i], kNegInf / 2) - msafe[i]);
    m[i] = mn;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float pe = fast_exp2(fmaf(s[i], scale, -msafe[(i >> 1) & 1]));
    s[i] = pe;
    l[(i >> 1) & 1] += pe;
  }
}

// Scale each row half of an accumulator in that layout by its factor.
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];
}

// -------------------------------------------------------- tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda at build time); null if the driver does not provide it.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// Returned by an entry when a tensor map cannot be made: the CUresult of
// cuTensorMapEncodeTiled is added to it (0: no entry point).
constexpr int kEncodeError = 10000;

// A 4-D bf16 tensor map over (D, S, H, B) with element strides (s, h, b),
// boxes of (64, rows, 1, 1) and 128-byte swizzle. A dimension of extent 1
// is never stepped, so it gets a packed stride (a view may carry any
// stride there, and the map needs multiples of 16 bytes).
int encode_4d(CUtensorMap* map, const void* base, long long D, long long S,
              long long H, long long B, long long ss, long long sh,
              long long sb, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError;
  const long long ext[3] = {S, H, B};
  const long long st[3] = {ss, sh, sb};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3];
  long long packed = D;
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)((ext[i] == 1 ? packed : st[i]) * 2);
    packed *= ext[i];
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// A 1-D fp32 tensor map over n elements with boxes of `box` (per-row
// statistics, loaded from a 16-byte aligned start); past n the box is
// zero-filled.
int encode_1d(CUtensorMap* map, const float* base, long long n, int box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unused at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<float*>(base), dims, strides, boxes, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

}  // namespace
