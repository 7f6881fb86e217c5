// Splash attention for Hopper (sm_90a): flash attention over per-head mask
// schedules, forward and backward, bound to Python via ctypes.
//
// Replaces, in ray_tpu/ops/splash_attention.py:
//   * _sfwd_kernel (:204; launched by _sfwd through _sched_call,
//     pl.pallas_call at :264) -> splash_fwd_kernel: online-softmax attention
//     over a compacted per-q-tile list of live kv tiles; out in the input
//     dtype, lse in fp32, out 0 and lse -1e30 for a row nothing live reaches.
//   * _sbwd_dq_kernel (:311; _sched_call at :415) -> splash_bwd_dq_kernel:
//     dQ over the same q schedule. P = exp(s - max(lse, -5e29)),
//     dS = P (dP - delta) scale, rounded to k's dtype before dS K.
//   * _sbwd_dkv_kernel (:350; _sched_call at :434) -> splash_bwd_dkv_kernel:
//     dV += P^T dO (P rounded to dO's dtype) and dK += dS^T Q (dS rounded to
//     q's dtype) over the transposed schedule (per kv tile, its live q
//     tiles). The TPU kernel writes fp32 per query head and sums the GQA
//     group outside; here the group sum happens in the fp32 accumulators and
//     dK/dV are written once in the input dtype.
// delta = rowsum(dO * O) comes from a plain PyTorch pre-pass, as in JAX.
//
// Masks (the `(code, param)` of splash_attention._kernel_mask): 0 full,
// 1 causal, 2 local (row >= col and row - col < window), 3 chunked (row >=
// col and row / chunk == col / chunk). Each is a range of keys per query
// row, [lo, hi], and a range of query rows per key, so the per-element test
// is two compares. It runs only on tiles whose schedule `full` flag is 0
// (the host clears the flag on a ragged last tile); full tiles skip it.
//
// What bounds it on an H100: at the splash path's shape (B=1, S=8192,
// 16 q heads on 8 kv heads, D=128, local / chunked / causal / full heads,
// ~298 M live (q, k) pairs per call) the forward does 4*D, dQ 6*D and
// dK/dV 8*D flops per live pair against ~0.1-0.2 GB moved, so the tensor
// cores bound all three (989 TFLOP/s bf16 against 3.35 TB/s: the H100 SXM
// data sheet's peaks, at its 700 W power limit). What the design does:
//   * Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate). S, P, dP and dS never leave registers: their C
//     fragments are rounded to bf16 and reused in place as the A operand of
//     the next product.
//   * The TPU's scalar-prefetched schedule becomes a tile list each block
//     reads for itself: forward and dQ run one block per (64-row q tile,
//     q head, batch) and loop t < kv_lens[i] over kv_ids[i, t]; dK/dV runs
//     one block per (64-key tile, kv head, batch) and loops over its GQA
//     group's query heads and q_ids[j, :q_lens[j]]. Padding slots past the
//     lengths are never visited. Every output element has one writer: no
//     atomics, deterministic. Blocks take their tiles in the order
//     `q_order` / `k_order` give (most live tiles first), so the heavy rows
//     of a causal or chunked mask do not leave a tail.
//   * The streamed tile (K/V, or Q/dO for dK/dV) is staged in dynamic
//     shared memory, rows padded by 16 bytes for conflict-free ldmatrix,
//     two stages deep with cp.async so the next tile's copies are in flight
//     while this one computes. Since the next tile comes from the list, the
//     copy of a tile far from the last one costs the same.
//   * The softmax runs in log2 units, so every exponential is one exp2.
//   * float32 inputs take the same path with each operand split into a
//     bf16 hi + lo pair (x = hi + lo to ~2^-16 relative): three products
//     (hi*hi + hi*lo + lo*hi) per mma keep the result near fp32 accuracy.
// Not done yet (later perf work): wgmma, TMA, warp specialisation.
//
// Layout: q/dO/out/dq (B, Sq, H, D), k/v/dk/dv (B, Sk, Hkv, D) or any
// layout reachable by (batch, seq, head) strides with the head dim
// contiguous, H and Hkv being the head group's; lse and delta (B, H, Sq)
// fp32 through (batch, head) strides. D is 64 or 128 (the Python wrapper
// zero-pads smaller head dims). Rows past Sq and keys past Sk are masked
// here, so no length needs to divide a tile. The schedule's tiles are 64 x
// 64 (splash_attention._TILE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;        // query rows of a q tile (16 per warp)
constexpr int kBN = 64;        // keys of a kv tile
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kIntMax = 0x7fffffff;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  const void* dout;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  // q schedule: (nq, q_len) kv tile ids and full flags, (nq) lengths, and
  // the order the forward / dQ blocks take q tiles in.
  const int* kv_ids;
  const int* kv_lens;
  const int* kv_full;
  const int* q_order;
  // Transposed schedule: (nk, k_len) q tile ids and full flags, (nk)
  // lengths, and the order the dK/dV blocks take kv tiles in.
  const int* q_ids;
  const int* q_lens;
  const int* q_full;
  const int* k_order;
  long long B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, lse_sb, lse_sh;
  long long mask_code, mask_param, q_len, k_len;
  float scale;
};

__device__ __forceinline__ long long clamp_ll(long long x, long long a,
                                              long long b) {
  return x < a ? a : (x > b ? b : x);
}

// Keys [lo, hi] that query `row` keeps under the group's mask, inside the
// key sequence.
__device__ __forceinline__ void key_range(const Params& p, int row, int& lo,
                                          int& hi) {
  long long l = 0, h = p.Sk - 1;
  if (p.mask_code != 0 && row < h) h = row;
  if (p.mask_code == 2) l = (long long)row - p.mask_param + 1;
  if (p.mask_code == 3) l = (long long)row / p.mask_param * p.mask_param;
  lo = (int)clamp_ll(l, -1, kIntMax);
  hi = (int)h;
}

// Query rows [lo, hi] that keep key `col` under the group's mask, inside
// the query sequence.
__device__ __forceinline__ void query_range(const Params& p, int col, int& lo,
                                            int& hi) {
  long long l = 0, h = p.Sq - 1, end = h;
  if (p.mask_code != 0) l = col;
  if (p.mask_code == 2) end = (long long)col + p.mask_param - 1;
  if (p.mask_code == 3)
    end = ((long long)col / p.mask_param + 1) * p.mask_param - 1;
  lo = (int)clamp_ll(l, -1, kIntMax);
  hi = (int)clamp_ll(end < h ? end : h, -1, kIntMax);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Residual of the bf16 rounding of x: x - float(bf16(x)).
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane i addresses row i % 8 of
// matrix i / 8. Plain: lane t receives row t/4, columns 2(t%4), 2(t%4)+1
// of each matrix. Transposed: rows 2(t%4), 2(t%4)+1 of column t/4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint16_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);

template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
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

__device__ __forceinline__ void cp_async_16(uint16_t* dst, const void* src,
                                            bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 zero-fills the 16 destination bytes and reads nothing.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [row0, row0 + 64) of one head of a (seq, D) operand into shared
// memory as bf16 bits (hi) and, for float32 input, the bf16 residual (lo).
// Rows past `valid` are zero. bf16 rows are copied with cp.async (the caller
// commits and waits); float32 rows are converted through registers.
template <typename T, int D, bool kSplit>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride,
                                          int row0, int valid, uint16_t* hi,
                                          uint16_t* lo) {
  constexpr int kLd = D + 8;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < 64 * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    uint16_t* dh = hi + r * kLd + c;
    if constexpr (kSplit) {
      uint16_t* dl = lo + r * kLd + c;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < valid)
        f = *reinterpret_cast<const float4*>(base + (row0 + r) * row_stride + c);
      uint2 h, l;
      h.x = pack_bf16(f.x, f.y);
      h.y = pack_bf16(f.z, f.w);
      l.x = pack_bf16(bf16_residual(f.x), bf16_residual(f.y));
      l.y = pack_bf16(bf16_residual(f.z), bf16_residual(f.w));
      *reinterpret_cast<uint2*>(dh) = h;
      *reinterpret_cast<uint2*>(dl) = l;
    } else {
      cp_async_16(dh, base + (row0 + (r < valid ? r : 0)) * row_stride + c,
                  r < valid);
    }
  }
}

// acc(16 x 8n, rows of this warp) += A(16 x 16*KS) * B(16*KS x 8n), A read
// from the warp's 16 rows of `a_hi` (row-major, k contiguous) and B from
// `b_hi` rows [n0, n0 + 8*NT) (row-major n x k, i.e. the mma's col layout),
// both by plain ldmatrix. float32 input adds the hi*lo and lo*hi terms.
template <int NT, int KS, int kLd, bool kSplit>
__device__ __forceinline__ void mma_rows_nk(float (&acc)[NT][4],
                                            const uint16_t* a_hi,
                                            const uint16_t* a_lo,
                                            const uint16_t* b_hi,
                                            const uint16_t* b_lo, int a_row0,
                                            int n0) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int aoff = (a_row0 + (mi & 1) * 8 + mr) * kLd + ks * 16 + (mi >> 1) * 8;
    uint32_t ah[4];
    ldsm_x4(ah, a_hi + aoff);
    uint32_t al[4];
    if constexpr (kSplit) ldsm_x4(al, a_lo + aoff);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      const int boff = (n0 + nt * 8 + (mi >> 1) * 8 + mr) * kLd + ks * 16 +
                       (mi & 1) * 8;
      uint32_t bh[4];
      ldsm_x4(bh, b_hi + boff);
      if constexpr (kSplit) {
        uint32_t bl[4];
        ldsm_x4(bl, b_lo + boff);
        mma16816(acc[nt], al, bh[0], bh[1]);
        mma16816(acc[nt], ah, bl[0], bl[1]);
        mma16816(acc[nt + 1], al, bh[2], bh[3]);
        mma16816(acc[nt + 1], ah, bl[2], bl[3]);
      }
      mma16816(acc[nt], ah, bh[0], bh[1]);
      mma16816(acc[nt + 1], ah, bh[2], bh[3]);
    }
  }
}

// acc(16 x D) += A(16 x 16*KK) * B(16*KK x D): A given as C fragments
// `c` of KK*2 n8 tiles (rounded to bf16 here, plus residuals for float32),
// B read from rows [k0, k0 + 16*KK) of `b_hi` (row-major k x D) by
// transposed ldmatrix.
template <int KK, int D, int kLd, bool kSplit>
__device__ __forceinline__ void mma_c_kd(float (&acc)[D / 8][4],
                                         float (&c)[2 * KK][4],
                                         const uint16_t* b_hi,
                                         const uint16_t* b_lo, int k0) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t ah[4];
    ah[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    ah[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    ah[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    ah[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
    uint32_t al[4];
    if constexpr (kSplit) {
      al[0] = pack_bf16(bf16_residual(c[2 * kk][0]), bf16_residual(c[2 * kk][1]));
      al[1] = pack_bf16(bf16_residual(c[2 * kk][2]), bf16_residual(c[2 * kk][3]));
      al[2] = pack_bf16(bf16_residual(c[2 * kk + 1][0]),
                        bf16_residual(c[2 * kk + 1][1]));
      al[3] = pack_bf16(bf16_residual(c[2 * kk + 1][2]),
                        bf16_residual(c[2 * kk + 1][3]));
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      const int off = (k0 + kk * 16 + (mi & 1) * 8 + mr) * kLd +
                      (dt + (mi >> 1)) * 8;
      uint32_t bh[4];
      ldsm_x4_trans(bh, b_hi + off);
      if constexpr (kSplit) {
        uint32_t bl[4];
        ldsm_x4_trans(bl, b_lo + off);
        mma16816(acc[dt], al, bh[0], bh[1]);
        mma16816(acc[dt], ah, bl[0], bl[1]);
        mma16816(acc[dt + 1], al, bh[2], bh[3]);
        mma16816(acc[dt + 1], ah, bl[2], bl[3]);
      }
      mma16816(acc[dt], ah, bh[0], bh[1]);
      mma16816(acc[dt + 1], ah, bh[2], bh[3]);
    }
  }
}

// Resident blocks per SM to budget registers for. The forward: 3 for bf16
// (<= 170 registers a thread); the backward kernels: 2 (their fp32
// accumulators need ~200). The float32 route needs more registers for its
// hi/lo operands and takes what it needs.
template <typename T, int kBf16Blocks>
struct MinBlocks {
  static constexpr int value = kBf16Blocks;
};
template <int kBf16Blocks>
struct MinBlocks<float, kBf16Blocks> {
  static constexpr int value = 1;
};

template <int D>
constexpr size_t tile_bytes() {
  return (size_t)64 * (D + 8) * sizeof(uint16_t);
}

// ------------------------------------------------------------ forward

// Two stages of [K hi, V hi, (K lo, V lo for float32)] tiles.
template <bool kSplit, int D>
constexpr size_t fwd_smem_bytes() {
  return 2 * (kSplit ? 4 : 2) * tile_bytes<D>();
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (MinBlocks<T, 3>::value))
    splash_fwd_kernel(const Params p) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kLd = D + 8;    // padded smem row (elements)
  constexpr int kKS = D / 16;   // k-steps of QK^T
  constexpr int kNT = kBN / 8;  // n8 tiles of S
  constexpr int kDT = D / 8;    // n8 tiles of O
  constexpr int kTile = kBN * kLd;
  constexpr int kStage = (kSplit ? 4 : 2) * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const smem = reinterpret_cast<uint16_t*>(smem_raw);

  const int qtile = p.q_order[blockIdx.x];  // most live tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (int)(p.H / p.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the warp's 16 (and +8)
  const int tg = lane & 3;   // column pair within an 8-wide tile
  const int Sq = (int)p.Sq;
  const int Sk = (int)p.Sk;
  const int r0 = qtile * kBM;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  int lo[2], hi[2];
  key_range(p, row[0], lo[0], hi[0]);
  key_range(p, row[1], lo[1], hi[1]);

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Q A-fragments, loaded once: reg0 (row g, cols 2tg..), reg1 (row g+8),
  // reg2 (row g, cols 8+2tg..), reg3 (row g+8, cols 8+2tg..).
  uint32_t qh[kKS][4];
  uint32_t ql[kSplit ? kKS : 1][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row[r & 1];
      const int col = ks * 16 + tg * 2 + (r >> 1) * 8;
      float2 x = make_float2(0.f, 0.f);
      if (rr < Sq) x = load2<T>(Q + rr * p.q_ss + col);
      qh[ks][r] = pack_bf16(x.x, x.y);
      if constexpr (kSplit)
        ql[ks][r] = pack_bf16(bf16_residual(x.x), bf16_residual(x.y));
    }
  }

  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  // This q tile's kv tile list. Scores run in log2 units (exp2 is the
  // SFU's native exponential); the -1e30 sentinels keep their meaning, lse
  // converts back at the end.
  const int* ids = p.kv_ids + qtile * p.q_len;
  const int* full = p.kv_full + qtile * p.q_len;
  const int n_tiles = p.kv_lens[qtile];
  const float scale_log2 = p.scale * kLog2e;

  auto fetch = [&](int t, int st) {
    const int kv0 = ids[t] * kBN;
    const int valid = min(kBN, Sk - kv0);
    uint16_t* base = smem + st * kStage;
    load_tile<T, D, kSplit>(K, p.k_ss, kv0, valid, base, base + 2 * kTile);
    load_tile<T, D, kSplit>(V, p.v_ss, kv0, valid, base + kTile,
                            base + 3 * kTile);
    cp_async_commit();
  };

  // Two-stage pipeline: tile t + 1 is in flight while tile t is computed.
  if (n_tiles > 0) fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int kv0 = ids[t] * kBN;
    const bool need_mask = full[t] == 0;
    if (t + 1 < n_tiles) {
      fetch(t + 1, st ^ 1);  // its stage was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* Kh = smem + st * kStage;
    const uint16_t* Vh = Kh + kTile;
    const uint16_t* Kl = Kh + 2 * kTile;  // float32 input only
    const uint16_t* Vl = Kh + 3 * kTile;

    // S = Q K^T (fp32 accumulate in registers). One ldmatrix.x4 brings
    // the B fragments of two n8 key tiles.
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const int mi = lane >> 3;
    const int mr = lane & 7;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        const int off = (nt * 8 + (mi >> 1) * 8 + mr) * kLd + ks * 16 +
                        (mi & 1) * 8;
        uint32_t bh[4];
        ldsm_x4(bh, Kh + off);
        if constexpr (kSplit) {
          uint32_t bl[4];
          ldsm_x4(bl, Kl + off);
          mma16816(s[nt], ql[ks], bh[0], bh[1]);
          mma16816(s[nt], qh[ks], bl[0], bl[1]);
          mma16816(s[nt + 1], ql[ks], bh[2], bh[3]);
          mma16816(s[nt + 1], qh[ks], bl[2], bl[3]);
        }
        mma16816(s[nt], qh[ks], bh[0], bh[1]);
        mma16816(s[nt + 1], qh[ks], bh[2], bh[3]);
      }
    }

    // Scale, and mask where the tile is not full (the -1e30 convention of
    // the TPU kernel).
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int col = kv0 + nt * 8 + tg * 2 + (e & 1);
          if (col < lo[e >> 1] || col > hi[e >> 1]) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax: rows are shared by the 4 threads of a quad.
    float mc[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      mc[0] = fmaxf(mc[0], fmaxf(s[nt][0], s[nt][1]));
      mc[1] = fmaxf(mc[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float msafe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float mn = fmaxf(m[i], mc[i]);
      msafe[i] = fmaxf(mn, kNegInf / 2);
      const float corr = exp2f(fmaxf(m[i], kNegInf / 2) - msafe[i]);
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][2 * i] *= corr;
        o[dt][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - msafe[e >> 1]);
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // O += P V: the S accumulators of two adjacent n8 tiles are exactly
    // the A fragment of a 16-key k-step.
    mma_c_kd<kBN / 16, D, kLd, kSplit>(o, s, Vh, Vl, 0);
    __syncthreads();  // stage st may be refilled by the next fetch
  }
  cp_async_wait<0>();

  // Finalize: reduce the partial sums over the quad, normalize, write.
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  float* lse = p.lse + b * p.lse_sb + h * p.lse_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (row[i] >= Sq) continue;
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    T* orow = out + row[i] * p.o_ss;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      store2<T>(orow + dt * 8 + tg * 2, o[dt][2 * i] * inv,
                o[dt][2 * i + 1] * inv);
    if (tg == 0)
      lse[row[i]] = li == 0.f ? kNegInf
                              : fmaxf(m[i], kNegInf / 2) * 0.6931471805599453f +
                                    logf(li);
  }
}

// ------------------------------------------------------------ dK / dV

// K and V (hi, lo), two stages of Q and dO (hi, lo), two stages of per-row
// lse (log2 units) and delta.
template <bool kSplit, int D>
constexpr size_t dkv_smem_bytes() {
  return (kSplit ? 4 : 2) * tile_bytes<D>() * 3 + 2 * 2 * kBM * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (MinBlocks<T, 2>::value))
    splash_bwd_dkv_kernel(const Params p) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kLd = D + 8;
  constexpr int kKS = D / 16;
  constexpr int kDT = D / 8;
  constexpr int kTile = 64 * kLd;
  constexpr int kParts = kSplit ? 2 : 1;  // hi (+ lo)
  constexpr int kStage = 2 * kParts * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const sK = reinterpret_cast<uint16_t*>(smem_raw);  // hi, lo
  uint16_t* const sV = sK + kParts * kTile;                      // hi, lo
  uint16_t* const sQD = sV + kParts * kTile;  // stages of [Q, dO] (hi, lo)
  float* const s_lse = reinterpret_cast<float*>(sQD + 2 * kStage);
  float* const s_dd = s_lse + 2 * kBM;

  const int ktile = p.k_order[blockIdx.x];  // most live tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = (int)(p.H / p.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int Sq = (int)p.Sq;
  const int Sk = (int)p.Sk;
  const int k0 = ktile * kBN;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int lo[2], hi[2];
  query_range(p, key[0], lo[0], hi[0]);
  query_range(p, key[1], lo[1], hi[1]);

  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, kSplit>(K, p.k_ss, k0, min(kBN, Sk - k0), sK, sK + kTile);
  load_tile<T, D, kSplit>(V, p.v_ss, k0, min(kBN, Sk - k0), sV, sV + kTile);
  cp_async_commit();

  // This kv tile's q tile list, walked once per query head of the group.
  const int* ids = p.q_ids + ktile * p.k_len;
  const int* full = p.q_full + ktile * p.k_len;
  const int n_qt = p.q_lens[ktile];
  const int n_it = group * n_qt;

  // Fetch iteration it (query head it / n_qt of the group, q tile
  // ids[it % n_qt]) into stage st.
  auto fetch = [&](int it, int st) {
    const int h = hk * group + it / n_qt;
    const int r0 = ids[it % n_qt] * kBM;
    const int valid = min(kBM, Sq - r0);
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    uint16_t* base = sQD + st * kStage;
    load_tile<T, D, kSplit>(Q, p.q_ss, r0, valid, base, base + 2 * kTile);
    load_tile<T, D, kSplit>(DO, p.do_ss, r0, valid, base + kTile,
                            base + 3 * kTile);
    const long long bh = b * p.lse_sb + h * p.lse_sh;
    for (int i = threadIdx.x; i < kBM; i += kThreads) {
      float l2 = 0.f, dd = 0.f;
      if (i < valid) {
        l2 = fmaxf(p.lse[bh + r0 + i], kNegInf / 2) * kLog2e;
        dd = p.delta[bh + r0 + i];
      }
      s_lse[st * kBM + i] = l2;
      s_dd[st * kBM + i] = dd;
    }
    cp_async_commit();
  };

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  if (n_it > 0) fetch(0, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int r0 = ids[it % n_qt] * kBM;
    const bool need_mask = full[it % n_qt] == 0;
    if (it + 1 < n_it) {
      fetch(it + 1, st ^ 1);  // its stage was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* Qh = sQD + st * kStage;
    const uint16_t* DOh = Qh + kTile;
    const uint16_t* Ql = Qh + 2 * kTile;  // float32 input only
    const uint16_t* DOl = Qh + 3 * kTile;
    const float* lse_s = s_lse + st * kBM;
    const float* dd_s = s_dd + st * kBM;

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S^T and dP^T for this warp's 16 keys x 32 queries.
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      mma_rows_nk<4, kKS, kLd, kSplit>(s, sK, sK + kTile, Qh, Ql, warp * 16,
                                       half * 32);
      mma_rows_nk<4, kKS, kLd, kSplit>(dp, sV, sV + kTile, DOh, DOl,
                                       warp * 16, half * 32);
      // P^T and dS^T in place (rows are keys, columns are queries).
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = half * 32 + j * 8 + tg * 2 + (e & 1);
          float x = s[j][e] * scale_log2;
          if (need_mask) {
            const int pos = r0 + cl;
            if (pos < lo[e >> 1] || pos > hi[e >> 1]) x = kNegInf;
          }
          const float pe = exp2f(x - lse_s[cl]);
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - dd_s[cl]) * p.scale;
        }
      }
      // dV += P^T dO ; dK += dS^T Q over this half's 32 queries.
      mma_c_kd<2, D, kLd, kSplit>(dv, s, DOh, DOl, half * 32);
      mma_c_kd<2, D, kLd, kSplit>(dk, dp, Qh, Ql, half * 32);
    }
    __syncthreads();  // stage st may be refilled by the next fetch
  }
  cp_async_wait<0>();  // the K/V copies, when no q tile was visited

  T* DK = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* DV = static_cast<T*>(p.dv) + b * p.dk_sb + hk * p.dk_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const long long off = key[i] * p.dk_ss + dt * 8 + tg * 2;
      store2<T>(DK + off, dk[dt][2 * i], dk[dt][2 * i + 1]);
      store2<T>(DV + off, dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// ----------------------------------------------------------------- dQ

// Q and dO (hi, lo), two stages of K and V (hi, lo).
template <bool kSplit, int D>
constexpr size_t dq_smem_bytes() {
  return (kSplit ? 4 : 2) * tile_bytes<D>() * 3;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, (MinBlocks<T, 2>::value))
    splash_bwd_dq_kernel(const Params p) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int kLd = D + 8;
  constexpr int kKS = D / 16;
  constexpr int kNT = kBN / 8;
  constexpr int kDT = D / 8;
  constexpr int kTile = 64 * kLd;
  constexpr int kParts = kSplit ? 2 : 1;
  constexpr int kStage = 2 * kParts * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const sQ = reinterpret_cast<uint16_t*>(smem_raw);  // hi, lo
  uint16_t* const sDO = sQ + kParts * kTile;                     // hi, lo
  uint16_t* const sKV = sDO + kParts * kTile;  // stages of [K, V] (hi, lo)

  const int qtile = p.q_order[blockIdx.x];  // most live tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (int)(p.H / p.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int Sq = (int)p.Sq;
  const int Sk = (int)p.Sk;
  const int r0 = qtile * kBM;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
  int lo[2], hi[2];
  key_range(p, row[0], lo[0], hi[0]);
  key_range(p, row[1], lo[1], hi[1]);

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, kSplit>(Q, p.q_ss, r0, min(kBM, Sq - r0), sQ, sQ + kTile);
  load_tile<T, D, kSplit>(DO, p.do_ss, r0, min(kBM, Sq - r0), sDO,
                          sDO + kTile);
  cp_async_commit();

  float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  const long long bh = b * p.lse_sb + h * p.lse_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    lse2[i] = fmaxf(p.lse[bh + row[i]], kNegInf / 2) * kLog2e;
    dd[i] = p.delta[bh + row[i]];
  }

  float dq[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const float scale_log2 = p.scale * kLog2e;
  const int* ids = p.kv_ids + qtile * p.q_len;
  const int* full = p.kv_full + qtile * p.q_len;
  const int n_tiles = p.kv_lens[qtile];
  auto fetch = [&](int t, int st) {
    const int kv0 = ids[t] * kBN;
    const int valid = min(kBN, Sk - kv0);
    uint16_t* base = sKV + st * kStage;
    load_tile<T, D, kSplit>(K, p.k_ss, kv0, valid, base, base + 2 * kTile);
    load_tile<T, D, kSplit>(V, p.v_ss, kv0, valid, base + kTile,
                            base + 3 * kTile);
    cp_async_commit();
  };

  if (n_tiles > 0) fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int kv0 = ids[t] * kBN;
    const bool need_mask = full[t] == 0;
    if (t + 1 < n_tiles) {
      fetch(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* Kh = sKV + st * kStage;
    const uint16_t* Vh = Kh + kTile;
    const uint16_t* Kl = Kh + 2 * kTile;  // float32 input only
    const uint16_t* Vl = Kh + 3 * kTile;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_rows_nk<kNT, kKS, kLd, kSplit>(s, sQ, sQ + kTile, Kh, Kl, warp * 16, 0);
    mma_rows_nk<kNT, kKS, kLd, kSplit>(dp, sDO, sDO + kTile, Vh, Vl,
                                       warp * 16, 0);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int col = kv0 + nt * 8 + tg * 2 + (e & 1);
          if (col < lo[e >> 1] || col > hi[e >> 1]) x = kNegInf;
        }
        const float pe = exp2f(x - lse2[e >> 1]);
        s[nt][e] = pe * (dp[nt][e] - dd[e >> 1]) * p.scale;  // dS
      }
    }
    // dQ += dS K over the tile's 64 keys.
    mma_c_kd<kBN / 16, D, kLd, kSplit>(dq, s, Kh, Kl, 0);
    __syncthreads();  // stage st may be refilled by the next fetch
  }
  cp_async_wait<0>();  // the Q/dO copies, when no kv tile was visited

  T* out = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    T* orow = out + row[i] * p.dq_ss;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      store2<T>(orow + dt * 8 + tg * 2, dq[dt][2 * i], dq[dt][2 * i + 1]);
  }
}

// -------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

dim3 q_grid(const Params& p) {
  return dim3((unsigned)((p.Sq + kBM - 1) / kBM), (unsigned)p.H,
              (unsigned)p.B);
}

template <typename T, int D>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  return launch(splash_fwd_kernel<T, D>, q_grid(p),
                fwd_smem_bytes<kSplit, D>(), p, stream);
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  return launch(splash_bwd_dq_kernel<T, D>, q_grid(p),
                dq_smem_bytes<kSplit, D>(), p, stream);
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const dim3 grid((unsigned)((p.Sk + kBN - 1) / kBN), (unsigned)p.Hkv,
                  (unsigned)p.B);
  return launch(splash_bwd_dkv_kernel<T, D>, grid,
                dkv_smem_bytes<kSplit, D>(), p, stream);
}

// ptrs: q, k, v, out, lse, do, delta, dq, dk, dv, kv_ids, kv_lens, kv_full,
//       q_order, q_ids, q_lens, q_full, k_order (null where unused).
// ints: dtype (0 bf16, 1 f32), B, H, Hkv, Sq, Sk, D,
//       q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
//       o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
//       dk_sb, dk_ss, dk_sh (dv has dk's strides), lse_sb, lse_sh (delta
//       has lse's strides), mask code, mask param, q_len, k_len.
Params parse(void* const* ptrs, const long long* ints, float scale) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.out = ptrs[3];
  p.lse = static_cast<float*>(ptrs[4]);
  p.dout = ptrs[5];
  p.delta = static_cast<const float*>(ptrs[6]);
  p.dq = ptrs[7];
  p.dk = ptrs[8];
  p.dv = ptrs[9];
  const int** const sched[8] = {&p.kv_ids, &p.kv_lens, &p.kv_full,
                                &p.q_order, &p.q_ids, &p.q_lens,
                                &p.q_full, &p.k_order};
  for (int i = 0; i < 8; ++i) *sched[i] = static_cast<const int*>(ptrs[10 + i]);
  p.B = ints[1];
  p.H = ints[2];
  p.Hkv = ints[3];
  p.Sq = ints[4];
  p.Sk = ints[5];
  long long* const rest[27] = {
      &p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,      &p.k_ss,     &p.k_sh,
      &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.o_sb,      &p.o_ss,     &p.o_sh,
      &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb,     &p.dq_ss,    &p.dq_sh,
      &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.lse_sb,    &p.lse_sh,   &p.mask_code,
      &p.mask_param, &p.q_len, &p.k_len};
  for (int i = 0; i < 27; ++i) *rest[i] = ints[7 + i];
  p.scale = scale;
  return p;
}

template <template <typename, int> class Launch>
int dispatch(void* const* ptrs, const long long* ints, float scale,
             void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (dtype == 0 && D == 128) return (int)Launch<__nv_bfloat16, 128>::run(p, st);
  if (dtype == 0 && D == 64) return (int)Launch<__nv_bfloat16, 64>::run(p, st);
  if (dtype == 1 && D == 128) return (int)Launch<float, 128>::run(p, st);
  if (dtype == 1 && D == 64) return (int)Launch<float, 64>::run(p, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D>
struct Fwd {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    return launch_fwd<T, D>(p, s);
  }
};
template <typename T, int D>
struct Dq {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    return launch_dq<T, D>(p, s);
  }
};
template <typename T, int D>
struct Dkv {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    return launch_dkv<T, D>(p, s);
  }
};

}  // namespace

// The three entries take the same arguments (see `parse`) and return the
// cudaError_t of the launch (0 on success).
extern "C" int rtt_splash_fwd(void* const* ptrs, const long long* ints,
                              float scale, void* stream) {
  return dispatch<Fwd>(ptrs, ints, scale, stream);
}

extern "C" int rtt_splash_bwd_dq(void* const* ptrs, const long long* ints,
                                 float scale, void* stream) {
  return dispatch<Dq>(ptrs, ints, scale, stream);
}

extern "C" int rtt_splash_bwd_dkv(void* const* ptrs, const long long* ints,
                                  float scale, void* stream) {
  return dispatch<Dkv>(ptrs, ints, scale, stream);
}
