// Flash attention backward for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces: ray_tpu/ops/flash_attention.py::_bwd_dkv_kernel (pl.pallas_call
// at :382) and ::_bwd_dq_kernel (pl.pallas_call at :430), launched by _bwd.
// Same function, flash-attention-2 style: P is recomputed from the forward's
// lse, P = exp(s - max(lse, -5e29)) in fp32; dV += P^T dO with P rounded to
// dO's dtype; dP = dO V^T in fp32 plus the optional lse cotangent;
// dS = P (dP - delta) scale, rounded to q's dtype before dK += dS^T Q and to
// k's dtype before dQ += dS K; fp32 accumulators; causal, sliding-window and
// q_offset masks with dead tiles skipped; segment-id equality; GQA. delta =
// rowsum(dO * O) comes from a plain PyTorch pre-pass, as in the JAX package.
//
// What bounds it on an H100: at the training path's shapes (S = 2048,
// D = 128, causal) the dK/dV kernel does 4 products and the dQ kernel 3 over
// the live (q, k) pairs, ~8x and ~6x B*H*D*pairs flops, against ~0.2 GB of
// traffic, so the tensor cores bound both (989 TFLOP/s bf16 against
// 3.35 TB/s: the H100 SXM data sheet's peaks, at its 700 W power limit).
// What the design does about that:
//   * Every product runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate). S, P, dP and dS never leave registers: the C
//     fragments of S^T / dS^T (dK/dV kernel) and S / dS (dQ kernel) are
//     rounded to bf16 and reused in place as the A operand of the next
//     product, as in the forward kernel.
//   * The TPU's sequential grid axes become loops inside a block:
//     - dK/dV: one block per (64-key tile, kv head, batch), 4 warps of 16
//       keys each. It loops over the query heads of its GQA group and over
//       the q tiles live for its key tile (causal frontier, window,
//       q_offset), so the group sum of dK/dV happens in the fp32
//       accumulators (the TPU kernel writes fp32 per query head and sums
//       outside). Each query tile is processed in two 32-row halves so S^T
//       and dP^T take 32 registers, beside the 128 of the dK and dV
//       accumulators (16 x 128 fp32 each per warp).
//     - dQ: one block per (64-row q tile, q head, batch), 4 warps of 16 rows,
//       looping over the live kv tiles as the forward does.
//     Every output element is written by exactly one block: no atomics, and
//     the result is deterministic.
//   * The tile that streams (Q/dO for dK/dV, K/V for dQ) is staged in
//     dynamic shared memory, rows padded by 16 bytes for conflict-free
//     ldmatrix, two stages deep with cp.async so the next tile's copies are
//     in flight while this one computes. The block's own tile (K/V, or Q/dO)
//     stays in shared memory for the whole loop.
//   * Masks are tested per element only on tiles that straddle the causal
//     or window frontier or a ragged edge, or when segment ids are given.
//   * float32 inputs take the same path with each operand split into a
//     bf16 hi + lo pair (three products per mma), as in the forward kernel.
// Not done yet (later perf work): wgmma, TMA, warp specialisation.
//
// Layout: q/dO (B, Sq, H, D), k/v (B, Sk, Hkv, D) or any layout reachable by
// (batch, seq, head) strides with the head dim contiguous; lse, delta and
// the lse cotangent (B, H, Sq) fp32 contiguous; dq (B, Sq, H, D) and dk/dv
// (B, Sk, Hkv, D) written in the input dtype. D is 64 or 128 (the Python
// wrapper zero-pads smaller head dims).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;        // query rows of a q tile
constexpr int kBN = 64;        // keys of a kv tile
constexpr int kThreads = 128;  // 4 warps of 16 rows (dQ) or 16 keys (dK/dV)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  const float* dlse;   // (B, H, Sq) or null
  const int* seg_q;    // (B, Sq) int32 or null
  const int* seg_k;    // (B, Sk) int32 or null
  void* dq;
  void* dk;
  void* dv;
  long long B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh;
  long long segq_sb, segk_sb;
  long long causal, has_window, window, q_offset;
  float scale;
};

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

// Resident blocks per SM to budget registers for: 2 for bf16 (the fp32
// accumulators need ~200 registers a thread); the float32 route takes the
// shared memory of a whole SM anyway.
template <typename T>
struct MinBlocks {
  static constexpr int value = 2;
};
template <>
struct MinBlocks<float> {
  static constexpr int value = 1;
};

template <bool kSplit, int D>
constexpr size_t tile_bytes() {
  return (size_t)64 * (D + 8) * sizeof(uint16_t);
}

// dK/dV kernel shared memory: K and V (hi, lo), two stages of Q and dO
// (hi, lo), two stages of per-row lse (log2 units), delta - dlse and
// segment id.
template <bool kSplit, int D>
constexpr size_t dkv_smem_bytes() {
  return (kSplit ? 4 : 2) * tile_bytes<kSplit, D>() * 3 +
         2 * 3 * kBM * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
    flash_bwd_dkv_kernel(const Params p) {
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
  int* const s_seg = reinterpret_cast<int*>(s_dd + 2 * kBM);

  const int ktile = blockIdx.x;  // causal: the low key tiles are heaviest
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = (int)(p.H / p.Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int Sq = (int)p.Sq;
  const int Sk = (int)p.Sk;
  const int q_offset = (int)p.q_offset;
  const int k0 = ktile * kBN;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, kSplit>(K, p.k_ss, k0, min(kBN, Sk - k0), sK, sK + kTile);
  load_tile<T, D, kSplit>(V, p.v_ss, k0, min(kBN, Sk - k0), sV, sV + kTile);
  cp_async_commit();
  int seg_key[2] = {0, 0};
  if (p.seg_k != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] < Sk) seg_key[i] = p.seg_k[b * p.segk_sb + key[i]];
  }

  // Live q tiles of this key tile (block-uniform), as `_tile_live`: the
  // causal frontier starts the range, the window ends it.
  const int nq = (Sq + kBM - 1) / kBM;
  int qt_begin = 0, qt_end = nq;
  if (p.causal) {
    const int num = k0 - q_offset - (kBM - 1);
    if (num > 0) qt_begin = (num + kBM - 1) / kBM;
  }
  if (p.has_window) {
    const int x = k0 + kBN - 1 + (int)p.window - q_offset;
    qt_end = x <= 0 ? 0 : min(nq, (x + kBM - 1) / kBM);
  }
  const int n_qt = max(0, qt_end - qt_begin);
  const int n_it = group * n_qt;

  // Fetch iteration it (query head it / n_qt of the group, q tile
  // qt_begin + it % n_qt) into stage st.
  auto fetch = [&](int it, int st) {
    const int h = hk * group + it / n_qt;
    const int r0 = (qt_begin + it % n_qt) * kBM;
    const int valid = min(kBM, Sq - r0);
    const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    uint16_t* base = sQD + st * kStage;
    load_tile<T, D, kSplit>(Q, p.q_ss, r0, valid, base, base + 2 * kTile);
    load_tile<T, D, kSplit>(DO, p.do_ss, r0, valid, base + kTile,
                            base + 3 * kTile);
    const long long bh = (b * p.H + h) * p.Sq;
    for (int i = threadIdx.x; i < kBM; i += kThreads) {
      float l2 = 0.f, dd = 0.f;
      int sg = 0;
      if (i < valid) {
        l2 = fmaxf(p.lse[bh + r0 + i], kNegInf / 2) * kLog2e;
        dd = p.delta[bh + r0 + i];
        if (p.dlse != nullptr) dd -= p.dlse[bh + r0 + i];
        if (p.seg_q != nullptr) sg = p.seg_q[b * p.segq_sb + r0 + i];
      }
      s_lse[st * kBM + i] = l2;
      s_dd[st * kBM + i] = dd;
      s_seg[st * kBM + i] = sg;
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
    if (it + 1 < n_it) {
      fetch(it + 1, st ^ 1);  // its stage was released by the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = (qt_begin + it % n_qt) * kBM;
    const uint16_t* Qh = sQD + st * kStage;
    const uint16_t* DOh = Qh + kTile;
    const uint16_t* Ql = Qh + 2 * kTile;  // float32 input only
    const uint16_t* DOl = Qh + 3 * kTile;
    const float* lse_s = s_lse + st * kBM;
    const float* dd_s = s_dd + st * kBM;
    const int* seg_s = s_seg + st * kBM;
    const int pos_lo = q_offset + r0;
    const int pos_hi = q_offset + min(r0 + kBM, Sq) - 1;
    const bool need_mask =
        p.seg_k != nullptr || k0 + kBN > Sk || r0 + kBM > Sq ||
        (p.causal && k0 + kBN - 1 > pos_lo) ||
        (p.has_window && pos_hi - k0 >= (int)p.window);

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
            const int kc = key[e >> 1];
            const int pos = q_offset + r0 + cl;
            bool keep = kc < Sk && r0 + cl < Sq;
            if (p.causal) keep = keep && pos >= kc;
            if (p.has_window) keep = keep && pos - kc < (int)p.window;
            if (p.seg_k != nullptr) keep = keep && seg_s[cl] == seg_key[e >> 1];
            if (!keep) x = kNegInf;
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
  cp_async_wait<0>();  // the K/V copies, when no q tile was live

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

// dQ kernel shared memory: Q and dO (hi, lo), two stages of K and V
// (hi, lo), two stages of kv segment ids.
template <bool kSplit, int D>
constexpr size_t dq_smem_bytes() {
  return (kSplit ? 4 : 2) * tile_bytes<kSplit, D>() * 3 +
         2 * kBN * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
    flash_bwd_dq_kernel(const Params p) {
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
  int* const seg_smem = reinterpret_cast<int*>(sKV + 2 * kStage);

  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
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

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, kSplit>(Q, p.q_ss, r0, min(kBM, Sq - r0), sQ, sQ + kTile);
  load_tile<T, D, kSplit>(DO, p.do_ss, r0, min(kBM, Sq - r0), sDO,
                          sDO + kTile);
  cp_async_commit();

  float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  int seg_row[2] = {0, 0};
  const long long bh = (b * p.H + h) * p.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    lse2[i] = fmaxf(p.lse[bh + row[i]], kNegInf / 2) * kLog2e;
    dd[i] = p.delta[bh + row[i]];
    if (p.dlse != nullptr) dd[i] -= p.dlse[bh + row[i]];
    if (p.seg_q != nullptr) seg_row[i] = p.seg_q[b * p.segq_sb + row[i]];
  }

  float dq[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  // Live kv range of this q tile, as in the forward kernel.
  const float scale_log2 = p.scale * kLog2e;
  const int pos_lo = (int)p.q_offset + r0;
  const int pos_hi = (int)p.q_offset + min(r0 + kBM, Sq) - 1;
  int kv_end = Sk;
  if (p.causal) kv_end = min(kv_end, pos_hi + 1);
  int kv_begin = 0;
  if (p.has_window) kv_begin = max(0, pos_lo - (int)p.window + 1);
  kv_begin = (kv_begin / kBN) * kBN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBN - 1) / kBN
                                         : 0;
  auto fetch = [&](int t, int st) {
    const int kv0 = kv_begin + t * kBN;
    const int valid = min(kBN, Sk - kv0);
    uint16_t* base = sKV + st * kStage;
    load_tile<T, D, kSplit>(K, p.k_ss, kv0, valid, base, base + 2 * kTile);
    load_tile<T, D, kSplit>(V, p.v_ss, kv0, valid, base + kTile,
                            base + 3 * kTile);
    if (p.seg_k != nullptr) {
      for (int i = threadIdx.x; i < kBN; i += kThreads)
        seg_smem[st * kBN + i] =
            i < valid ? p.seg_k[b * p.segk_sb + kv0 + i] : 0;
    }
    cp_async_commit();
  };

  if (n_tiles > 0) fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int kv0 = kv_begin + t * kBN;
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
    const int* seg_s = seg_smem + st * kBN;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_rows_nk<kNT, kKS, kLd, kSplit>(s, sQ, sQ + kTile, Kh, Kl, warp * 16, 0);
    mma_rows_nk<kNT, kKS, kLd, kSplit>(dp, sDO, sDO + kTile, Vh, Vl,
                                       warp * 16, 0);
    const bool need_mask =
        p.seg_k != nullptr || kv0 + kBN > Sk || r0 + kBM > Sq ||
        (p.causal && kv0 + kBN - 1 > pos_lo) ||
        (p.has_window && pos_hi - kv0 >= (int)p.window);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (need_mask) {
          const int cl = nt * 8 + tg * 2 + (e & 1);
          const int col = kv0 + cl;
          const int pos = (int)p.q_offset + row[e >> 1];
          bool keep = col < Sk && row[e >> 1] < Sq;
          if (p.causal) keep = keep && pos >= col;
          if (p.has_window) keep = keep && pos - col < (int)p.window;
          if (p.seg_k != nullptr) keep = keep && seg_row[e >> 1] == seg_s[cl];
          if (!keep) x = kNegInf;
        }
        const float pe = exp2f(x - lse2[e >> 1]);
        s[nt][e] = pe * (dp[nt][e] - dd[e >> 1]) * p.scale;  // dS
      }
    }
    // dQ += dS K over the tile's 64 keys.
    mma_c_kd<kBN / 16, D, kLd, kSplit>(dq, s, Kh, Kl, 0);
    __syncthreads();  // stage st may be refilled by the next fetch
  }
  cp_async_wait<0>();  // the Q/dO copies, when no kv tile was live

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

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const size_t smem = dkv_smem_bytes<kSplit, D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((p.Sk + kBN - 1) / kBN), (unsigned)p.Hkv,
                  (unsigned)p.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const size_t smem = dq_smem_bytes<kSplit, D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((p.Sq + kBM - 1) / kBM), (unsigned)p.H,
                  (unsigned)p.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ptrs: q, k, v, do, lse, delta, dlse, seg_q, seg_k, dq, dk, dv.
// ints: dtype (0 bf16, 1 f32), B, H, Hkv, Sq, Sk, D,
//       q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
//       do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh
//       (dv has dk's strides), segq_sb, segk_sb,
//       causal, has_window, window, q_offset.
Params parse(void* const* ptrs, const long long* ints, float scale) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.dout = ptrs[3];
  p.lse = static_cast<const float*>(ptrs[4]);
  p.delta = static_cast<const float*>(ptrs[5]);
  p.dlse = static_cast<const float*>(ptrs[6]);
  p.seg_q = static_cast<const int*>(ptrs[7]);
  p.seg_k = static_cast<const int*>(ptrs[8]);
  p.dq = ptrs[9];
  p.dk = ptrs[10];
  p.dv = ptrs[11];
  p.B = ints[1];
  p.H = ints[2];
  p.Hkv = ints[3];
  p.Sq = ints[4];
  p.Sk = ints[5];
  long long* const strides[18] = {
      &p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,
      &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.do_sb, &p.do_ss, &p.do_sh,
      &p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh};
  for (int i = 0; i < 18; ++i) *strides[i] = ints[7 + i];
  p.segq_sb = ints[25];
  p.segk_sb = ints[26];
  p.causal = ints[27];
  p.has_window = ints[28];
  p.window = ints[29];
  p.q_offset = ints[30];
  p.scale = scale;
  return p;
}

}  // namespace

// Both entries take the same arguments and return the cudaError_t of the
// launch (0 on success).
extern "C" int rtt_flash_bwd_dkv(void* const* ptrs, const long long* ints,
                                 float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (dtype == 0 && D == 128) return (int)launch_dkv<__nv_bfloat16, 128>(p, st);
  if (dtype == 0 && D == 64) return (int)launch_dkv<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch_dkv<float, 128>(p, st);
  if (dtype == 1 && D == 64) return (int)launch_dkv<float, 64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtt_flash_bwd_dq(void* const* ptrs, const long long* ints,
                                float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (dtype == 0 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(p, st);
  if (dtype == 0 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch_dq<float, 128>(p, st);
  if (dtype == 1 && D == 64) return (int)launch_dq<float, 64>(p, st);
  return (int)cudaErrorInvalidValue;
}
