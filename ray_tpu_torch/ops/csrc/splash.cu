// Splash attention for Hopper (sm_90a): flash attention over per-head mask
// schedules, forward and backward, bound to Python via ctypes.
//
// Replaces, in ray_tpu/ops/splash_attention.py:
//   * _sfwd_kernel (:204; launched by _sfwd through _sched_call,
//     pl.pallas_call at :264) -> rtt_splash_fwd: online-softmax attention
//     over a compacted per-q-tile list of live kv tiles; out in the input
//     dtype, lse in fp32, out 0 and lse -1e30 for a row nothing live reaches.
//   * _sbwd_dq_kernel (:311; _sched_call at :415) -> rtt_splash_bwd_dq:
//     dQ over the same q-major lists. P = exp(s - max(lse, -5e29)),
//     dS = P (dP - delta) scale, rounded to k's dtype before dS K.
//   * _sbwd_dkv_kernel (:350; _sched_call at :434) -> rtt_splash_bwd_dkv:
//     dV += P^T dO (P rounded to dO's dtype) and dK += dS^T Q (dS rounded to
//     q's dtype) over the transposed schedule (per kv tile, its live q
//     tiles). The TPU kernel writes fp32 per query head and sums the GQA
//     group outside; here the group sum happens in the fp32 accumulators and
//     dK/dV are written once in the input dtype, with no atomics.
// delta = rowsum(dO * O) comes from the pre-pass kernel of delta.cu.
//
// Kernels, chosen by the dtype code and nothing else:
//   * bfloat16 (the main path): splash_fwd_wgmma_kernel,
//     splash_bwd_dkv_wgmma_kernel and splash_bwd_dq_wgmma_kernel (below);
//   * float32 (no main path): splash_fwd_f32_kernel,
//     splash_bwd_dkv_f32_kernel and splash_bwd_dq_f32_kernel, mma.sync
//     m16n8k16 on bf16 hi + lo operand pairs (x = hi + lo to ~2^-16
//     relative; hi*hi + hi*lo + lo*hi per product keeps fp32 accuracy),
//     64 x 64 tiles, 4 warps.
// Each runs ONE launch over all head groups of a call, and the entries
// count their launches of each kernel (rtt_splash_launches).
//
// Masks (the `(code, param)` of splash_attention._kernel_mask): 0 full,
// 1 causal, 2 local (row >= col and row - col < window), 3 chunked (row >=
// col and row / chunk == col / chunk). Each is a range of keys per query
// row, [lo, hi], and a range of query rows per key, so the per-element test
// is two compares. It runs only on tiles whose schedule `full` flag is 0
// (the host clears the flag on a ragged last tile); full tiles skip it.
//
// The call schedule (splash_attention._call_schedule). Block x of the grid
// takes entry x of the schedule's block order (tile << 16 | head: the q
// head and q tile for the forward and dQ, which walk its q-major side, the
// kv head and key tile for dK/dV, which walk its transposed side), sorted
// by live-tile count, heaviest first across all heads and groups, so no
// heavy block starts in the last wave; grid y is the batch. One int32
// buffer holds, from its start:
//   [0, n_blocks)                  the block order;
//   [n_blocks, n_blocks + heads)   each head's group (heads: H for the
//                                  q-major side, Hkv for the transposed);
//   then a row of kGroupInts per group: mask code, mask param, and the
//   offsets into the buffer of the group's tile lists (ids, lens, full)
//   with their row length, then the group's first head and head count;
//   then the lists: ids and full flags (n_tiles x row length), lens
//   (n_tiles), the _Schedule arrays at the kernel's tiles.
// Each kernel walks the schedule built at its own tiles: the bf16 forward
// 128 x 128 (q rows x keys), bf16 dQ 128 x 64, dK/dV and every float32
// kernel 64 x 64.
//
// What bounds the bf16 kernels on an H100: the tensor cores. At the splash
// path's shape (B=1, S=8192, 16 q heads on 8 kv heads, D=128, local /
// chunked / causal / full heads, 297,824,256 live (q, k) pairs a call) the
// forward does 4*D flops per live pair (0.154 ms at 989 TFLOP/s), dK/dV
// 8*D (0.308 ms) and dQ 6*D (0.231 ms) against ~0.1-0.2 GB moved
// (0.03-0.06 ms at 3.35 TB/s).
// What the design does (PR 4 and PR 5's flash skeletons, on tile lists):
//   * Every product runs on wgmma (bf16 in, fp32 accumulate). 384 threads
//     in three warpgroups: WG0 is the producer (setmaxnreg.dec 40; one
//     thread issues TMA loads from 4-D tensor maps over the whole (D, S,
//     H, B) tensors, 64-column boxes, 128-byte swizzle, into a three-stage
//     mbarrier ring, reading the tile ids from the block's list); WG1 and
//     WG2 consume (setmaxnreg.inc 232).
//   * Forward: one block per (128-row q tile, q head); Q loaded once, the
//     listed 128-key K/V tiles streamed. Each consumer owns 64 rows: S = Q
//     K^T (m64n128k16), the exp2 softmax, O += P V with P as the register
//     A operand and V read MN-major; the two take turns at the tensor
//     cores (named barriers) so one's softmax runs under the other's
//     products.
//   * dK/dV: one block per (64-key tile, kv head); K and V loaded once;
//     the group's q heads x the key tile's listed 64-row q tiles streamed
//     with lse and delta (1-D boxes from the row index rounded down to a
//     multiple of 4: a TMA box must start 16-byte aligned). Consumers split
//     by product: WG1 S^T = K Q^T, P^T (handed to WG2 in fp32 through a
//     double-buffered shared slot) and dV += P^T dO; WG2 dP^T = V dO^T,
//     dS^T and dK += dS^T Q. Each issues its gradient product of q tile i
//     with its score product of tile i + 1.
//   * dQ: one block per (128-row q tile, q head); Q and dO loaded once,
//     the listed 64-key K/V tiles streamed. Each consumer owns 64 rows
//     (lse and delta in registers, plain loads) and per tile issues S = Q
//     K^T and dP = dO V^T together (m64n64k16), forms P and dS in
//     registers, then dQ += dS K (m64n{D}k16, K through the B-transpose
//     bit): dQ 64 + S 32 + dP 32 = 128 accumulator registers in flight.
//   * The softmax runs in log2 units: one FMA and one ex2.approx a score.
//   * A q tile that nothing reaches has a one-tile list, fully masked: it
//     gets P = 0 and so exactly zero dQ. An empty list (n = 0) issues no
//     load and waits on no barrier; its rows are stored as zeros.
//
// Layout: q/dO/out/dq (B, Sq, H, D), k/v/dk/dv (B, Sk, Hkv, D) or any
// layout reachable by (batch, seq, head) strides with the head dim
// contiguous and 16-byte aligned rows; lse and delta (B, H, Sq) fp32 (the
// dK/dV kernels read them contiguous and 16-byte aligned). D is 64 or 128
// (the Python wrapper zero-pads smaller head dims). Rows past Sq and keys
// past Sk are masked here, so no length needs to divide a tile.

#include "hopper.cuh"

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBM = 64;            // mma.sync kernels: query rows of a q tile
constexpr int kBN = 64;            // and keys of a kv tile
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kIntMax = 0x7fffffff;
constexpr int kGroupInts = 8;      // a group's row of the call schedule

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
  const int* sched;  // one side of the call schedule, see above
  long long B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh, lse_sb, lse_sh;
  long long n_blocks;  // entries of the call schedule's block order
  float scale;
};

// A block's share of the call schedule: its group's mask and the list of
// live tiles of its own tile.
struct Group {
  int code, param;   // the mask
  const int* ids;    // live tile ids
  const int* full;   // their full flags
  int n;             // their count
};

// Block x's head and tile from the call schedule's order, and its list.
// `n_heads` is H for the q-major side (forward, dQ), Hkv for dK/dV's.
__device__ __forceinline__ Group block_group(const Params& p, int n_heads,
                                             int& head, int& tile) {
  const int* const s = p.sched;
  const int n_blocks = (int)p.n_blocks;
  const int e = s[blockIdx.x];
  head = e & 0xffff;
  tile = e >> 16;
  const int* const row = s + n_blocks + n_heads + kGroupInts * s[n_blocks + head];
  Group g;
  g.code = row[0];
  g.param = row[1];
  g.ids = s + row[2] + tile * row[5];
  g.n = s[row[3] + tile];
  g.full = s + row[4] + tile * row[5];
  return g;
}

__device__ __forceinline__ long long clamp_ll(long long x, long long a,
                                              long long b) {
  return x < a ? a : (x > b ? b : x);
}

// Keys [lo, hi] that query `row` keeps under mask (code, param), inside the
// key sequence of length Sk.
__device__ __forceinline__ void key_range(long long code, long long param,
                                          long long Sk, int row, int& lo,
                                          int& hi) {
  long long l = 0, h = Sk - 1;
  if (code != 0 && row < h) h = row;
  if (code == 2) l = (long long)row - param + 1;
  if (code == 3) l = (long long)row / param * param;
  lo = (int)clamp_ll(l, -1, kIntMax);
  hi = (int)h;
}

// Query rows [lo, hi] that keep key `col` under mask (code, param), inside
// the query sequence of length Sq.
__device__ __forceinline__ void query_range(long long code, long long param,
                                            long long Sq, int col, int& lo,
                                            int& hi) {
  long long l = 0, h = Sq - 1, end = h;
  if (code != 0) l = col;
  if (code == 2) end = (long long)col + param - 1;
  if (code == 3) end = ((long long)col / param + 1) * param - 1;
  lo = (int)clamp_ll(l, -1, kIntMax);
  hi = (int)clamp_ll(end < h ? end : h, -1, kIntMax);
}

// ------------------------------------------- mma.sync kernels' helpers

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
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Stage rows [row0, row0 + 64) of one head of a (seq, D) float32 operand
// into shared memory as bf16 bits (hi) and the bf16 residual (lo), through
// registers. Rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile(const float* base,
                                          long long row_stride, int row0,
                                          int valid, uint16_t* hi,
                                          uint16_t* lo) {
  constexpr int kLd = D + 8;
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < 64 * kPerRow; idx += kMmaThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      f = *reinterpret_cast<const float4*>(base + (row0 + r) * row_stride + c);
    uint2 h, l;
    h.x = pack_bf16(f.x, f.y);
    h.y = pack_bf16(f.z, f.w);
    l.x = pack_bf16(bf16_residual(f.x), bf16_residual(f.y));
    l.y = pack_bf16(bf16_residual(f.z), bf16_residual(f.w));
    *reinterpret_cast<uint2*>(hi + r * kLd + c) = h;
    *reinterpret_cast<uint2*>(lo + r * kLd + c) = l;
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

template <int D>
constexpr size_t tile_bytes() {
  return (size_t)64 * (D + 8) * sizeof(uint16_t);
}

// ------------------------------------------------- float32 forward

// Two stages of [K hi, V hi, (K lo, V lo for float32)] tiles.
template <bool kSplit, int D>
constexpr size_t fwd_smem_bytes() {
  return 2 * (kSplit ? 4 : 2) * tile_bytes<D>();
}

// float32 only, one launch over all head groups: block x takes entry x of
// the call schedule's order (q head, 64-row q tile), batch blockIdx.y.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    splash_fwd_f32_kernel(const Params p) {
  using T = float;
  constexpr bool kSplit = true;
  constexpr int kLd = D + 8;    // padded smem row (elements)
  constexpr int kKS = D / 16;   // k-steps of QK^T
  constexpr int kNT = kBN / 8;  // n8 tiles of S
  constexpr int kDT = D / 8;    // n8 tiles of O
  constexpr int kTile = kBN * kLd;
  constexpr int kStage = (kSplit ? 4 : 2) * kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const smem = reinterpret_cast<uint16_t*>(smem_raw);

  int h, qtile;  // most live tiles first
  const Group grp = block_group(p, (int)p.H, h, qtile);
  const int b = blockIdx.y;
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
  key_range(grp.code, grp.param, p.Sk, row[0], lo[0], hi[0]);
  key_range(grp.code, grp.param, p.Sk, row[1], lo[1], hi[1]);

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
      if (rr < Sq) x = *reinterpret_cast<const float2*>(Q + rr * p.q_ss + col);
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
  const int* ids = grp.ids;
  const int* full = grp.full;
  const int n_tiles = grp.n;
  const float scale_log2 = p.scale * kLog2e;

  auto fetch = [&](int t, int st) {
    const int kv0 = ids[t] * kBN;
    const int valid = min(kBN, Sk - kv0);
    uint16_t* base = smem + st * kStage;
    load_tile<D>(K, p.k_ss, kv0, valid, base, base + 2 * kTile);
    load_tile<D>(V, p.v_ss, kv0, valid, base + kTile, base + 3 * kTile);
  };

  // Two stages: tile t + 1 is staged before tile t is computed.
  if (n_tiles > 0) fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int kv0 = ids[t] * kBN;
    const bool need_mask = full[t] == 0;
    // Tile t + 1 into the other stage, released by the last barrier.
    if (t + 1 < n_tiles) fetch(t + 1, st ^ 1);
    __syncthreads();
    const uint16_t* Kh = smem + st * kStage;
    const uint16_t* Vh = Kh + kTile;
    const uint16_t* Kl = Kh + 2 * kTile;
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

// ------------------------------------------------- float32 dK / dV

// K and V (hi, lo), two stages of Q and dO (hi, lo), two stages of per-row
// lse (log2 units) and delta.
template <bool kSplit, int D>
constexpr size_t dkv_smem_bytes() {
  return (kSplit ? 4 : 2) * tile_bytes<D>() * 3 + 2 * 2 * kBM * sizeof(float);
}

// float32 only, one launch over all head groups: block x takes entry x of
// the call schedule's order (kv head, 64-key tile), batch blockIdx.y.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    splash_bwd_dkv_f32_kernel(const Params p) {
  using T = float;
  constexpr bool kSplit = true;
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

  int hk, ktile;  // most live tiles first
  const Group grp = block_group(p, (int)p.Hkv, hk, ktile);
  const int b = blockIdx.y;
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
  query_range(grp.code, grp.param, p.Sq, key[0], lo[0], hi[0]);
  query_range(grp.code, grp.param, p.Sq, key[1], lo[1], hi[1]);

  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D>(K, p.k_ss, k0, min(kBN, Sk - k0), sK, sK + kTile);
  load_tile<D>(V, p.v_ss, k0, min(kBN, Sk - k0), sV, sV + kTile);

  // This kv tile's q tile list, walked once per query head of the group.
  const int* ids = grp.ids;
  const int* full = grp.full;
  const int n_qt = grp.n;
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
    load_tile<D>(Q, p.q_ss, r0, valid, base, base + 2 * kTile);
    load_tile<D>(DO, p.do_ss, r0, valid, base + kTile, base + 3 * kTile);
    const long long bh = b * p.lse_sb + h * p.lse_sh;
    for (int i = threadIdx.x; i < kBM; i += kMmaThreads) {
      float l2 = 0.f, dd = 0.f;
      if (i < valid) {
        l2 = fmaxf(p.lse[bh + r0 + i], kNegInf / 2) * kLog2e;
        dd = p.delta[bh + r0 + i];
      }
      s_lse[st * kBM + i] = l2;
      s_dd[st * kBM + i] = dd;
    }
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
    // Tile it + 1 into the other stage, released by the last barrier.
    if (it + 1 < n_it) fetch(it + 1, st ^ 1);
    __syncthreads();
    const uint16_t* Qh = sQD + st * kStage;
    const uint16_t* DOh = Qh + kTile;
    const uint16_t* Ql = Qh + 2 * kTile;
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

// ------------------------------------------------- float32 dQ

// Q and dO (hi, lo), two stages of K and V (hi, lo).
template <int D>
constexpr size_t dq_smem_bytes() {
  return 4 * tile_bytes<D>() * 3;
}

// float32 only, one launch over all head groups: block x takes entry x of
// the call schedule's order (q head, 64-row q tile), batch blockIdx.y.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    splash_bwd_dq_f32_kernel(const Params p) {
  using T = float;
  constexpr bool kSplit = true;
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

  int h, qtile;  // most live tiles first
  const Group grp = block_group(p, (int)p.H, h, qtile);
  const int b = blockIdx.y;
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
  key_range(grp.code, grp.param, p.Sk, row[0], lo[0], hi[0]);
  key_range(grp.code, grp.param, p.Sk, row[1], lo[1], hi[1]);

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* DO = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D>(Q, p.q_ss, r0, min(kBM, Sq - r0), sQ, sQ + kTile);
  load_tile<D>(DO, p.do_ss, r0, min(kBM, Sq - r0), sDO, sDO + kTile);

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
  const int* ids = grp.ids;
  const int* full = grp.full;
  const int n_tiles = grp.n;
  auto fetch = [&](int t, int st) {
    const int kv0 = ids[t] * kBN;
    const int valid = min(kBN, Sk - kv0);
    uint16_t* base = sKV + st * kStage;
    load_tile<D>(K, p.k_ss, kv0, valid, base, base + 2 * kTile);
    load_tile<D>(V, p.v_ss, kv0, valid, base + kTile, base + 3 * kTile);
  };

  if (n_tiles > 0) fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int kv0 = ids[t] * kBN;
    const bool need_mask = full[t] == 0;
    if (t + 1 < n_tiles) fetch(t + 1, st ^ 1);
    __syncthreads();
    const uint16_t* Kh = sKV + st * kStage;
    const uint16_t* Vh = Kh + kTile;
    const uint16_t* Kl = Kh + 2 * kTile;
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

// ----------------------------------------- bf16: wgmma, TMA, warpgroups

constexpr int kThreads = 3 * kWg;  // producer + two consumer warpgroups
constexpr int kStages = 3;         // ring depth of the streamed tiles
constexpr int kRowBytes = 128;     // one 64-column bf16 box row (the swizzle)
// Registers a thread after setmaxnreg: 128 * 40 + 256 * 232 = 64,512 of
// the SM's 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kFar = 1 << 30;      // an unbounded side of a q range

// Where `masked`, set the scores of a tile (the accumulator layout: s[4j +
// e] is row half e >> 1, column 8j + 2tg + (e & 1)) that the mask drops to
// -1e30 and the rest to log2 units. Row half r keeps the columns
// [lo[r], hi[r]) + 2tg (bounds on the column's compile-time part, so a test
// is two compares with a constant). Returns the factor still to apply to
// s: scale_log2 for a tile left as it is, 1 for a masked one.
template <int NS>
__device__ __forceinline__ float mask_range(float (&s)[NS], bool masked,
                                            const int (&lo)[2],
                                            const int (&hi)[2],
                                            float scale_log2) {
  if (!masked) return scale_log2;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int cc = (i >> 2) * 8 + (i & 1);  // column less 2tg
    const int r = (i >> 1) & 1;
    s[i] = cc >= lo[r] && cc < hi[r] ? s[i] * scale_log2 : kNegInf;
  }
  return 1.f;
}

// ---------------------------------------------------- bf16 forward

constexpr int kFwdTile = 128;                  // q rows and keys of a tile
constexpr int kFwdBox = kFwdTile * kRowBytes;  // a (64 col, 128 row) box

// Shared memory of the forward, as byte offsets from a 1024-byte aligned
// base: Q, kStages of K and of V (D / 64 boxes each), barriers.
template <int D>
struct FwdSmem {
  static constexpr int kTileBytes = kFwdTile * D * 2;
  static constexpr int q = 0;
  static constexpr int k = q + kTileBytes;
  static constexpr int v = k + kStages * kTileBytes;
  static constexpr int bar = v + kStages * kTileBytes;  // q_full, k_full[],
  static constexpr int total = bar + (1 + 3 * kStages) * 8;  // v_full[], empty[]
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_fwd_wgmma_kernel(const __grid_constant__ Params p,
                            const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + kStages;
  uint64_t* const empty = v_full + kStages;

  int h, qtile;  // heaviest first across all heads and groups
  const Group grp = block_group(p, (int)p.H, h, qtile);
  const int b = blockIdx.y;
  const int r0 = qtile * kFwdTile;
  const int n_tiles = grp.n;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 2 * kWg);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform as far as the compiler can tell (a shuffle from lane 0),
  // so each branch's setmaxnreg governs the registers of all its code.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  if (wg == 0) {
    // Producer: one thread issues every load, the kv tiles from the list.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0 || n_tiles == 0) return;
    const int hk = h / (int)(p.H / p.Hkv);
    mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(smem + L::q + c * kFwdBox, &tq, q_full, c * 64, r0, h, b);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int kv0 = grp.ids[t] * kFwdTile;
      mbar_wait(empty + st, ((t / kStages) & 1) ^ 1);  // round 0 passes
      unsigned char* const ks = smem + L::k + st * L::kTileBytes;
      unsigned char* const vs = smem + L::v + st * L::kTileBytes;
      mbar_expect_tx(k_full + st, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(ks + c * kFwdBox, &tk, k_full + st, c * 64, kv0, hk, b);
      mbar_expect_tx(v_full + st, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(vs + c * kFwdBox, &tv, v_full + st, c * 64, kv0, hk, b);
    }
    return;
  }

  // Consumers: warpgroup c owns q rows [64c, 64c + 64) of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row within the warp's 16 (and +8)
  const int tg = lane & 3;   // column pair within an 8-wide tile
  const int row[2] = {r0 + 64 * c + warp * 16 + g,
                      r0 + 64 * c + warp * 16 + g + 8};
  // Each row's keys [klo, khi) under the group's mask, less 2tg.
  int klo[2], khi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_range(grp.code, grp.param, p.Sk, row[r], klo[r], khi[r]);
    klo[r] -= 2 * tg;
    khi[r] += 1 - 2 * tg;
  }
  const float scale_log2 = p.scale * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

  // K-major operands (Q, K): 128-byte rows, 8-row groups 1024 bytes apart
  // (SBO); a 16-wide k step is 32 bytes into the swizzled row, a 64-column
  // box boundary a whole box.
  const uint32_t q_base = smem_u32(smem + L::q) + c * 64 * kRowBytes;
  const uint32_t k_base = smem_u32(smem + L::k);
  const uint32_t v_base = smem_u32(smem + L::v);
  float s[64];      // scores of tile t, then its P in fp32
  uint32_t pa[32];  // P of the tile before, bf16 pairs: PV's A operand
  const uint64_t q_desc = smem_desc(q_base, 16, 1024);
  auto issue_s = [&](int st) {
    // The first k step only writes s: no zeroing, and the old P dies.
    const uint64_t k_desc = smem_desc(k_base + st * L::kTileBytes, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = ((kk / 4) * kFwdBox + (kk % 4) * 32) >> 4;
      if (kk == 0)
        wgmma_ss_n128<false>(s, q_desc + off, k_desc + off);
      else
        wgmma_ss_n128<true>(s, q_desc + off, k_desc + off);
    }
    wgmma_commit();
  };
  // V is MN-major (d contiguous): 8-key groups 1024 bytes apart (SBO),
  // 64-column boxes kFwdBox apart (LBO); a 16-key step is 2048 bytes. P's
  // A fragment of key step kk is the accumulator of n8 tiles 2kk, 2kk + 1.
  auto issue_pv = [&](int st) {
    const uint64_t v_desc =
        smem_desc(v_base + st * L::kTileBytes, kFwdBox, 1024);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdTile / 16; ++kk) {
      const uint64_t dv = v_desc + ((kk * 2048) >> 4);
      if constexpr (D == 128)
        wgmma_rs_n128(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3], dv);
      else
        wgmma_rs_n64(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                     pa[4 * kk + 3], dv);
    }
    wgmma_commit();
  };
  // Turns at the tensor cores (named barriers 1 and 2): a warpgroup issues
  // its products only in its turn and hands the turn over right after, so
  // its softmax runs under the other's products. WG1 starts.
  auto turn_begin = [&] { named_sync(1 + c); };
  auto turn_end = [&](bool last) {
    if (!(last && c == 1)) named_arrive(2 - c);  // none after WG2's last
  };
  auto run_pv = [&](int t) {
    const int st = t % kStages;
    mbar_wait(v_full + st, (t / kStages) & 1);
    issue_pv(st);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + st);  // this stage may be refilled
  };
  auto run_s = [&](int t) {
    const int st = t % kStages;
    mbar_wait(k_full + st, (t / kStages) & 1);
    issue_s(st);
    wgmma_wait<0>();
    fence_regs(s);
  };
  // Mask (where the tile is not full), softmax, rescale O, pack P.
  auto run_softmax = [&](int t) {
    const int kv0 = grp.ids[t] * kFwdTile;
    const int lo[2] = {klo[0] - kv0, klo[1] - kv0};
    const int hi[2] = {khi[0] - kv0, khi[1] - kv0};
    const float scale = mask_range(s, grp.full[t] == 0, lo, hi, scale_log2);
    float corr[2];
    softmax_tile(s, scale, m, l, corr);
    rescale(o, corr);
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };

  // Turn t (t = 0 .. n_tiles) issues O += P(t-1) V(t-1), then S(t), each
  // waited for inside the turn; the softmax of tile t runs under the other
  // warpgroup's turn. At most O and one of S or P are live: 128 registers
  // of accumulators a thread.
  if (n_tiles > 0) {
    if (c == 1) named_arrive(1);  // WG1 takes the first turn
    mbar_wait(q_full, 0);
    turn_begin();
    run_s(0);
    turn_end(false);
    run_softmax(0);
    for (int t = 1; t < n_tiles; ++t) {
      turn_begin();
      run_pv(t - 1);
      run_s(t);
      turn_end(false);
      run_softmax(t);
    }
    turn_begin();
    run_pv(n_tiles - 1);
    turn_end(true);
  }

  // Reduce the partial sums over the quad, normalise, write out and lse.
  __nv_bfloat16* const out =
      static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
  float* const lse = p.lse + b * p.lse_sb + h * p.lse_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (row[i] >= p.Sq) continue;
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    __nv_bfloat16* const orow = out + row[i] * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<__nv_bfloat16>(orow + j * 8 + tg * 2, o[4 * j + 2 * i] * inv,
                            o[4 * j + 2 * i + 1] * inv);
    if (tg == 0)
      lse[row[i]] = li == 0.f ? kNegInf
                              : fmaxf(m[i], kNegInf / 2) * 0.6931471805599453f +
                                    logf(li);
  }
}

// ------------------------------------------------------ bf16 dK / dV

constexpr int kDkvTile = 64;                   // keys, and q rows of a q tile
constexpr int kDkvBox = kDkvTile * kRowBytes;  // a (64 col, 64 row) box
// Per-stage statistics of a q tile: lse and delta (fp32), each in a
// kStatFloats slot. TMA loads a statistic from a 16-byte aligned start:
// the kStatBox entries from its row's element index rounded down to a
// multiple of 4, so the tile's rows begin (index & 3) entries in.
constexpr int kStatBox = kDkvTile + 4;
constexpr int kStatFloats = 128;
constexpr int kStatBytes = kStatFloats * 4;
constexpr int kStatsBytes = 2 * kStatBytes;
// P^T handoff slot: 32 fp32 registers of 128 threads, [register][thread].
constexpr int kSlotFloats = 32 * kWg;

// Shared memory of the dK/dV kernel, as byte offsets from a 1024-byte
// aligned base: K and V (D / 64 boxes each), kStages of Q and dO, kStages
// of statistics, two P^T slots, barriers.
template <int D>
struct DkvSmem {
  static constexpr int kTileBytes = kDkvTile * D * 2;
  static constexpr int k = 0;
  static constexpr int v = k + kTileBytes;
  static constexpr int q = v + kTileBytes;
  static constexpr int dout = q + kStages * kTileBytes;
  static constexpr int stats = dout + kStages * kTileBytes;
  static constexpr int slot = stats + kStages * kStatsBytes;
  static constexpr int bar = slot + 2 * kSlotFloats * 4;  // kv_full,
  static constexpr int total = bar + (1 + 2 * kStages) * 8;  // q_full[], empty[]
};

// Named barriers of the P^T slots: full (WG1 wrote it) and empty (WG2 read
// it), one pair per slot.
__device__ __forceinline__ int slot_full(int slot) { return 1 + slot; }
__device__ __forceinline__ int slot_empty(int slot) { return 3 + slot; }

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_bwd_dkv_wgmma_kernel(const __grid_constant__ Params p,
                                const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tlse,
                                const __grid_constant__ CUtensorMap tdelta) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* const q_full = kv_full + 1;
  uint64_t* const empty = q_full + kStages;

  int hk, ktile;  // heaviest first across all kv heads and groups
  const Group grp = block_group(p, (int)p.Hkv, hk, ktile);
  const int b = blockIdx.y;
  const int group = (int)(p.H / p.Hkv);
  const int Sq = (int)p.Sq;
  const int k0 = ktile * kDkvTile;
  const int n_qt = grp.n;
  const int n_it = group * n_qt;  // q heads of the group x listed q tiles
  // Iteration it: q head hk * group + it / n_qt, q tile ids[it % n_qt].
  auto h_of = [&](int it) { return hk * group + it / n_qt; };
  auto r0_of = [&](int it) { return grp.ids[it % n_qt] * kDkvTile; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(empty + s, 2 * kWg);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  if (wg == 0) {
    // Producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0 || n_it == 0) return;
    mbar_expect_tx(kv_full, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(smem + L::k + c * kDkvBox, &tk, kv_full, c * 64, k0, hk, b);
      tma_load_4d(smem + L::v + c * kDkvBox, &tv, kv_full, c * 64, k0, hk, b);
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int h = h_of(it);
      const int r0 = r0_of(it);
      unsigned char* const stats = smem + L::stats + st * kStatsBytes;
      mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);  // round 0 passes
      mbar_expect_tx(q_full + st, 2 * L::kTileBytes + 2 * kStatBox * 4);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(smem + L::q + st * L::kTileBytes + c * kDkvBox, &tq,
                    q_full + st, c * 64, r0, h, b);
        tma_load_4d(smem + L::dout + st * L::kTileBytes + c * kDkvBox, &tdo,
                    q_full + st, c * 64, r0, h, b);
      }
      // Rows past Sq read the next head's statistics (zeros past the
      // end): their columns are masked.
      const int x = ((int)((b * p.H + h) * p.Sq) + r0) & ~3;
      tma_load_1d(stats, &tlse, q_full + st, x);
      tma_load_1d(stats + kStatBytes, &tdelta, q_full + st, x);
    }
    return;
  }

  // Consumers. Rows of their accumulators are the tile's keys: thread
  // (warp, g) holds keys 16 warp + g and + 8; columns are q rows (of S^T
  // and dP^T) or head dims (of dK, dV).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const uint32_t k_base = smem_u32(smem + L::k);
  const uint32_t v_base = smem_u32(smem + L::v);
  const uint32_t q_base = smem_u32(smem + L::q);
  const uint32_t do_base = smem_u32(smem + L::dout);
  float* const slots = reinterpret_cast<float*>(smem + L::slot);
  float acc[D / 2];  // dV (WG1) or dK (WG2)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32];      // S^T then P^T (WG1); dP^T then dS^T (WG2)
  uint32_t a[16];   // P^T or dS^T in bf16: the A operand of dV or dK
  __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(wg == 1 ? p.dv : p.dk) +
                             b * p.dk_sb + hk * p.dk_sh;
  if (n_it == 0) {
    store_rows(out, p.dk_ss, key, (int)p.Sk, tg, acc);
    return;
  }
  mbar_wait(kv_full, 0);
  // Each warpgroup's loop is software-pipelined: iteration it issues its
  // gradient product of q tile it (dV or dK, the A operand from registers)
  // and the score product of q tile it + 1 (S^T or dP^T) together, and
  // waits for both: accumulator 64 + A 16 + scores 32 = 112 registers in
  // flight. The last iteration is peeled (no products under an if).
  const uint32_t a_base = wg == 1 ? k_base : v_base;   // K or V
  const uint32_t b_base = wg == 1 ? q_base : do_base;  // Q or dO (scores)
  const uint32_t g_base = wg == 1 ? do_base : q_base;  // dO or Q (gradient)
  auto stats_of = [&](int it) {
    return reinterpret_cast<const float*>(smem + L::stats +
                                          (it % kStages) * kStatsBytes);
  };
  // The tile's statistics start `off` entries into their slots.
  auto off_of = [&](int it) {
    return ((int)((b * p.H + h_of(it)) * p.Sq) + r0_of(it)) & 3;
  };
  auto issue_scores = [&](int it) {
    const int st = it % kStages;
    mbar_wait(q_full + st, (it / kStages) & 1);
    ss_product<D>(s, a_base, kDkvBox, b_base + st * L::kTileBytes, kDkvBox);
  };
  auto issue_grad = [&](int it) {
    rs_product<D>(acc, a, g_base + (it % kStages) * L::kTileBytes);
  };
  auto wait_all = [&] {
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(s);
  };
  // Run the pipelined loop with `form` turning the scores of tile it into
  // the A operand of its gradient product.
  auto run = [&](auto form) {
    wgmma_fence();
    issue_scores(0);
    wait_all();
    for (int it = 0; it + 1 < n_it; ++it) {
      form(it);
      wgmma_fence();
      issue_grad(it);
      issue_scores(it + 1);
      wait_all();
      mbar_arrive(empty + it % kStages);
    }
    form(n_it - 1);
    wgmma_fence();
    issue_grad(n_it - 1);
    wait_all();
    mbar_arrive(empty + (n_it - 1) % kStages);
  };
  if (wg == 1) {
    // WG1: S^T = K Q^T, P^T, handed to WG2, then dV += P^T dO. Key r keeps
    // the q rows [qlo, qhi) (none for a key past Sk), less 2tg.
    const float scale_log2 = p.scale * kLog2e;
    int qlo[2], qhi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      query_range(grp.code, grp.param, p.Sq, key[r], qlo[r], qhi[r]);
      if (key[r] >= p.Sk) qhi[r] = -kFar;
      qlo[r] -= 2 * tg;
      qhi[r] += 1 - 2 * tg;
    }
    run([&](int it) {
      const int r0 = r0_of(it);
      const float* const stats = stats_of(it);
      const int lo[2] = {qlo[0] - r0, qlo[1] - r0};
      const int hi[2] = {qhi[0] - r0, qhi[1] - r0};
      const float f =
          mask_range(s, grp.full[it % n_qt] == 0, lo, hi, scale_log2);
      const float* const lse_s = stats + off_of(it) + 2 * tg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float l0 = fmaxf(lse_s[8 * j], kNegInf / 2) * kLog2e;
        const float l1 = fmaxf(lse_s[8 * j + 1], kNegInf / 2) * kLog2e;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], f, (e & 1) ? -l1 : -l0));
      }
      // Hand P^T to WG2: wait until it has read this slot two tiles ago.
      const int slot = it & 1;
      if (it >= 2) named_sync(slot_empty(slot));
      float* const sl = slots + slot * kSlotFloats;
#pragma unroll
      for (int i = 0; i < 32; ++i) sl[i * kWg + tid] = s[i];
      named_arrive(slot_full(slot));
      pack_a(a, s);
    });
  } else {
    // WG2: dP^T = V dO^T, takes P^T, dS^T, then dK += dS^T Q.
    run([&](int it) {
      const int slot = it & 1;
      named_sync(slot_full(slot));
      const float* const sl = slots + slot * kSlotFloats;
      const float* const delta_s =
          stats_of(it) + kStatFloats + off_of(it) + 2 * tg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dd[2] = {delta_s[8 * j], delta_s[8 * j + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          s[i] = sl[i * kWg + tid] * (s[i] - dd[e & 1]) * p.scale;
        }
      }
      // Nobody writes this slot again after the last two tiles.
      if (it + 2 < n_it) named_arrive(slot_empty(slot));
      pack_a(a, s);
    });
  }
  store_rows(out, p.dk_ss, key, (int)p.Sk, tg, acc);
}

// ---------------------------------------------------------- bf16 dQ

constexpr int kDqRows = 128;                   // q rows of a q tile
constexpr int kDqKeys = 64;                    // keys of a streamed kv tile
constexpr int kDqBoxQ = kDqRows * kRowBytes;   // a (64 col, 128 row) box
constexpr int kDqBoxKv = kDqKeys * kRowBytes;  // a (64 col, 64 row) box

// Shared memory of the dQ kernel, as byte offsets from a 1024-byte aligned
// base: Q and dO (D / 64 boxes of 128 rows each), kStages of K and of V
// (D / 64 boxes of 64 rows), barriers.
template <int D>
struct DqSmem {
  static constexpr int kQBytes = kDqRows * D * 2;
  static constexpr int kKvBytes = kDqKeys * D * 2;
  static constexpr int q = 0;
  static constexpr int dout = q + kQBytes;
  static constexpr int k = dout + kQBytes;
  static constexpr int v = k + kStages * kKvBytes;
  static constexpr int bar = v + kStages * kKvBytes;  // qd_full, kv_full[],
  static constexpr int total = bar + (1 + 2 * kStages) * 8;  // empty[]
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    splash_bwd_dq_wgmma_kernel(const __grid_constant__ Params p,
                               const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const qd_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* const kv_full = qd_full + 1;
  uint64_t* const empty = kv_full + kStages;

  int h, qtile;  // heaviest first across all heads and groups
  const Group grp = block_group(p, (int)p.H, h, qtile);
  const int b = blockIdx.y;
  const int r0 = qtile * kDqRows;
  const int n_tiles = grp.n;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(empty + s, 2 * kWg);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Warp-uniform as far as the compiler can tell (a shuffle from lane 0),
  // so each branch's setmaxnreg governs the registers of all its code.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWg, 0);
  if (wg == 0) {
    // Producer: one thread issues every load, the kv tiles from the list.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0 || n_tiles == 0) return;
    const int hk = h / (int)(p.H / p.Hkv);
    mbar_expect_tx(qd_full, 2 * L::kQBytes);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_4d(smem + L::q + c * kDqBoxQ, &tq, qd_full, c * 64, r0, h, b);
      tma_load_4d(smem + L::dout + c * kDqBoxQ, &tdo, qd_full, c * 64, r0, h,
                  b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int kv0 = grp.ids[t] * kDqKeys;
      mbar_wait(empty + st, ((t / kStages) & 1) ^ 1);  // round 0 passes
      mbar_expect_tx(kv_full + st, 2 * L::kKvBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(smem + L::k + st * L::kKvBytes + c * kDqBoxKv, &tk,
                    kv_full + st, c * 64, kv0, hk, b);
        tma_load_4d(smem + L::v + st * L::kKvBytes + c * kDqBoxKv, &tv,
                    kv_full + st, c * 64, kv0, hk, b);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns q rows [64c, 64c + 64) of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - wg * kWg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the warp's 16 (and +8)
  const int tg = lane & 3;  // column pair within an 8-wide tile
  const int row[2] = {r0 + 64 * c + warp * 16 + g,
                      r0 + 64 * c + warp * 16 + g + 8};
  // Each row's keys [klo, khi) under the group's mask, less 2tg, and its
  // lse (log2 units, floored at -5e29) and delta; rows past Sq are never
  // stored.
  int klo[2], khi[2];
  float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  const long long bh = b * p.lse_sb + h * p.lse_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_range(grp.code, grp.param, p.Sk, row[r], klo[r], khi[r]);
    klo[r] -= 2 * tg;
    khi[r] += 1 - 2 * tg;
    if (row[r] >= p.Sq) continue;
    lse2[r] = fmaxf(p.lse[bh + row[r]], kNegInf / 2) * kLog2e;
    dd[r] = p.delta[bh + row[r]];
  }
  const float scale_log2 = p.scale * kLog2e;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];  // S and dP of tile t; S becomes P, then dS
  uint32_t da[16];      // dS of tile t, bf16: dQ's A operand
  const uint32_t q_base = smem_u32(smem + L::q) + c * 64 * kRowBytes;
  const uint32_t do_base = smem_u32(smem + L::dout) + c * 64 * kRowBytes;
  const uint32_t k_base = smem_u32(smem + L::k);
  const uint32_t v_base = smem_u32(smem + L::v);

  auto wait_all = [&] {
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(s);
    fence_regs(dp);
  };
  // S(t) = Q K(t)^T, once tile t has landed.
  auto issue_s = [&](int t) {
    const int st = t % kStages;
    mbar_wait(kv_full + st, (t / kStages) & 1);
    ss_product<D>(s, q_base, kDqBoxQ, k_base + st * L::kKvBytes, kDqBoxKv);
  };
  // dP(t) = dO V(t)^T.
  auto issue_dp = [&](int t) {
    ss_product<D>(dp, do_base, kDqBoxQ, v_base + (t % kStages) * L::kKvBytes,
                  kDqBoxKv);
  };
  // dQ += dS(t) K(t).
  auto issue_dq = [&](int t) {
    rs_product<D>(dq, da, k_base + (t % kStages) * L::kKvBytes);
  };
  // P(t) in s from the scores, masked where the tile is not full.
  auto form_p = [&](int t) {
    const int kv0 = grp.ids[t] * kDqKeys;
    const int lo[2] = {klo[0] - kv0, klo[1] - kv0};
    const int hi[2] = {khi[0] - kv0, khi[1] - kv0};
    const float f = mask_range(s, grp.full[t] == 0, lo, hi, scale_log2);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = fast_exp2(fmaf(s[i], f, -lse2[(i >> 1) & 1]));
  };
  // dS(t) = P (dP - delta) scale, rounded to bf16 into da.
  auto form_ds = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = s[i] * (dp[i] - dd[r]) * p.scale;
    }
    pack_a(da, s);
  };

  // Per listed kv tile: S(t) and dP(t) issued together and waited for, P
  // and dS in registers, then dQ += dS(t) K(t), waited for before the
  // stage is released.
  if (n_tiles > 0) mbar_wait(qd_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    wgmma_fence();
    issue_s(t);
    issue_dp(t);
    wait_all();
    form_p(t);
    form_ds();
    wgmma_fence();
    issue_dq(t);
    wait_all();
    mbar_arrive(empty + t % kStages);  // this stage may be refilled
  }
  store_rows(static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh,
             p.dq_ss, row, (int)p.Sq, tg, dq);
}

// ---------------------------------------------------------------- host

// Launches of each kernel behind the three entries since the library was
// loaded, counted where the launch succeeds (rtt_splash_launches reads
// them): which kernel a call took, as observed rather than as assumed.
enum {
  kFwdWgmma = 0,
  kFwdF32 = 1,
  kDkvWgmma = 2,
  kDkvF32 = 3,
  kDqWgmma = 4,
  kDqF32 = 5,
  kKernels = 6
};
std::atomic<long long> g_launches[kKernels];

int counted_launch(int kernel) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_launches[kernel].fetch_add(1);
  return (int)e;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One block per entry of the call schedule's order, batch in y.
dim3 call_grid(const Params& p) {
  return dim3((unsigned)p.n_blocks, (unsigned)p.B);
}

template <int D>
int launch_fwd_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = encode_4d(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                    kFwdTile);
  if (!e)
    e = encode_4d(&tk, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb,
                  kFwdTile);
  if (!e)
    e = encode_4d(&tv, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb,
                  kFwdTile);
  if (e) return e;
  constexpr int smem = FwdSmem<D>::total + 1024;  // + alignment slack
  static const cudaError_t attr = set_smem(splash_fwd_wgmma_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  splash_fwd_wgmma_kernel<D><<<call_grid(p), kThreads, smem, stream>>>(
      p, tq, tk, tv);
  return counted_launch(kFwdWgmma);
}

template <int D>
int launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta;
  const long long n = p.B * p.H * p.Sq;
  int e = encode_4d(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                    kDkvTile);
  if (!e)
    e = encode_4d(&tdo, p.dout, D, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb,
                  kDkvTile);
  if (!e)
    e = encode_4d(&tk, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb,
                  kDkvTile);
  if (!e)
    e = encode_4d(&tv, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb,
                  kDkvTile);
  if (!e) e = encode_1d(&tlse, p.lse, n, kStatBox);
  if (!e) e = encode_1d(&tdelta, p.delta, n, kStatBox);
  if (e) return e;
  constexpr int smem = DkvSmem<D>::total + 1024;  // + alignment slack
  static const cudaError_t attr =
      set_smem(splash_bwd_dkv_wgmma_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  splash_bwd_dkv_wgmma_kernel<D><<<call_grid(p), kThreads, smem, stream>>>(
      p, tq, tdo, tk, tv, tlse, tdelta);
  return counted_launch(kDkvWgmma);
}

template <int D>
int launch_fwd_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<true, D>();
  static const cudaError_t attr = set_smem(splash_fwd_f32_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  splash_fwd_f32_kernel<D><<<call_grid(p), kMmaThreads, smem, stream>>>(p);
  return counted_launch(kFwdF32);
}

template <int D>
int launch_dkv_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<true, D>();
  static const cudaError_t attr =
      set_smem(splash_bwd_dkv_f32_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  splash_bwd_dkv_f32_kernel<D><<<call_grid(p), kMmaThreads, smem, stream>>>(
      p);
  return counted_launch(kDkvF32);
}

template <int D>
int launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int e = encode_4d(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                    kDqRows);
  if (!e)
    e = encode_4d(&tdo, p.dout, D, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb,
                  kDqRows);
  if (!e)
    e = encode_4d(&tk, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb,
                  kDqKeys);
  if (!e)
    e = encode_4d(&tv, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb,
                  kDqKeys);
  if (e) return e;
  constexpr int smem = DqSmem<D>::total + 1024;  // + alignment slack
  static const cudaError_t attr =
      set_smem(splash_bwd_dq_wgmma_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  splash_bwd_dq_wgmma_kernel<D><<<call_grid(p), kThreads, smem, stream>>>(
      p, tq, tdo, tk, tv);
  return counted_launch(kDqWgmma);
}

template <int D>
int launch_dq_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t attr = set_smem(splash_bwd_dq_f32_kernel<D>, smem);
  if (attr != cudaSuccess) return (int)attr;
  splash_bwd_dq_f32_kernel<D><<<call_grid(p), kMmaThreads, smem, stream>>>(p);
  return counted_launch(kDqF32);
}

// ptrs: q, k, v, out, lse, do, delta, dq, dk, dv, sched (null where
//       unused).
// ints: dtype (0 bf16, 1 f32), B, H, Hkv, Sq, Sk, D,
//       q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
//       o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
//       dk_sb, dk_ss, dk_sh (dv has dk's strides), lse_sb, lse_sh (delta
//       has lse's strides), n_blocks.
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
  p.sched = static_cast<const int*>(ptrs[10]);
  p.B = ints[1];
  p.H = ints[2];
  p.Hkv = ints[3];
  p.Sq = ints[4];
  p.Sk = ints[5];
  long long* const rest[24] = {
      &p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,
      &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.o_sb,  &p.o_ss,  &p.o_sh,
      &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss, &p.dq_sh,
      &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.lse_sb, &p.lse_sh, &p.n_blocks};
  for (int i = 0; i < 24; ++i) *rest[i] = ints[7 + i];
  p.scale = scale;
  return p;
}

}  // namespace

// The three entries take the same arguments (see `parse`) and launch once
// over all head groups from the call schedule (`sched`, `n_blocks`; a null
// schedule is refused). Each returns the cudaError_t of the launch (0 on
// success), or kEncodeError (10000) + the CUresult of a tensor map that
// could not be made.
extern "C" int rtt_splash_fwd(void* const* ptrs, const long long* ints,
                              float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (p.sched == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 128) return launch_fwd_wgmma<128>(p, st);
  if (dtype == 0 && D == 64) return launch_fwd_wgmma<64>(p, st);
  if (dtype == 1 && D == 128) return launch_fwd_f32<128>(p, st);
  if (dtype == 1 && D == 64) return launch_fwd_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtt_splash_bwd_dkv(void* const* ptrs, const long long* ints,
                                  float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (p.sched == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 128) return launch_dkv_wgmma<128>(p, st);
  if (dtype == 0 && D == 64) return launch_dkv_wgmma<64>(p, st);
  if (dtype == 1 && D == 128) return launch_dkv_f32<128>(p, st);
  if (dtype == 1 && D == 64) return launch_dkv_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtt_splash_bwd_dq(void* const* ptrs, const long long* ints,
                                 float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (p.sched == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 128) return launch_dq_wgmma<128>(p, st);
  if (dtype == 0 && D == 64) return launch_dq_wgmma<64>(p, st);
  if (dtype == 1 && D == 128) return launch_dq_f32<128>(p, st);
  if (dtype == 1 && D == 64) return launch_dq_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The launches the three entries have made of each kernel since the
// library was loaded: out[0] forward wgmma, out[1] forward mma.sync f32,
// out[2] dK/dV wgmma, out[3] dK/dV mma.sync f32, out[4] dQ wgmma, out[5]
// dQ mma.sync f32.
extern "C" void rtt_splash_launches(long long* out) {
  for (int i = 0; i < kKernels; ++i) out[i] = g_launches[i].load();
}
