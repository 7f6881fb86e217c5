// Flash attention backward for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces: ray_tpu/ops/flash_attention.py::_bwd_dkv_kernel (:223,
// pl.pallas_call at :382) and ::_bwd_dq_kernel (:281, pl.pallas_call at
// :430), launched by _bwd. Same function, flash-attention-2 style: P is
// recomputed from the forward's lse, P = exp(s - max(lse, -5e29)) in fp32;
// dV += P^T dO with P rounded to dO's dtype; dP = dO V^T in fp32 plus the
// optional lse cotangent; dS = P (dP - delta) scale, rounded to q's dtype
// before dK += dS^T Q and to k's dtype before dQ += dS K; fp32
// accumulators; causal, sliding-window and q_offset masks with dead tiles
// skipped; segment-id equality; GQA, the group sum of dK / dV taken in fp32
// inside the kernel; ragged Sq / Sk masked here; rows that nothing reaches
// (lse -1e30) get exactly zero gradient. Every output element is written by
// one block, with no atomics: the result is deterministic. delta =
// rowsum(dO * O) comes from a plain PyTorch pre-pass, as in the JAX package.
//
// Each entry holds two kernels, chosen by the dtype code and nothing else:
//   * bfloat16 (every main-path call): flash_bwd_dkv_wgmma_kernel and
//     flash_bwd_dq_wgmma_kernel, below;
//   * float32 (no main path): flash_bwd_dkv_f32_kernel and
//     flash_bwd_dq_f32_kernel, mma.sync m16n8k16 on bf16 hi + lo operand
//     pairs (three products per mma keep fp32 accuracy), 4 warps.
// The entries count their launches of each (rtt_flash_bwd_launches).
//
// What bounds the bf16 kernels on an H100: the tensor cores. At the 1B
// train shape (B=4, S=2048, 16 q heads on 8 kv heads, D=128, causal) dK/dV
// does four products over the live (q, k) pairs, 1.38e11 FLOP against
// ~0.1 GB (0.139 ms at 989 TFLOP/s, 0.03 ms at 3.35 TB/s), and dQ three,
// 1.03e11 FLOP (0.104 ms). What the design does about it:
//   * Every product runs on wgmma (bf16 in, fp32 accumulate), the only
//     Hopper instruction that reaches the full tensor-core rate. Products
//     of two tiles read both from shared memory by descriptors (K-major);
//     the products that consume P or dS take it as the register A operand
//     and read their B tile (dO, Q or K, in its natural (row, d) layout)
//     through the B-transpose bit.
//   * 384 threads in three warpgroups. WG0 is the producer: it gives its
//     registers away (setmaxnreg.dec 40) and one thread issues TMA loads
//     (4-D tensor maps over (D, S, H, B) from the caller's strides, 64-col
//     boxes, 128-byte swizzle; TMA zero-fills rows past the ends) into a
//     three-stage ring guarded by full / empty mbarriers. WG1 and WG2
//     (setmaxnreg.inc 232) consume. ptxas judges a wgmma's registers
//     against the kernel's entry budget (168 a thread at 384 threads), not
//     the 232 after setmaxnreg, and serializes every wgmma once more than
//     ~128 accumulator registers are in flight; each layout stays under it.
//   * dQ: one block per (128-row q tile, q head, batch); Q and dO loaded
//     once, 64-key K / V tiles streamed. Each consumer owns 64 rows (lse
//     and delta in registers) and per tile computes S = Q K^T and
//     dP = dO V^T (m64n64k16, issued together), P and dS in registers, then
//     dQ += dS K (m64n{D}k16): dQ 64 + S 32 + dP 32 = 128 registers in
//     flight. The two consumers run unsynchronized: the forward's turns at
//     the tensor cores, and pipelining dQ(t) with S(t+1), each measured
//     slower here.
//   * dK/dV: one block per (64-key tile, kv head, batch), K and V loaded
//     once; the producer streams the group's query heads x live 64-row q
//     tiles (Q, dO and the tile's lse, delta and lse cotangent by 1-D
//     tensor maps). One warpgroup holding
//     dK and dV (128) plus S^T and dP^T (64) would be 192 registers in
//     flight, so the work is split by product: WG1 computes S^T = K Q^T
//     and P^T (lse varies along the columns), hands P^T (fp32, so dS keeps
//     the unrounded P) to WG2 through a double-buffered 16 KB slot laid
//     out [register][thread] (conflict-free; thread t of WG2 holds the
//     same fragment positions as thread t of WG1), then does dV += P^T dO;
//     WG2 computes dP^T = V dO^T, takes P^T, forms dS^T and does dK +=
//     dS^T Q. Named barriers guard the slots. Each warpgroup issues its
//     gradient product of q tile i together with its score product of
//     tile i + 1: 112 registers in flight, two products each per q tile.
//   * Both grids put the tile index in z and start blocks heaviest first
//     across all heads and batches (under the causal mask: the last q
//     tiles for dQ, the first key tiles for dK/dV), so no heavy block
//     starts in the last wave.
//   * Masks run only on tiles that straddle the causal or window frontier,
//     a ragged edge or (with segment ids) always, as a key range per row
//     (a q range per key in dK/dV). Segment ids and the lse cotangent are
//     template flags: the main path's instantiation has no code for them.
//
// Layout: q/dO (B, Sq, H, D), k/v (B, Sk, Hkv, D) or any layout reachable by
// (batch, seq, head) strides with the head dim contiguous and 16-byte
// aligned rows; lse, delta and the lse cotangent (B, H, Sq) fp32 contiguous
// and 16-byte aligned; dq (B, Sq, H, D) and dk/dv (B, Sk, Hkv, D) written
// in the input dtype. D is 64 or 128 (the Python wrapper zero-pads smaller
// head dims).

// The Hopper helpers (mbarriers, TMA, wgmma, tensor maps) are shared with
// the other kernel sources in hopper.cuh.
#include "hopper.cuh"

#include <atomic>

namespace {

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

// ------------------------------------------------ bf16: wgmma, TMA, WS

constexpr int kThreads = 3 * kWg;
constexpr int kTile = 64;  // keys of a kv tile, q rows of a dK/dV q tile
constexpr int kDqRows = 128;  // q rows of a dQ block (64 per consumer)
constexpr int kStages = 3;    // ring depth of the streamed tiles
constexpr int kRowBytes = 128;  // one 64-column bf16 box row (the swizzle)
constexpr int kBox64 = kTile * kRowBytes;     // a (64 col, 64 row) box
constexpr int kBox128 = kDqRows * kRowBytes;  // a (64 col, 128 row) box
// Registers a thread after setmaxnreg: 128 * 40 + 256 * 232 = 64,512 of
// the SM's 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Where `masked`, set the scores of a 64 x 64 tile (the accumulator layout:
// s[4j + e] is row half e >> 1, column 8j + 2tg + (e & 1)) that the masks
// drop to -1e30 and the rest to log2 units. Row half r keeps the columns
// [lo[r], hi[r]) + 2tg (bounds on the column's compile-time part, so a test
// is two compares with a constant), and, with segment ids, those whose id
// seg_col[column] equals seg_row[r]. Returns the factor still to apply to
// s: scale_log2 for a tile left as it is, 1 for a masked one.
template <bool kSeg>
__device__ __forceinline__ float mask_tile(float (&s)[32], bool masked,
                                           const int (&lo)[2],
                                           const int (&hi)[2], int tg,
                                           const int (&seg_row)[2],
                                           const int* seg_col,
                                           float scale_log2) {
  if (!masked) return scale_log2;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int cc = (i >> 2) * 8 + (i & 1);  // column less 2tg
    const int r = (i >> 1) & 1;
    bool keep = cc >= lo[r] && cc < hi[r];
    if constexpr (kSeg) keep = keep && seg_row[r] == seg_col[cc + 2 * tg];
    s[i] = keep ? s[i] * scale_log2 : kNegInf;
  }
  return 1.f;
}

constexpr int kFar = 1 << 30;  // an unbounded side of a key or q range

// ------------------------------------------------------ bf16 dQ kernel

// Shared memory of the dQ kernel, as byte offsets from a 1024-byte aligned
// base: Q and dO (128 rows: D / 64 boxes of kBox128), kStages of K and V
// (64 rows: D / 64 boxes of kBox64), kStages of kv segment ids, barriers.
template <int D>
struct DqSmem {
  static constexpr int kQBytes = kDqRows * D * 2;
  static constexpr int kKvBytes = kTile * D * 2;
  static constexpr int q = 0;
  static constexpr int dout = q + kQBytes;
  static constexpr int k = dout + kQBytes;
  static constexpr int v = k + kStages * kKvBytes;
  static constexpr int seg = v + kStages * kKvBytes;      // int[kStages][64]
  static constexpr int bar = seg + kStages * kTile * 4;  // qd_full, kv_full[],
  static constexpr int total = bar + (1 + 2 * kStages) * 8;  // empty[]
};

// The live kv range of the q rows [r0, r0 + rows) (block-uniform): the
// causal frontier ends it, the window starts it (floored to whole tiles).
// Returns the number of kTile-key tiles from *kv_begin.
__device__ __forceinline__ int live_kv_tiles(const Params& p, int r0, int rows,
                                             int* kv_begin) {
  const int pos_lo = (int)p.q_offset + r0;
  const int pos_hi = (int)p.q_offset + min(r0 + rows, (int)p.Sq) - 1;
  int end = (int)p.Sk;
  if (p.causal) end = min(end, pos_hi + 1);
  int begin = 0;
  if (p.has_window) begin = max(0, pos_lo - (int)p.window + 1);
  begin = (begin / kTile) * kTile;
  *kv_begin = begin;
  return end > begin ? (end - begin + kTile - 1) / kTile : 0;
}

template <int D, bool kSeg, bool kDlse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Params p,
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
  int* const seg_smem = reinterpret_cast<int*>(smem + L::seg);

  // Blocks start in order of x, then y, then z: every (head, batch) takes
  // its heaviest (last) q tile before any takes a lighter one.
  const int qtile = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = qtile * kDqRows;
  int kv_begin;
  const int n_tiles = live_kv_tiles(p, r0, kDqRows, &kv_begin);

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
    // Producer: warp 0 stages kv segment ids, its lane 0 issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = threadIdx.x;
    if (lane >= 32 || n_tiles == 0) return;
    const int hk = h / (int)(p.H / p.Hkv);
    if (lane == 0) {
      mbar_expect_tx(qd_full, 2 * L::kQBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(smem + L::q + c * kBox128, &tq, qd_full, c * 64, r0, h, b);
        tma_load_4d(smem + L::dout + c * kBox128, &tdo, qd_full, c * 64, r0, h,
                    b);
      }
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int kv0 = kv_begin + t * kTile;
      mbar_wait(empty + st, ((t / kStages) & 1) ^ 1);  // round 0 passes
      if constexpr (kSeg) {
        for (int i = lane; i < kTile; i += 32)
          seg_smem[st * kTile + i] =
              kv0 + i < p.Sk ? p.seg_k[b * p.segk_sb + kv0 + i] : 0;
        __syncwarp();  // the stores precede lane 0's arrive (release)
      }
      if (lane == 0) {
        mbar_expect_tx(kv_full + st, 2 * L::kKvBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem + L::k + st * L::kKvBytes + c * kBox64, &tk,
                      kv_full + st, c * 64, kv0, hk, b);
          tma_load_4d(smem + L::v + st * L::kKvBytes + c * kBox64, &tv,
                      kv_full + st, c * 64, kv0, hk, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows [64c, 64c + 64) of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // row within the warp's 16 (and +8)
    const int tg = lane & 3;  // column pair within an 8-wide tile
    const int wr0 = r0 + 64 * c;
    const int row[2] = {wr0 + warp * 16 + g, wr0 + warp * 16 + g + 8};
    const int Sq = (int)p.Sq;
    float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    int seg_row[2] = {0, 0};
    const long long bh = (b * p.H + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= Sq) continue;
      lse2[i] = fmaxf(p.lse[bh + row[i]], kNegInf / 2) * kLog2e;
      dd[i] = p.delta[bh + row[i]];
      if constexpr (kDlse) dd[i] -= p.dlse[bh + row[i]];
      if constexpr (kSeg) seg_row[i] = p.seg_q[b * p.segq_sb + row[i]];
    }
    const float scale_log2 = p.scale * kLog2e;
    const int pos_lo = (int)p.q_offset + wr0;
    const int pos_hi = (int)p.q_offset + min(wr0 + 64, Sq) - 1;

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
      ss_product<D>(s, q_base, kBox128, k_base + st * L::kKvBytes, kBox64);
    };
    // dP(t) = dO V(t)^T.
    auto issue_dp = [&](int t) {
      ss_product<D>(dp, do_base, kBox128,
                    v_base + (t % kStages) * L::kKvBytes, kBox64);
    };
    // dQ += dS(t) K(t).
    auto issue_dq = [&](int t) {
      rs_product<D>(dq, da, k_base + (t % kStages) * L::kKvBytes);
    };
    // P(t) in s from the scores, masked on frontier tiles.
    auto form_p = [&](int t) {
      const int kv0 = kv_begin + t * kTile;
      const bool masked =
          kSeg || kv0 + kTile > (int)p.Sk ||
          (p.causal && kv0 + kTile - 1 > pos_lo) ||
          (p.has_window && pos_hi - kv0 >= (int)p.window);
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = (int)p.q_offset + row[r];
        int end = (int)p.Sk;
        if (p.causal) end = min(end, pos + 1);
        const int begin = p.has_window ? pos - (int)p.window + 1 : 0;
        lo[r] = begin - kv0 - 2 * tg;
        hi[r] = end - kv0 - 2 * tg;
      }
      const float f = mask_tile<kSeg>(s, masked, lo, hi, tg, seg_row,
                                      seg_smem + (t % kStages) * kTile,
                                      scale_log2);
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

    // Per live kv tile: S(t) and dP(t) issued together and waited for (dQ
    // 64 + S 32 + dP 32 = 128 registers in flight), P and dS in registers,
    // then dQ += dS(t) K(t), waited for before the stage is released.
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
               p.dq_ss, row, Sq, tg, dq);
  }
}

// --------------------------------------------------- bf16 dK/dV kernel

// Per-stage statistics of a q tile: lse, delta and the lse cotangent
// (fp32), and the rows' segment ids (int32), each in a kStatFloats slot.
// TMA loads a statistic from a 16-byte aligned start: the kStatBox entries
// from its row's element index rounded down to a multiple of 4, so the
// tile's rows begin `off` = (index & 3) entries into the slot.
constexpr int kStatBox = kTile + 4;
constexpr int kStatFloats = 128;
constexpr int kStatBytes = kStatFloats * 4;
constexpr int kStatsBytes = 4 * kStatBytes;
// P^T handoff slot: 32 fp32 registers of 128 threads, [register][thread].
constexpr int kSlotFloats = 32 * kWg;

// Shared memory of the dK/dV kernel, as byte offsets from a 1024-byte
// aligned base: K and V (64 rows: D / 64 boxes of kBox64), kStages of Q
// and dO, kStages of statistics, two P^T slots, barriers.
template <int D>
struct DkvSmem {
  static constexpr int kTileBytes = kTile * D * 2;
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

template <int D, bool kSeg, bool kDlse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ Params p,
                               const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tlse,
                               const __grid_constant__ CUtensorMap tdelta,
                               const __grid_constant__ CUtensorMap tdlse) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* const q_full = kv_full + 1;
  uint64_t* const empty = q_full + kStages;

  // Blocks start in order of x, then y, then z: every (kv head, batch)
  // takes its first key tile (the heaviest under the causal mask) before
  // any takes a later one.
  const int ktile = blockIdx.z;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int group = (int)(p.H / p.Hkv);
  const int Sq = (int)p.Sq;
  const int q_offset = (int)p.q_offset;
  const int k0 = ktile * kTile;

  // Live q tiles of this key tile (block-uniform), as `_tile_live`: the
  // causal frontier starts the range, the window ends it.
  const int nq = (Sq + kTile - 1) / kTile;
  int qt_begin = 0, qt_end = nq;
  if (p.causal) {
    const int num = k0 - q_offset - (kTile - 1);
    if (num > 0) qt_begin = (num + kTile - 1) / kTile;
  }
  if (p.has_window) {
    const int x = k0 + kTile - 1 + (int)p.window - q_offset;
    qt_end = x <= 0 ? 0 : min(nq, (x + kTile - 1) / kTile);
  }
  const int n_qt = max(0, qt_end - qt_begin);
  const int n_it = group * n_qt;  // q heads of the group x live q tiles

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
    // Producer: warp 0 stages the rows' segment ids, its lane 0 issues
    // every load. Iteration it is q head hk * group + it / n_qt, q tile
    // qt_begin + it % n_qt.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = threadIdx.x;
    if (lane >= 32 || n_it == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::kTileBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(smem + L::k + c * kBox64, &tk, kv_full, c * 64, k0, hk, b);
        tma_load_4d(smem + L::v + c * kBox64, &tv, kv_full, c * 64, k0, hk, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int h = hk * group + it / n_qt;
      const int r0 = (qt_begin + it % n_qt) * kTile;
      unsigned char* const stats = smem + L::stats + st * kStatsBytes;
      mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);  // round 0 passes
      if constexpr (kSeg) {
        int* const seg = reinterpret_cast<int*>(stats + 3 * kStatBytes);
        for (int i = lane; i < kTile; i += 32)
          seg[i] = r0 + i < Sq ? p.seg_q[b * p.segq_sb + r0 + i] : 0;
        __syncwarp();  // the stores precede lane 0's arrive (release)
      }
      if (lane == 0) {
        mbar_expect_tx(q_full + st, 2 * L::kTileBytes +
                                        (kDlse ? 3 : 2) * kStatBox * 4);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(smem + L::q + st * L::kTileBytes + c * kBox64, &tq,
                      q_full + st, c * 64, r0, h, b);
          tma_load_4d(smem + L::dout + st * L::kTileBytes + c * kBox64, &tdo,
                      q_full + st, c * 64, r0, h, b);
        }
        // Rows past Sq read the next head's statistics (zeros past the
        // end): their columns are masked.
        const int x = ((int)((b * p.H + h) * p.Sq) + r0) & ~3;
        tma_load_1d(stats, &tlse, q_full + st, x);
        tma_load_1d(stats + kStatBytes, &tdelta, q_full + st, x);
        if constexpr (kDlse)
          tma_load_1d(stats + 2 * kStatBytes, &tdlse, q_full + st, x);
      }
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
  auto h_of = [&](int it) { return hk * group + it / n_qt; };
  uint32_t a[16];   // P^T or dS^T in bf16: the A operand of dV or dK
  if (n_it == 0) {
    store_rows(static_cast<__nv_bfloat16*>(wg == 1 ? p.dv : p.dk) +
                   b * p.dk_sb + hk * p.dk_sh,
               p.dk_ss, key, (int)p.Sk, tg, acc);
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
  auto r0_of = [&](int it) { return (qt_begin + it % n_qt) * kTile; };
  // The tile's statistics start `off` entries into their slots.
  auto off_of = [&](int it) {
    return ((int)((b * p.H + h_of(it)) * p.Sq) + r0_of(it)) & 3;
  };
  auto issue_scores = [&](int it) {
    const int st = it % kStages;
    mbar_wait(q_full + st, (it / kStages) & 1);
    ss_product<D>(s, a_base, kBox64, b_base + st * L::kTileBytes, kBox64);
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
  // Iteration it: scores of tile it are in s; form P^T (WG1) or dS^T
  // (WG2) into `a`, then run the products.
  if (wg == 1) {
    // WG1: S^T = K Q^T, P^T, handed to WG2, then dV += P^T dO.
    const float scale_log2 = p.scale * kLog2e;
    int seg_key[2] = {0, 0};
    if constexpr (kSeg) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (key[i] < p.Sk) seg_key[i] = p.seg_k[b * p.segk_sb + key[i]];
    }
    auto form_p = [&](int it) {
      const int r0 = r0_of(it);
      const float* const stats = stats_of(it);
      const int pos_lo = q_offset + r0;
      const int pos_hi = q_offset + min(r0 + kTile, Sq) - 1;
      const bool masked = kSeg || k0 + kTile > (int)p.Sk || r0 + kTile > Sq ||
                          (p.causal && k0 + kTile - 1 > pos_lo) ||
                          (p.has_window && pos_hi - k0 >= (int)p.window);
      // Key r keeps the q columns [lo, hi): from its causal frontier to its
      // window's end and Sq; none for a key past Sk.
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = p.causal ? key[r] - pos_lo : -kFar;
        int e = Sq - r0;
        if (p.has_window) e = min(e, key[r] + (int)p.window - pos_lo);
        if (key[r] >= p.Sk) e = -kFar;
        lo[r] = l - 2 * tg;
        hi[r] = e - 2 * tg;
      }
      const float f = mask_tile<kSeg>(
          s, masked, lo, hi, tg, seg_key,
          reinterpret_cast<const int*>(stats + 3 * kStatFloats), scale_log2);
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
    };
    wgmma_fence();
    issue_scores(0);
    wait_all();
    for (int it = 0; it + 1 < n_it; ++it) {
      form_p(it);
      wgmma_fence();
      issue_grad(it);
      issue_scores(it + 1);
      wait_all();
      mbar_arrive(empty + it % kStages);
    }
    form_p(n_it - 1);
    wgmma_fence();
    issue_grad(n_it - 1);
    wait_all();
    mbar_arrive(empty + (n_it - 1) % kStages);
    store_rows(static_cast<__nv_bfloat16*>(p.dv) + b * p.dk_sb + hk * p.dk_sh,
               p.dk_ss, key, (int)p.Sk, tg, acc);
  } else {
    // WG2: dP^T = V dO^T, takes P^T, dS^T, then dK += dS^T Q.
    auto form_ds = [&](int it) {
      const float* const stats = stats_of(it);
      const int slot = it & 1;
      named_sync(slot_full(slot));
      const float* const sl = slots + slot * kSlotFloats;
      const float* const delta_s = stats + kStatFloats + off_of(it) + 2 * tg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float dd[2] = {delta_s[8 * j], delta_s[8 * j + 1]};
        if constexpr (kDlse) {
          dd[0] -= delta_s[kStatFloats + 8 * j];
          dd[1] -= delta_s[kStatFloats + 8 * j + 1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          s[i] = sl[i * kWg + tid] * (s[i] - dd[e & 1]) * p.scale;
        }
      }
      // Nobody writes this slot again after the last two tiles.
      if (it + 2 < n_it) named_arrive(slot_empty(slot));
      pack_a(a, s);
    };
    wgmma_fence();
    issue_scores(0);
    wait_all();
    for (int it = 0; it + 1 < n_it; ++it) {
      form_ds(it);
      wgmma_fence();
      issue_grad(it);
      issue_scores(it + 1);
      wait_all();
      mbar_arrive(empty + it % kStages);
    }
    form_ds(n_it - 1);
    wgmma_fence();
    issue_grad(n_it - 1);
    wait_all();
    mbar_arrive(empty + (n_it - 1) % kStages);
    store_rows(static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh,
               p.dk_ss, key, (int)p.Sk, tg, acc);
  }
}

// ------------------------------------- float32: mma.sync on hi/lo pairs

constexpr int kF32Rows = 64;      // query rows of a q tile
constexpr int kF32Keys = 64;      // keys of a kv tile
constexpr int kF32Threads = 128;  // 4 warps of 16 rows (dQ) or keys (dK/dV)
constexpr int kF32Ld = 8;         // row padding (elements) for ldmatrix

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

// Stage rows [row0, row0 + 64) of one head of a float32 (seq, D) operand
// into shared memory as bf16 bits (hi) and the bf16 residual (lo), through
// registers. Rows past `valid` are zero. Rows are padded by 16 bytes, which
// keeps ldmatrix free of bank conflicts.
template <int D>
__device__ __forceinline__ void load_tile_f32(const float* base,
                                              long long row_stride, int row0,
                                              int valid, uint16_t* hi,
                                              uint16_t* lo) {
  constexpr int kLd = D + kF32Ld;
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < 64 * kPerRow; idx += kF32Threads) {
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
// both by plain ldmatrix, with the hi*lo and lo*hi terms.
template <int NT, int KS, int kLd>
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
    uint32_t ah[4], al[4];
    ldsm_x4(ah, a_hi + aoff);
    ldsm_x4(al, a_lo + aoff);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      const int boff = (n0 + nt * 8 + (mi >> 1) * 8 + mr) * kLd + ks * 16 +
                       (mi & 1) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4(bh, b_hi + boff);
      ldsm_x4(bl, b_lo + boff);
      mma16816(acc[nt], al, bh[0], bh[1]);
      mma16816(acc[nt], ah, bl[0], bl[1]);
      mma16816(acc[nt + 1], al, bh[2], bh[3]);
      mma16816(acc[nt + 1], ah, bl[2], bl[3]);
      mma16816(acc[nt], ah, bh[0], bh[1]);
      mma16816(acc[nt + 1], ah, bh[2], bh[3]);
    }
  }
}

// acc(16 x D) += A(16 x 16*KK) * B(16*KK x D): A given as C fragments
// `c` of KK*2 n8 tiles (split here into bf16 hi + lo), B read from rows
// [k0, k0 + 16*KK) of `b_hi` (row-major k x D) by transposed ldmatrix.
template <int KK, int D, int kLd>
__device__ __forceinline__ void mma_c_kd(float (&acc)[D / 8][4],
                                         float (&c)[2 * KK][4],
                                         const uint16_t* b_hi,
                                         const uint16_t* b_lo, int k0) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const float* c0 = c[2 * kk];
    const float* c1 = c[2 * kk + 1];
    const uint32_t ah[4] = {pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
                            pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])};
    const uint32_t al[4] = {
        pack_bf16(bf16_residual(c0[0]), bf16_residual(c0[1])),
        pack_bf16(bf16_residual(c0[2]), bf16_residual(c0[3])),
        pack_bf16(bf16_residual(c1[0]), bf16_residual(c1[1])),
        pack_bf16(bf16_residual(c1[2]), bf16_residual(c1[3]))};
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      const int off = (k0 + kk * 16 + (mi & 1) * 8 + mr) * kLd +
                      (dt + (mi >> 1)) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4_trans(bh, b_hi + off);
      ldsm_x4_trans(bl, b_lo + off);
      mma16816(acc[dt], al, bh[0], bh[1]);
      mma16816(acc[dt], ah, bl[0], bl[1]);
      mma16816(acc[dt + 1], al, bh[2], bh[3]);
      mma16816(acc[dt + 1], ah, bl[2], bl[3]);
      mma16816(acc[dt], ah, bh[0], bh[1]);
      mma16816(acc[dt + 1], ah, bh[2], bh[3]);
    }
  }
}

// Elements of a (64 x D) tile of bf16 hi or lo parts, rows padded.
template <int D>
struct F32Tile {
  static constexpr int kElems = 64 * (D + kF32Ld);
};

// dK/dV kernel shared memory: K and V (hi, lo), two stages of Q and dO
// (hi, lo), two stages of per-row lse (log2 units), delta - dlse and
// segment id.
template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return 4 * 3 * F32Tile<D>::kElems * sizeof(uint16_t) +
         2 * 3 * kF32Rows * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int kLd = D + kF32Ld;
  constexpr int kKS = D / 16;
  constexpr int kDT = D / 8;
  constexpr int kTileEl = F32Tile<D>::kElems;
  constexpr int kStage = 4 * kTileEl;  // [Q hi, dO hi, Q lo, dO lo]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const sK = reinterpret_cast<uint16_t*>(smem_raw);  // hi, lo
  uint16_t* const sV = sK + 2 * kTileEl;                         // hi, lo
  uint16_t* const sQD = sV + 2 * kTileEl;  // two stages of [Q, dO] (hi, lo)
  float* const s_lse = reinterpret_cast<float*>(sQD + 2 * kStage);
  float* const s_dd = s_lse + 2 * kF32Rows;
  int* const s_seg = reinterpret_cast<int*>(s_dd + 2 * kF32Rows);

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
  const int k0 = ktile * kF32Keys;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile_f32<D>(K, p.k_ss, k0, min(kF32Keys, Sk - k0), sK, sK + kTileEl);
  load_tile_f32<D>(V, p.v_ss, k0, min(kF32Keys, Sk - k0), sV, sV + kTileEl);
  int seg_key[2] = {0, 0};
  if (p.seg_k != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (key[i] < Sk) seg_key[i] = p.seg_k[b * p.segk_sb + key[i]];
  }

  // Live q tiles of this key tile (block-uniform), as `_tile_live`.
  const int nq = (Sq + kF32Rows - 1) / kF32Rows;
  int qt_begin = 0, qt_end = nq;
  if (p.causal) {
    const int num = k0 - q_offset - (kF32Rows - 1);
    if (num > 0) qt_begin = (num + kF32Rows - 1) / kF32Rows;
  }
  if (p.has_window) {
    const int x = k0 + kF32Keys - 1 + (int)p.window - q_offset;
    qt_end = x <= 0 ? 0 : min(nq, (x + kF32Rows - 1) / kF32Rows);
  }
  const int n_qt = max(0, qt_end - qt_begin);
  const int n_it = group * n_qt;

  // Fetch iteration it (query head it / n_qt of the group, q tile
  // qt_begin + it % n_qt) into stage st.
  auto fetch = [&](int it, int st) {
    const int h = hk * group + it / n_qt;
    const int r0 = (qt_begin + it % n_qt) * kF32Rows;
    const int valid = min(kF32Rows, Sq - r0);
    const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* DO =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    uint16_t* base = sQD + st * kStage;
    load_tile_f32<D>(Q, p.q_ss, r0, valid, base, base + 2 * kTileEl);
    load_tile_f32<D>(DO, p.do_ss, r0, valid, base + kTileEl,
                     base + 3 * kTileEl);
    const long long bh = (b * p.H + h) * p.Sq;
    for (int i = threadIdx.x; i < kF32Rows; i += kF32Threads) {
      float l2 = 0.f, dd = 0.f;
      int sg = 0;
      if (i < valid) {
        l2 = fmaxf(p.lse[bh + r0 + i], kNegInf / 2) * kLog2e;
        dd = p.delta[bh + r0 + i];
        if (p.dlse != nullptr) dd -= p.dlse[bh + r0 + i];
        if (p.seg_q != nullptr) sg = p.seg_q[b * p.segq_sb + r0 + i];
      }
      s_lse[st * kF32Rows + i] = l2;
      s_dd[st * kF32Rows + i] = dd;
      s_seg[st * kF32Rows + i] = sg;
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
    // The other stage was released by the last barrier.
    if (it + 1 < n_it) fetch(it + 1, st ^ 1);
    __syncthreads();
    const int r0 = (qt_begin + it % n_qt) * kF32Rows;
    const uint16_t* Qh = sQD + st * kStage;
    const uint16_t* DOh = Qh + kTileEl;
    const uint16_t* Ql = Qh + 2 * kTileEl;
    const uint16_t* DOl = Qh + 3 * kTileEl;
    const float* lse_s = s_lse + st * kF32Rows;
    const float* dd_s = s_dd + st * kF32Rows;
    const int* seg_s = s_seg + st * kF32Rows;
    const int pos_lo = q_offset + r0;
    const int pos_hi = q_offset + min(r0 + kF32Rows, Sq) - 1;
    const bool need_mask =
        p.seg_k != nullptr || k0 + kF32Keys > Sk || r0 + kF32Rows > Sq ||
        (p.causal && k0 + kF32Keys - 1 > pos_lo) ||
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
      mma_rows_nk<4, kKS, kLd>(s, sK, sK + kTileEl, Qh, Ql, warp * 16,
                               half * 32);
      mma_rows_nk<4, kKS, kLd>(dp, sV, sV + kTileEl, DOh, DOl, warp * 16,
                               half * 32);
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
      mma_c_kd<2, D, kLd>(dv, s, DOh, DOl, half * 32);
      mma_c_kd<2, D, kLd>(dk, dp, Qh, Ql, half * 32);
    }
    __syncthreads();  // stage st may be refilled by the next fetch
  }

  float* DK = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  float* DV = static_cast<float*>(p.dv) + b * p.dk_sb + hk * p.dk_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const long long off = key[i] * p.dk_ss + dt * 8 + tg * 2;
      store2<float>(DK + off, dk[dt][2 * i], dk[dt][2 * i + 1]);
      store2<float>(DV + off, dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// dQ kernel shared memory: Q and dO (hi, lo), two stages of K and V
// (hi, lo), two stages of kv segment ids.
template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return 4 * 3 * F32Tile<D>::kElems * sizeof(uint16_t) +
         2 * kF32Keys * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int kLd = D + kF32Ld;
  constexpr int kKS = D / 16;
  constexpr int kNT = kF32Keys / 8;
  constexpr int kDT = D / 8;
  constexpr int kTileEl = F32Tile<D>::kElems;
  constexpr int kStage = 4 * kTileEl;  // [K hi, V hi, K lo, V lo]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const sQ = reinterpret_cast<uint16_t*>(smem_raw);  // hi, lo
  uint16_t* const sDO = sQ + 2 * kTileEl;                        // hi, lo
  uint16_t* const sKV = sDO + 2 * kTileEl;  // two stages of [K, V] (hi, lo)
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
  const int r0 = qtile * kF32Rows;
  const int row[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* DO =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile_f32<D>(Q, p.q_ss, r0, min(kF32Rows, Sq - r0), sQ, sQ + kTileEl);
  load_tile_f32<D>(DO, p.do_ss, r0, min(kF32Rows, Sq - r0), sDO,
                   sDO + kTileEl);

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
  const int pos_hi = (int)p.q_offset + min(r0 + kF32Rows, Sq) - 1;
  int kv_end = Sk;
  if (p.causal) kv_end = min(kv_end, pos_hi + 1);
  int kv_begin = 0;
  if (p.has_window) kv_begin = max(0, pos_lo - (int)p.window + 1);
  kv_begin = (kv_begin / kF32Keys) * kF32Keys;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kF32Keys - 1) / kF32Keys : 0;
  auto fetch = [&](int t, int st) {
    const int kv0 = kv_begin + t * kF32Keys;
    const int valid = min(kF32Keys, Sk - kv0);
    uint16_t* base = sKV + st * kStage;
    load_tile_f32<D>(K, p.k_ss, kv0, valid, base, base + 2 * kTileEl);
    load_tile_f32<D>(V, p.v_ss, kv0, valid, base + kTileEl,
                     base + 3 * kTileEl);
    if (p.seg_k != nullptr) {
      for (int i = threadIdx.x; i < kF32Keys; i += kF32Threads)
        seg_smem[st * kF32Keys + i] =
            i < valid ? p.seg_k[b * p.segk_sb + kv0 + i] : 0;
    }
  };

  if (n_tiles > 0) fetch(0, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int kv0 = kv_begin + t * kF32Keys;
    if (t + 1 < n_tiles) fetch(t + 1, st ^ 1);
    __syncthreads();
    const uint16_t* Kh = sKV + st * kStage;
    const uint16_t* Vh = Kh + kTileEl;
    const uint16_t* Kl = Kh + 2 * kTileEl;
    const uint16_t* Vl = Kh + 3 * kTileEl;
    const int* seg_s = seg_smem + st * kF32Keys;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
    mma_rows_nk<kNT, kKS, kLd>(s, sQ, sQ + kTileEl, Kh, Kl, warp * 16, 0);
    mma_rows_nk<kNT, kKS, kLd>(dp, sDO, sDO + kTileEl, Vh, Vl, warp * 16, 0);
    const bool need_mask =
        p.seg_k != nullptr || kv0 + kF32Keys > Sk || r0 + kF32Rows > Sq ||
        (p.causal && kv0 + kF32Keys - 1 > pos_lo) ||
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
    mma_c_kd<kF32Keys / 16, D, kLd>(dq, s, Kh, Kl, 0);
    __syncthreads();  // stage st may be refilled by the next fetch
  }

  float* out = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    float* orow = out + row[i] * p.dq_ss;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      store2<float>(orow + dt * 8 + tg * 2, dq[dt][2 * i], dq[dt][2 * i + 1]);
  }
}

// ------------------------------------------------------------------ host

// Launches of each kernel behind the two entries since the library was
// loaded, counted where the launch succeeds (rtt_flash_bwd_launches reads
// them): which kernel a call took, as observed rather than as assumed.
enum {
  kDkvWgmma = 0,
  kDqWgmma = 1,
  kDkvF32 = 2,
  kDqF32 = 3,
  kKernels = 4
};
std::atomic<long long> g_launches[kKernels];

int counted_launch(int kernel) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_launches[kernel].fetch_add(1);
  return (int)e;
}

// The maps of q, dO, k and v with `q_rows`-row boxes for q and dO.
int encode_qkv(const Params& p, long long D, int q_rows, CUtensorMap* tq,
               CUtensorMap* tdo, CUtensorMap* tk, CUtensorMap* tv) {
  int e = encode_4d(tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                    q_rows);
  if (!e)
    e = encode_4d(tdo, p.dout, D, p.Sq, p.H, p.B, p.do_ss, p.do_sh, p.do_sb,
                  q_rows);
  if (!e)
    e = encode_4d(tk, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb, kTile);
  if (!e)
    e = encode_4d(tv, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb, kTile);
  return e;
}

template <int D, bool kSeg, bool kDlse>
int launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta, tdlse;
  const long long n = p.B * p.H * p.Sq;
  int e = encode_qkv(p, D, kTile, &tq, &tdo, &tk, &tv);
  if (!e) e = encode_1d(&tlse, p.lse, n, kStatBox);
  if (!e) e = encode_1d(&tdelta, p.delta, n, kStatBox);
  if (!e) e = encode_1d(&tdlse, kDlse ? p.dlse : p.lse, n, kStatBox);
  if (e) return e;
  constexpr int smem = DkvSmem<D>::total + 1024;  // + alignment slack
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D, kSeg, kDlse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)p.Hkv, (unsigned)p.B,
                  (unsigned)((p.Sk + kTile - 1) / kTile));
  flash_bwd_dkv_wgmma_kernel<D, kSeg, kDlse><<<grid, kThreads, smem, stream>>>(
      p, tq, tdo, tk, tv, tlse, tdelta, tdlse);
  return counted_launch(kDkvWgmma);
}

template <int D, bool kSeg, bool kDlse>
int launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  const int e = encode_qkv(p, D, kDqRows, &tq, &tdo, &tk, &tv);
  if (e) return e;
  constexpr int smem = DqSmem<D>::total + 1024;  // + alignment slack
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D, kSeg, kDlse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)p.H, (unsigned)p.B,
                  (unsigned)((p.Sq + kDqRows - 1) / kDqRows));
  flash_bwd_dq_wgmma_kernel<D, kSeg, kDlse><<<grid, kThreads, smem, stream>>>(
      p, tq, tdo, tk, tv);
  return counted_launch(kDqWgmma);
}

// The bf16 instantiation for the call's segment ids and lse cotangent.
template <int D, template <int, bool, bool> class Launch>
int launch_bf16(const Params& p, cudaStream_t stream) {
  const bool seg = p.seg_q != nullptr, dlse = p.dlse != nullptr;
  if (seg && dlse) return Launch<D, true, true>::run(p, stream);
  if (seg) return Launch<D, true, false>::run(p, stream);
  if (dlse) return Launch<D, false, true>::run(p, stream);
  return Launch<D, false, false>::run(p, stream);
}

template <int D, bool kSeg, bool kDlse>
struct DkvWgmma {
  static int run(const Params& p, cudaStream_t s) {
    return launch_dkv_wgmma<D, kSeg, kDlse>(p, s);
  }
};

template <int D, bool kSeg, bool kDlse>
struct DqWgmma {
  static int run(const Params& p, cudaStream_t s) {
    return launch_dq_wgmma<D, kSeg, kDlse>(p, s);
  }
};

template <int D>
int launch_dkv_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = dkv_f32_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((p.Sk + kF32Keys - 1) / kF32Keys),
                  (unsigned)p.Hkv, (unsigned)p.B);
  flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(p);
  return counted_launch(kDkvF32);
}

template <int D>
int launch_dq_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = dq_f32_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((p.Sq + kF32Rows - 1) / kF32Rows),
                  (unsigned)p.H, (unsigned)p.B);
  flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(p);
  return counted_launch(kDqF32);
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

// Both entries take the same arguments. dtype 0 (bf16) launches the wgmma
// kernel, dtype 1 (float32) the mma.sync hi/lo kernel. Each returns the
// cudaError_t of the launch (0 on success), or kEncodeError (10000) + the
// CUresult of a tensor map that could not be made.
extern "C" int rtt_flash_bwd_dkv(void* const* ptrs, const long long* ints,
                                 float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (dtype == 0 && D == 128) return launch_bf16<128, DkvWgmma>(p, st);
  if (dtype == 0 && D == 64) return launch_bf16<64, DkvWgmma>(p, st);
  if (dtype == 1 && D == 128) return launch_dkv_f32<128>(p, st);
  if (dtype == 1 && D == 64) return launch_dkv_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtt_flash_bwd_dq(void* const* ptrs, const long long* ints,
                                float scale, void* stream) {
  const Params p = parse(ptrs, ints, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long dtype = ints[0], D = ints[6];
  if (dtype == 0 && D == 128) return launch_bf16<128, DqWgmma>(p, st);
  if (dtype == 0 && D == 64) return launch_bf16<64, DqWgmma>(p, st);
  if (dtype == 1 && D == 128) return launch_dq_f32<128>(p, st);
  if (dtype == 1 && D == 64) return launch_dq_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The launches the two entries have made of each kernel since the library
// was loaded: out[0] dK/dV wgmma, out[1] dQ wgmma, out[2] dK/dV mma.sync
// f32, out[3] dQ mma.sync f32.
extern "C" void rtt_flash_bwd_launches(long long* out) {
  for (int i = 0; i < kKernels; ++i) out[i] = g_launches[i].load();
}
