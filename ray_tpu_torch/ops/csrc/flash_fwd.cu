// Flash attention forward for Hopper (sm_90a), bound to Python via ctypes.
//
// Replaces: ray_tpu/ops/flash_attention.py::_fwd_kernel (:109; launched by
// _fwd, pl.pallas_call at :195). Same function: online-softmax attention
// with fp32 running max, sum and accumulator; causal, sliding-window and
// q_offset masks with dead kv tiles never loaded; segment-id equality; GQA
// through kv head h / group; out in the input dtype and lse (B, H, Sq) in
// fp32, with out 0 and lse -1e30 for a row that nothing live reaches.
//
// Two kernels behind one entry, chosen by the dtype code and nothing else:
//   * bfloat16 (every main-path call): flash_fwd_wgmma_kernel, below.
//   * float32 (no main path; the fp32 debug model and the edge cases):
//     flash_fwd_f32_kernel, mma.sync m16n8k16 on bf16 hi + lo operand
//     pairs (x = hi + lo to ~2^-16 relative; hi*hi + hi*lo + lo*hi per
//     product keeps fp32 accuracy), 64 x 64 tiles, 4 warps.
// The entry counts its launches of each (rtt_flash_fwd_launches), so a
// caller can check which kernel ran.
//
// What bounds the bf16 kernel on an H100: the tensor cores. At the 7B
// prefill shape (B=4, S=2048, H=32, D=128, causal) the two products are
// 1.37e11 FLOP against 269 MB of q, k, v, out and lse (0.139 ms at 989
// TFLOP/s, 0.080 ms at 3.35 TB/s); at the 1B train shape (B=4, S=2048,
// 16 q heads on 8 kv heads, D=128, causal) 6.9e10 FLOP against 101 MB
// (0.070 ms, 0.030 ms). What the design does about it:
//   * Both products run on wgmma (m64n128k16, bf16 in, fp32 accumulate),
//     the only Hopper instruction that reaches the full tensor-core rate.
//     S = Q K^T reads Q and K from shared memory through descriptors; P
//     is rounded to bf16 in registers (as the TPU kernel's
//     p.astype(v.dtype)) and feeds O += P V as the register A operand,
//     with V read from shared memory in its natural (key, d) layout by
//     the B-transpose bit. S and P never leave registers.
//   * One block per (128-row q tile, q head, batch), heaviest q tiles
//     first, 384 threads in three warpgroups. WG0 is the producer: it
//     gives its registers away (setmaxnreg.dec 40) and one thread issues
//     TMA loads, Q once and then the K and V tiles (128 keys) of the live
//     kv range into a three-stage ring guarded by full / empty mbarriers;
//     its warp stages the tile's kv segment ids beside them. WG1 and WG2
//     (setmaxnreg.inc 232) own 64 query rows each and consume every tile.
//   * The consumers take turns at the tensor cores (named barriers): a
//     turn issues O += P(t-1) V(t-1) and then S(t), each waited for in
//     the turn, and the warpgroup's softmax of tile t runs under the
//     other's turn. At most O and one of S or P (128 accumulator
//     registers) are live at a product: ptxas judges a product's
//     registers against the kernel's 168 a thread, not the 232 after
//     setmaxnreg, and serializes every wgmma (with spills) once S, P
//     and O are in flight together.
//   * TMA tensor maps are 4-D over (D, S, H, B) from the caller's strides
//     (so strided views pass), with a (64, 128, 1, 1) box and 128-byte
//     swizzle; a D=128 tile is two boxes. The wgmma descriptors use the
//     same swizzle. TMA zero-fills rows past Sq and keys past Sk; the
//     scores still mask col >= Sk.
//   * The softmax runs in log2 units: one FMA and one ex2.approx per
//     score. The masks run only on frontier tiles, as a key range per row.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D) or any layout reachable by
// (batch, seq, head) strides with the head dim contiguous and 16-byte
// aligned rows; D is 64 or 128 (the Python wrapper zero-pads smaller head
// dims). Rows past Sq and keys past Sk are masked here, so no length
// needs to divide a tile.

// The Hopper helpers (mbarriers, TMA, wgmma, tensor maps) are shared with
// the other kernel sources in hopper.cuh.
#include "hopper.cuh"

#include <atomic>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg_q;  // (B, Sq) int32 or null
  const int* seg_k;  // (B, Sk) int32 or null
  void* out;
  float* lse;        // (B, H, Sq) contiguous
  long long B, H, Hkv, Sq, Sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, segq_sb, segk_sb;
  long long causal, has_window, window, q_offset;
  float scale;
};

// The live kv range of the q rows [r0, r0 + rows) (block-uniform): the
// causal frontier ends it, the window starts it (floored to whole tiles).
// Returns the number of kv tiles of `tile` keys from *kv_begin.
__device__ __forceinline__ int live_tiles(const Params& p, int r0, int rows,
                                          int tile, int* kv_begin) {
  const int pos_lo = (int)p.q_offset + r0;
  const int pos_hi = (int)p.q_offset + min(r0 + rows, (int)p.Sq) - 1;
  int end = (int)p.Sk;
  if (p.causal) end = min(end, pos_hi + 1);
  int begin = 0;
  if (p.has_window) begin = max(0, pos_lo - (int)p.window + 1);
  begin = (begin / tile) * tile;
  *kv_begin = begin;
  return end > begin ? (end - begin + tile - 1) / tile : 0;
}

// Whether a kv tile [kv0, kv0 + tile) needs the per-element masks for
// query positions [pos_lo, pos_hi], as `_mask_scores` is needed only on
// partial tiles: a tile wholly below the causal frontier and inside the
// window, with no ragged edge and no segment ids, skips them.
__device__ __forceinline__ bool need_mask(const Params& p, int kv0, int tile,
                                          int pos_lo, int pos_hi) {
  return p.seg_k != nullptr || kv0 + tile > (int)p.Sk ||
         (p.causal && kv0 + tile - 1 > pos_lo) ||
         (p.has_window && pos_hi - kv0 >= (int)p.window);
}

// Where `masked`, scale a tile of scores (the accumulator layout below:
// s[4j + e] is row half e >> 1, column 8j + 2tg + (e & 1) of the tile at
// key kv0) into log2 units and set the scores the masks drop to -1e30 (the
// TPU kernel's convention). Returns the factor still to apply: scale_log2
// for a tile left as it is (no mask reaches it), 1 for a masked one. Each
// row's live keys are a range, turned into bounds on the column's
// compile-time part, so a test is two compares with a constant (and a
// segment-id compare where there are segments).
template <int NS>
__device__ __forceinline__ float mask_scores(float (&s)[NS], const Params& p,
                                             bool masked, int kv0,
                                             const int (&row)[2], int tg,
                                             const int (&seg_row)[2],
                                             const int* seg_s,
                                             float scale_log2) {
  if (!masked) return scale_log2;
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
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int cc = (i >> 2) * 8 + (i & 1);  // column less 2tg
    const int r = (i >> 1) & 1;
    bool keep = cc >= lo[r] && cc < hi[r];
    if (p.seg_k != nullptr) keep = keep && seg_row[r] == seg_s[cc + 2 * tg];
    s[i] = keep ? s[i] * scale_log2 : kNegInf;
  }
  return 1.f;
}

// Reduce the partial sums over the quad, normalise, and write one
// thread's two rows of out (pairs of columns) and their lse.
template <typename T, int NO>
__device__ __forceinline__ void write_rows(const Params& p, int b, int h,
                                           const int (&row)[2], int tg,
                                           const float (&o)[NO],
                                           const float (&m)[2],
                                           const float (&l)[2]) {
  T* out = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (row[i] >= p.Sq) continue;
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    T* orow = out + row[i] * p.o_ss;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      store2<T>(orow + j * 8 + tg * 2, o[4 * j + 2 * i] * inv,
                o[4 * j + 2 * i + 1] * inv);
    if (tg == 0)
      p.lse[(b * p.H + h) * p.Sq + row[i]] =
          li == 0.f ? kNegInf
                    : fmaxf(m[i], kNegInf / 2) * 0.6931471805599453f +
                          logf(li);
  }
}

// ------------------------------------------------ bf16: wgmma, TMA, WS

constexpr int kTile = 128;      // q rows per block and keys per kv tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kThreads = 3 * kWg;
constexpr int kBoxBytes = kTile * 128;  // one (64 col, 128 row) TMA box
// Registers a thread after setmaxnreg: 128 * 40 + 256 * 232 = 64,512 of
// the SM's 65,536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Shared memory, as byte offsets from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes).
template <int D>
struct Smem {
  static constexpr int kTileBytes = kTile * D * 2;  // D / 64 boxes
  static constexpr int q = 0;
  static constexpr int k = q + kTileBytes;
  static constexpr int v = k + kStages * kTileBytes;
  static constexpr int seg = v + kStages * kTileBytes;    // int[kStages][kTile]
  static constexpr int bar = seg + kStages * kTile * 4;   // q_full, k_full[],
  static constexpr int total = bar + (1 + 3 * kStages) * 8;  // v_full[], empty[]
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + kStages;
  uint64_t* const empty = v_full + kStages;
  int* const seg_smem = reinterpret_cast<int*>(smem + L::seg);

  const int qtile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = qtile * kTile;
  int kv_begin;
  const int n_tiles = live_tiles(p, r0, kTile, kTile, &kv_begin);

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
    // Producer: warp 0 stages segment ids, its lane 0 issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = threadIdx.x;
    if (lane >= 32 || n_tiles == 0) return;
    const int hk = h / (int)(p.H / p.Hkv);
    if (lane == 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(smem + L::q + c * kBoxBytes, &tq, q_full, c * 64, r0, h, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int kv0 = kv_begin + t * kTile;
      mbar_wait(empty + st, ((t / kStages) & 1) ^ 1);  // round 0 passes
      if (p.seg_k != nullptr) {
        for (int i = lane; i < kTile; i += 32)
          seg_smem[st * kTile + i] =
              kv0 + i < p.Sk ? p.seg_k[b * p.segk_sb + kv0 + i] : 0;
        __syncwarp();  // the stores precede lane 0's arrive (release)
      }
      if (lane == 0) {
        unsigned char* const ks = smem + L::k + st * L::kTileBytes;
        unsigned char* const vs = smem + L::v + st * L::kTileBytes;
        mbar_expect_tx(k_full + st, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(ks + c * kBoxBytes, &tk, k_full + st, c * 64, kv0, hk, b);
        mbar_expect_tx(v_full + st, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vs + c * kBoxBytes, &tv, v_full + st, c * 64, kv0, hk, b);
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows [64c, 64c + 64) of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;   // row within the warp's 16 (and +8)
    const int tg = lane & 3;   // column pair within an 8-wide tile
    const int wr0 = r0 + 64 * c;
    const int row[2] = {wr0 + warp * 16 + g, wr0 + warp * 16 + g + 8};
    const int Sq = (int)p.Sq;
    int seg_row[2] = {0, 0};
    if (p.seg_q != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row[i] < Sq) seg_row[i] = p.seg_q[b * p.segq_sb + row[i]];
    }
    const float scale_log2 = p.scale * 1.4426950408889634f;
    const int pos_lo = (int)p.q_offset + wr0;
    const int pos_hi = (int)p.q_offset + min(wr0 + 64, Sq) - 1;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

    // K-major operands (Q, K): 128-byte rows, 8-row groups 1024 bytes
    // apart (SBO); a 16-wide k step is 32 bytes into the swizzled row, a
    // 64-column box boundary a whole box.
    const uint32_t q_base = smem_u32(smem + L::q) + c * 64 * 128;
    const uint32_t k_base = smem_u32(smem + L::k);
    const uint32_t v_base = smem_u32(smem + L::v);
    float s[64];     // scores of tile t, then its P in fp32
    uint32_t pa[32]; // P of the tile before, bf16 pairs: PV's A operand
    const uint64_t q_desc = smem_desc(q_base, 16, 1024);
    auto issue_s = [&](int st) {
      // The first k step only writes s: no zeroing, and the old P dies.
      const uint64_t k_desc =
          smem_desc(k_base + st * L::kTileBytes, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * kBoxBytes + (kk % 4) * 32) >> 4;
        if (kk == 0)
          wgmma_ss_n128<false>(s, q_desc + off, k_desc + off);
        else
          wgmma_ss_n128<true>(s, q_desc + off, k_desc + off);
      }
      wgmma_commit();
    };
    // V is MN-major (d contiguous): 8-key groups 1024 bytes apart (SBO),
    // 64-column boxes kBoxBytes apart (LBO); a 16-key step is 2048 bytes.
    // P's A fragment of key step kk is the accumulator of n8 tiles 2kk and
    // 2kk + 1.
    auto issue_pv = [&](int st) {
      const uint64_t v_desc =
          smem_desc(v_base + st * L::kTileBytes, kBoxBytes, 1024);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
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
    // Scale, mask and softmax the scores of tile t in place.
    auto softmax = [&](int t, float (&corr)[2]) {
      const int kv0 = kv_begin + t * kTile;
      const float scale = mask_scores(
          s, p, need_mask(p, kv0, kTile, pos_lo, pos_hi), kv0, row, tg,
          seg_row, seg_smem + (t % kStages) * kTile, scale_log2);
      softmax_tile(s, scale, m, l, corr);
    };
    auto pack_p = [&] {
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };
    // Turns at the tensor cores (named barriers 1 and 2): a warpgroup
    // issues its products only in its turn and hands the turn over right
    // after, so its softmax runs under the other's products. WG1 starts.
    auto turn_begin = [&] {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(2 * kWg));
    };
    auto turn_end = [&](bool last) {
      if (!(last && c == 1))  // nobody takes a turn after WG2's last
        asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(2 * kWg));
    };

    // Turn t (t = 0 .. n_tiles) issues O += P(t-1) V(t-1), then S(t) =
    // Q K(t)^T, each waited for inside the turn so the two products run
    // back to back; the softmax of tile t then runs under the other
    // warpgroup's turn. O is rescaled after P(t-1) V(t-1) has landed in
    // it. At most O and one of S or P are live: 128 registers of
    // accumulators a thread.
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
    auto run_softmax = [&](int t) {
      float corr[2];
      softmax(t, corr);
      rescale(o, corr);
      pack_p();
    };
    if (n_tiles > 0) {
      if (c == 1)  // WG1 takes the first turn
        asm volatile("bar.arrive 1, %0;\n" ::"n"(2 * kWg));
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
    write_rows<__nv_bfloat16>(p, b, h, row, tg, o, m, l);
  }
}

// ------------------------------------- float32: mma.sync on hi/lo pairs

constexpr int kF32Rows = 64;     // query rows per block (16 per warp)
constexpr int kF32Keys = 64;     // keys per kv tile
constexpr int kF32Threads = 128; // 4 warps

// Residual of the bf16 rounding of x: x - float(bf16(x)).
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col).
__device__ __forceinline__ void mma16816(float* c, const uint32_t (&a)[4],
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

// Stage rows [row0, row0 + kF32Keys) of one head of K or V into shared
// memory as bf16 bits (hi) and the bf16 residual (lo); rows past `valid`
// are zero. Rows are padded by 16 bytes, which keeps ldmatrix free of
// bank conflicts.
template <int D>
__device__ __forceinline__ void load_tile_f32(const float* base,
                                              long long row_stride, int row0,
                                              int valid, uint16_t* hi,
                                              uint16_t* lo) {
  constexpr int kLd = D + 8;
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kF32Keys * kPerRow; idx += kF32Threads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      f = *reinterpret_cast<const float4*>(base + (row0 + r) * row_stride + c);
    uint2 hv, lv;
    hv.x = pack_bf16(f.x, f.y);
    hv.y = pack_bf16(f.z, f.w);
    lv.x = pack_bf16(bf16_residual(f.x), bf16_residual(f.y));
    lv.y = pack_bf16(bf16_residual(f.z), bf16_residual(f.w));
    *reinterpret_cast<uint2*>(hi + r * kLd + c) = hv;
    *reinterpret_cast<uint2*>(lo + r * kLd + c) = lv;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int kLd = D + 8;         // padded smem row (elements)
  constexpr int kKS = D / 16;        // k-steps of QK^T
  constexpr int kNT = kF32Keys / 8;  // n8 tiles of S
  // Two stages of [K hi, V hi, K lo, V lo] tiles, then two stages of kv
  // segment ids.
  constexpr int kTileEl = kF32Keys * kLd;
  constexpr int kStage = 4 * kTileEl;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* const smem = reinterpret_cast<uint16_t*>(smem_raw);
  int* const seg_smem = reinterpret_cast<int*>(smem + 2 * kStage);

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
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Q A-fragments, loaded once: reg0 (row g, cols 2tg..), reg1 (row g+8),
  // reg2 (row g, cols 8+2tg..), reg3 (row g+8, cols 8+2tg..).
  uint32_t qh[kKS][4];
  uint32_t ql[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row[r & 1];
      const int col = ks * 16 + tg * 2 + (r >> 1) * 8;
      float2 x = make_float2(0.f, 0.f);
      if (rr < Sq) x = *reinterpret_cast<const float2*>(Q + rr * p.q_ss + col);
      qh[ks][r] = pack_bf16(x.x, x.y);
      ql[ks][r] = pack_bf16(bf16_residual(x.x), bf16_residual(x.y));
    }
  }
  int seg_row[2] = {0, 0};
  if (p.seg_q != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Sq) seg_row[i] = p.seg_q[b * p.segq_sb + row[i]];
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const float scale_log2 = p.scale * 1.4426950408889634f;
  const int pos_lo = (int)p.q_offset + r0;
  const int pos_hi = (int)p.q_offset + min(r0 + kF32Rows, Sq) - 1;
  int kv_begin;
  const int n_tiles = live_tiles(p, r0, kF32Rows, kF32Keys, &kv_begin);
  // Fetch kv tile t into stage st: K and V hi and lo halves, plus the
  // tile's segment ids (synchronous loads through registers).
  auto fetch = [&](int t, int st) {
    const int kv0 = kv_begin + t * kF32Keys;
    const int valid = min(kF32Keys, Sk - kv0);
    uint16_t* base = smem + st * kStage;
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
    const uint16_t* Kh = smem + st * kStage;
    const uint16_t* Vh = Kh + kTileEl;
    const uint16_t* Kl = Kh + 2 * kTileEl;
    const uint16_t* Vl = Kh + 3 * kTileEl;
    const int* seg_s = seg_smem + st * kF32Keys;

    // S = Q K^T: one ldmatrix.x4 brings the B fragments of two n8 key
    // tiles: matrices (keys nt*8.., d lo), (nt*8.., d hi), ((nt+1)*8..,
    // d lo), ((nt+1)*8.., d hi).
    float s[4 * kNT];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = 0.f;
    const int mi = lane >> 3;  // matrix this lane addresses
    const int mr = lane & 7;   // row of that matrix
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        const int off = (nt * 8 + (mi >> 1) * 8 + mr) * kLd + ks * 16 +
                        (mi & 1) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Kh + off);
        ldsm_x4(bl, Kl + off);
        float* const s0 = s + 4 * nt;
        float* const s1 = s0 + 4;
        mma16816(s0, ql[ks], bh[0], bh[1]);
        mma16816(s0, qh[ks], bl[0], bl[1]);
        mma16816(s1, ql[ks], bh[2], bh[3]);
        mma16816(s1, qh[ks], bl[2], bl[3]);
        mma16816(s0, qh[ks], bh[0], bh[1]);
        mma16816(s1, qh[ks], bh[2], bh[3]);
      }
    }

    const float scale =
        mask_scores(s, p, need_mask(p, kv0, kF32Keys, pos_lo, pos_hi), kv0,
                    row, tg, seg_row, seg_s, scale_log2);
    float corr[2];
    softmax_tile(s, scale, m, l, corr);
    rescale(o, corr);

    // O += P V: the S accumulators of two adjacent n8 tiles are exactly
    // the A fragment of a 16-key k-step.
#pragma unroll
    for (int kk = 0; kk < kF32Keys / 16; ++kk) {
      const float* sk = s + 8 * kk;
      const uint32_t ph[4] = {pack_bf16(sk[0], sk[1]), pack_bf16(sk[2], sk[3]),
                              pack_bf16(sk[4], sk[5]), pack_bf16(sk[6], sk[7])};
      const uint32_t pl[4] = {
          pack_bf16(bf16_residual(sk[0]), bf16_residual(sk[1])),
          pack_bf16(bf16_residual(sk[2]), bf16_residual(sk[3])),
          pack_bf16(bf16_residual(sk[4]), bf16_residual(sk[5])),
          pack_bf16(bf16_residual(sk[6]), bf16_residual(sk[7]))};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        // B fragments of two d tiles, V[key 16kk + 2tg (+1, +8, +9)][d],
        // by one transposed ldmatrix.x4: matrices (keys lo, dt), (keys
        // hi, dt), (keys lo, dt+1), (keys hi, dt+1).
        const int off = (kk * 16 + (mi & 1) * 8 + mr) * kLd +
                        (dt + (mi >> 1)) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_trans(bh, Vh + off);
        ldsm_x4_trans(bl, Vl + off);
        float* const o0 = o + 4 * dt;
        float* const o1 = o0 + 4;
        mma16816(o0, pl, bh[0], bh[1]);
        mma16816(o0, ph, bl[0], bl[1]);
        mma16816(o1, pl, bh[2], bh[3]);
        mma16816(o1, ph, bl[2], bl[3]);
        mma16816(o0, ph, bh[0], bh[1]);
        mma16816(o1, ph, bh[2], bh[3]);
      }
    }
    __syncthreads();  // stage st may be refilled by the next fetch
  }
  write_rows<float>(p, b, h, row, tg, o, m, l);
}

// ------------------------------------------------------------------ host

// Launches of each kernel behind rtt_flash_fwd since the library was
// loaded, counted where the launch succeeds (rtt_flash_fwd_launches reads
// them): which kernel a call took, as observed rather than as assumed.
enum { kWgmmaKernel = 0, kF32Kernel = 1, kKernels = 2 };
std::atomic<long long> g_launches[kKernels];

int counted_launch(int kernel) {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_launches[kernel].fetch_add(1);
  return (int)e;
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = encode_4d(&tq, p.q, D, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                    kTile);
  if (!e)
    e = encode_4d(&tk, p.k, D, p.Sk, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb,
                  kTile);
  if (!e)
    e = encode_4d(&tv, p.v, D, p.Sk, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb,
                  kTile);
  if (e) return e;
  constexpr int smem = Smem<D>::total + 1024;  // + alignment slack
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((p.Sq + kTile - 1) / kTile), (unsigned)p.H,
                  (unsigned)p.B);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(p, tq, tk, tv);
  return counted_launch(kWgmmaKernel);
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem = 2 * (4 * kF32Keys * (D + 8) * sizeof(uint16_t) +
                           kF32Keys * sizeof(int));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((p.Sq + kF32Rows - 1) / kF32Rows), (unsigned)p.H,
                  (unsigned)p.B);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(p);
  return counted_launch(kF32Kernel);
}

}  // namespace

// ptrs: q, k, v, seg_q, seg_k, out, lse.
// ints: dtype (0 bf16, 1 f32), B, H, Hkv, Sq, Sk, D,
//       q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
//       o_sb, o_ss, o_sh, segq_sb, segk_sb,
//       causal, has_window, window, q_offset.
// dtype 0 launches the wgmma kernel, dtype 1 the mma.sync hi/lo kernel.
// Returns the cudaError_t of the launch (0 on success), or kEncodeError
// (10000) + the CUresult of a tensor map that could not be made.
extern "C" int rtt_flash_fwd(void* const* ptrs, const long long* ints,
                             float scale, void* stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.seg_q = static_cast<const int*>(ptrs[3]);
  p.seg_k = static_cast<const int*>(ptrs[4]);
  p.out = ptrs[5];
  p.lse = static_cast<float*>(ptrs[6]);
  const long long dtype = ints[0];
  p.B = ints[1];
  p.H = ints[2];
  p.Hkv = ints[3];
  p.Sq = ints[4];
  p.Sk = ints[5];
  const long long D = ints[6];
  p.q_sb = ints[7];
  p.q_ss = ints[8];
  p.q_sh = ints[9];
  p.k_sb = ints[10];
  p.k_ss = ints[11];
  p.k_sh = ints[12];
  p.v_sb = ints[13];
  p.v_ss = ints[14];
  p.v_sh = ints[15];
  p.o_sb = ints[16];
  p.o_ss = ints[17];
  p.o_sh = ints[18];
  p.segq_sb = ints[19];
  p.segk_sb = ints[20];
  p.causal = ints[21];
  p.has_window = ints[22];
  p.window = ints[23];
  p.q_offset = ints[24];
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return launch_bf16<128>(p, st);
  if (dtype == 0 && D == 64) return launch_bf16<64>(p, st);
  if (dtype == 1 && D == 128) return launch_f32<128>(p, st);
  if (dtype == 1 && D == 64) return launch_f32<64>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The launches rtt_flash_fwd has made of each kernel since the library
// was loaded: out[0] the wgmma kernel, out[1] the mma.sync f32 kernel.
extern "C" void rtt_flash_fwd_launches(long long* out) {
  for (int i = 0; i < kKernels; ++i) out[i] = g_launches[i].load();
}
