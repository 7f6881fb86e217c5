// The attention backward's delta pre-pass for Hopper (sm_90a), bound to
// Python via ctypes.
//
// delta = rowsum(dO * O): for each (batch, position, head) row of the
// attention output O and its cotangent dO, (B, S, H, D) in bf16 or fp32
// with any strides, the fp32 sum over the head dim of the fp32 products,
// written to (B, H, S) fp32 contiguous, the layout both backward kernels
// read (flash_bwd.cu, splash.cu). It replaces the JAX package's plain
// expression jnp.sum(do.astype(f32) * out.astype(f32), -1), which it
// leaves to XLA (ray_tpu/ops/flash_attention.py:343-346,
// ray_tpu/ops/splash_attention.py:402-404): there is no Pallas kernel.
//
// What bounds it on an H100: memory. It reads O and dO once and writes 4
// bytes a row, 2 flops an element: at the 1B train shape (B=4, S=2048, 16
// heads, D=128, bf16) 67 MB, 0.020 ms at 3.35 TB/s. What the design does:
//   * A row is read by a group of G lanes, G the smallest power of two
//     that covers its 16-byte chunks (at most 32): one 16-byte load of
//     each tensor a chunk, products and sum in fp32, then a shuffle
//     reduction within the group. So D=128 bf16 takes two rows a warp and
//     every lane issues full-width loads.
//   * Rows are numbered in the output's (B, H, S) order, so neighbouring
//     groups write neighbouring sums.
//   * A row whose head dim is not contiguous, or not 16-byte aligned,
//     takes a per-element path (strided loads, the same fp32 sums), so
//     any view a caller hands in is read where it lies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* out;
  const void* dout;
  float* delta;
  long long B, S, H, D;
  long long o_sb, o_ss, o_sh, o_sd, do_sb, do_ss, do_sh, do_sd;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

// The fp32 dot product of two 16-byte chunks of T.
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const float*) {
  float s = __uint_as_float(a.x) * __uint_as_float(b.x);
  s = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), s);
  s = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), s);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), s);
}

// Thread t of the grid works on row t >> shift of the (B, H, S) output,
// in a group of 1 << shift lanes. 32-bit index arithmetic: the host
// refuses a grid of 2^31 threads or more.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    attention_delta_kernel(const Params p, int shift) {
  const int group = 1 << shift;
  const int n_rows = (int)(p.B * p.H * p.S);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int row = t >> shift;
  const int sub = t & (group - 1);  // lane within the row's group
  float acc = 0.f;
  if (row < n_rows) {
    const int S = (int)p.S, H = (int)p.H;
    const long long s = row % S;
    const long long h = row / S % H;
    const long long b = row / (S * H);
    const T* o = static_cast<const T*>(p.out) + b * p.o_sb + s * p.o_ss +
                 h * p.o_sh;
    const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + s * p.do_ss +
                 h * p.do_sh;
    const int D = (int)p.D;
    if constexpr (kVec) {
      constexpr int kPer = 16 / sizeof(T);  // elements of a chunk
      for (int c = sub; c * kPer < D; c += group)
        acc += dot16(__ldg(reinterpret_cast<const uint4*>(o) + c),
                     __ldg(reinterpret_cast<const uint4*>(d) + c), o);
    } else {
      for (int i = sub; i < D; i += group)
        acc = fmaf(to_float(o[i * p.o_sd]), to_float(d[i * p.do_sd]), acc);
    }
  }
  // Groups are aligned powers of two: the xor stays inside each.
  for (int off = group >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n_rows && sub == 0) p.delta[row] = acc;
}

// Whether every row of `base` (element strides sb, ss, sh, sd over extents
// B, S, H, D of `bytes`-byte elements) is contiguous and 16-byte aligned.
bool rows_aligned(const void* base, const Params& p, long long sb,
                  long long ss, long long sh, long long sd, int bytes) {
  if (sd != 1 && p.D > 1) return false;
  if ((p.D * bytes) % 16 || reinterpret_cast<uintptr_t>(base) % 16)
    return false;
  const long long ext[3] = {p.B, p.S, p.H};
  const long long st[3] = {sb, ss, sh};
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && (st[i] * bytes) % 16) return false;
  return true;
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int bytes = (int)sizeof(T);
  const bool vec =
      rows_aligned(p.out, p, p.o_sb, p.o_ss, p.o_sh, p.o_sd, bytes) &&
      rows_aligned(p.dout, p, p.do_sb, p.do_ss, p.do_sh, p.do_sd, bytes);
  const long long chunks = vec ? p.D * bytes / 16 : p.D;
  int shift = 0;
  while ((1ll << shift) < chunks && shift < 5) ++shift;
  const long long threads = (p.B * p.H * p.S) << shift;
  if (threads + kThreads >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (vec)
    attention_delta_kernel<T, true><<<blocks, kThreads, 0, stream>>>(p, shift);
  else
    attention_delta_kernel<T, false><<<blocks, kThreads, 0, stream>>>(p,
                                                                      shift);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: out, do, delta. ints: dtype (0 bf16, 1 f32), B, S, H, D, then
// out's and do's element strides (b, s, h, d) each. Returns the
// cudaError_t of the launch (0 on success); an empty tensor, another
// dtype or 2^31 threads (rows x group) or more are refused.
extern "C" int rtt_attention_delta(void* const* ptrs, const long long* ints,
                                   void* stream) {
  Params p;
  p.out = ptrs[0];
  p.dout = ptrs[1];
  p.delta = static_cast<float*>(ptrs[2]);
  p.B = ints[1];
  p.S = ints[2];
  p.H = ints[3];
  p.D = ints[4];
  long long* const strides[8] = {&p.o_sb,  &p.o_ss,  &p.o_sh,  &p.o_sd,
                                 &p.do_sb, &p.do_ss, &p.do_sh, &p.do_sd};
  for (int i = 0; i < 8; ++i) *strides[i] = ints[5 + i];
  if (p.B * p.S * p.H <= 0 || p.D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[0] == 0) return launch<__nv_bfloat16>(p, st);
  if (ints[0] == 1) return launch<float>(p, st);
  return (int)cudaErrorInvalidValue;
}
