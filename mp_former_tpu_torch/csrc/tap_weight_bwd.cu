// Tap weighting, backward (the gradient of K2), for sm_90a.
//
// Replaces the backward of the JAX package's K2: the `_bwd` of the custom_vjp
// `weight_taps` in mp_former_tpu/ops/tap_weighting.py (plain XLA; the TPU has
// no kernel for it). Same result as the plain version
// mp_former_tpu_torch/ops/tap_weighting.py:weight_taps_backward_plain. For
//
//   out[b, q, (m d)] = sum over p, t of  taps[b, (p q), (t m d)] * w[b, (p q), (t m)]
//
// and the gradient g (B, Q, M * D) of out:
//
//   grad_taps[b, (p q), (t m d)] = g[b, q, (m d)] * w[b, (p q), (t m)]
//   grad_w[b, (p q), (t m)]      = sum over d of  taps[b, (p q), (t m d)] * g[b, q, (m d)]
//
// computed in fp32 and stored in the inputs' type (float32 or bfloat16).
// Both call shapes of a training step go through it: the head-shared engine
// (M = 8, rows 1024 wide in fp32) and the per-head 2x2-patch engine (B * M
// tables as the batch, M = 1, rows 128 wide). Any B, Q, P, T, M and D.
//
// Design. One thread per VEC consecutive lanes of one taps row (16 bytes: 4
// fp32 or 8 bf16 lanes); the threads of a warp lie along the row, so the read
// of the taps and the write of grad_taps are coalesced 16-byte accesses, each
// byte once. The VEC lanes share one (t, m): the thread reads one weight (the
// same address for the G = D / VEC threads of that group, a broadcast) and
// the VEC matching values of g, writes VEC products and sums VEC products of
// taps and g. The G partial sums of a group are added by warp shuffles in a
// fixed order (two calls give equal bits) and the group's first thread writes
// grad_w. Rows are visited in (b, q, p) order, p fastest, so the P rows that
// read one row of g run in neighbouring blocks and g is read from the L2, not
// P times from memory. Where no such layout fits (D / VEC no power of two up
// to 32, as for D = 6, or a pointer off its 16-byte boundary) a second kernel
// takes one thread per (row, t, m) and walks its D lanes one at a time. There
// is no q-block and no padding of Q: the ragged end is a bounds check.
//
// What bounds it on the H100: bytes. Per lane of the taps one multiply for
// grad_taps and one multiply-add for grad_w against 2 x 4 bytes (fp32) moved:
// at the training shape (B = 8, 512x512, 5376 queries, P = 4) the taps of a
// level are 176 M lanes, 705 MB in fp32, read once and written once. All
// offsets are 64-bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC values of T moved as one aligned unit
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack { T v[VEC]; };

// the memory row of the r-th row visited: visiting order (b, q, p), storage (b, p, q)
__device__ __forceinline__ void visit(long long r, long long Q, int P, long long* row,
                                      long long* bq) {
  const int p = (int)(r % P);
  *bq = r / P;
  const long long q = *bq % Q;
  const long long b = *bq / Q;
  *row = (b * P + p) * Q + q;
}

// G = D / VEC threads a (t, m) group, a power of two up to 32; no thread
// returns before the shuffles, so every lane of a warp takes part
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
tap_weight_bwd_lanes(const T* __restrict__ taps, const T* __restrict__ w,
                     const T* __restrict__ g, T* __restrict__ grad_taps,
                     T* __restrict__ grad_w, long long B, long long Q, int P, int NT, int M,
                     int D, int G) {
  const int MD = M * D;
  const int TM = NT * M;
  const int units = TM * G;  // threads a row
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = gid < B * Q * P * units;
  float partial = 0.f;
  long long row = 0;
  int tm = 0, d0 = 0;
  if (live) {
    const int unit = (int)(gid % units);
    long long bq;
    visit(gid / units, Q, P, &row, &bq);
    tm = unit / G;
    d0 = (unit - tm * G) * VEC;
    const int m = tm % M;
    const long long lane = row * TM * D + (long long)tm * D + d0;
    const float wt = to_float(w[row * TM + tm]);
    const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(taps + lane);
    const Pack<T, VEC> gv = *reinterpret_cast<const Pack<T, VEC>*>(g + bq * MD + m * D + d0);
    Pack<T, VEC> y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gk = to_float(gv.v[k]);
      y.v[k] = from_float<T>(gk * wt);
      partial += to_float(x.v[k]) * gk;
    }
    *reinterpret_cast<Pack<T, VEC>*>(grad_taps + lane) = y;
  }
  for (int off = G >> 1; off > 0; off >>= 1) partial += __shfl_xor_sync(0xffffffffu, partial, off);
  if (live && d0 == 0) grad_w[row * TM + tm] = from_float<T>(partial);
}

// one thread per (row, t, m): any D, any alignment
template <typename T>
__global__ void __launch_bounds__(kThreads)
tap_weight_bwd_groups(const T* __restrict__ taps, const T* __restrict__ w,
                      const T* __restrict__ g, T* __restrict__ grad_taps,
                      T* __restrict__ grad_w, long long B, long long Q, int P, int NT, int M,
                      int D) {
  const int TM = NT * M;
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= B * Q * P * TM) return;
  const int tm = (int)(gid % TM);
  long long row, bq;
  visit(gid / TM, Q, P, &row, &bq);
  const long long lane = (row * TM + tm) * D;
  const T* x = taps + lane;
  const T* gr = g + bq * M * D + (long long)(tm % M) * D;
  T* y = grad_taps + lane;
  const float wt = to_float(w[row * TM + tm]);
  float acc = 0.f;
  for (int d = 0; d < D; ++d) {
    const float gd = to_float(gr[d]);
    y[d] = from_float<T>(gd * wt);
    acc += to_float(x[d]) * gd;
  }
  grad_w[row * TM + tm] = from_float<T>(acc);
}

cudaError_t grid_for(long long threads, unsigned* blocks) {
  const long long n = (threads + kThreads - 1) / kThreads;
  if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *blocks = (unsigned)n;
  return cudaSuccess;
}

// the lanes kernel with VEC lanes a thread, if D and the pointers allow it
template <typename T, int VEC>
bool try_lanes(const void* taps, const void* w, const void* g, void* grad_taps, void* grad_w,
               long long B, long long Q, int P, int NT, int M, int D, cudaStream_t stream,
               cudaError_t* err) {
  const uintptr_t align = sizeof(T) * VEC;
  const int G = D / VEC;
  if (D % VEC || G > 32 || (G & (G - 1)) || reinterpret_cast<uintptr_t>(taps) % align ||
      reinterpret_cast<uintptr_t>(g) % align || reinterpret_cast<uintptr_t>(grad_taps) % align)
    return false;
  unsigned blocks = 0;
  *err = grid_for(B * Q * P * NT * M * G, &blocks);
  if (*err != cudaSuccess || blocks == 0) return true;
  tap_weight_bwd_lanes<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(taps), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(grad_taps), static_cast<T*>(grad_w), B, Q, P, NT, M, D, G);
  *err = cudaGetLastError();
  return true;
}

template <typename T>
cudaError_t launch(const void* taps, const void* w, const void* g, void* grad_taps,
                   void* grad_w, long long B, long long Q, int P, int NT, int M, int D,
                   cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  // 16 bytes a thread, else one lane a thread in the same layout, else the groups
  if (try_lanes<T, (int)(16 / sizeof(T))>(taps, w, g, grad_taps, grad_w, B, Q, P, NT, M, D, stream,
                                   &err) ||
      try_lanes<T, 1>(taps, w, g, grad_taps, grad_w, B, Q, P, NT, M, D, stream, &err))
    return err;
  unsigned blocks = 0;
  err = grid_for(B * Q * P * NT * M, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  tap_weight_bwd_groups<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(taps), static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<T*>(grad_taps), static_cast<T*>(grad_w), B, Q, P, NT, M, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (taps, w, g and both gradients share it).
// NT = taps per point (4 for a 2x2 patch). Returns the launch's cudaError_t
// (0 = cudaSuccess); asynchronous on `stream`.
extern "C" int tap_weight_bwd(const void* taps, const void* w, const void* g, void* grad_taps,
                              void* grad_w, long long B, long long Q, int P, int NT, int M,
                              int D, int dtype, void* stream) {
  if (B < 0 || Q < 0 || P < 0 || NT <= 0 || M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(taps, w, g, grad_taps, grad_w, B, Q, P, NT, M, D, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(taps, w, g, grad_taps, grad_w, B, Q, P, NT, M, D, s);
  return (int)cudaErrorInvalidValue;
}
