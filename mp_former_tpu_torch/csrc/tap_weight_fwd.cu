// Tap weighting, forward (K2), for sm_90a.
//
// Replaces the TPU kernels of mp_former_tpu/ops/tap_weighting.py (`_call_one`
// and `_call_batched`, bodies `_kernel*`). Same result as the plain version
// mp_former_tpu_torch/ops/tap_weighting.py:weight_taps_plain:
//
//   out[b, q, (m d)] = sum over p, t of  taps[b, (p q), (t m d)] * w[b, (p q), (t m)]
//
//   taps  (B, P * Q, T * M * D)   rows point-major, lanes (t, m, d) major to minor
//   w     (B, P * Q, T * M)       lanes (t, m)
//   out   (B, Q, M * D)           in the input type, fp32 accumulation
//
// Both call shapes of the model go through it: the head-shared engine (B = 1,
// M = 8, rows 1024 wide) and the per-head 2x2-patch engine (B * M tables as
// the batch, M = 1, rows 128 wide). Any Q, P and T.
//
// Design. One thread per VEC consecutive output channels of one (b, q); the
// threads of a warp lie along the contiguous (m d) axis, so each of the P * T
// reads per output is a coalesced row segment (16 bytes a thread in fp32 with
// VEC = 4). The VEC channels share a head, so a thread reads one weight per
// (p, t), the same address for all threads of that head (a broadcast). The sum
// stays in registers and the taps are read exactly once. The TPU kernel's
// q-blocks, its padding of Q to the block and its accumulator carried across
// grid steps are dropped: blocks here are independent and the ragged end is a
// bounds check.
//
// What bounds it on the H100: bytes. One multiply-add per 4 (fp32) or 2 (bf16)
// bytes of taps; at the 800x1088 canvas the head-shared taps of the largest
// level are 292 MB in fp32 (71400 rows of 1024), read once from HBM. All
// offsets are 64-bit: that tensor already has 73 M elements.

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
tap_weight_fwd_kernel(const T* __restrict__ taps, const T* __restrict__ w, T* __restrict__ out,
                      long long B, long long Q, int P, int NT, int M, int D) {
  const int MD = M * D;
  const int units = MD / VEC;  // per output row
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= B * Q * units) return;
  const int j = (int)(gid % units) * VEC;  // first channel of this thread in (m d)
  const long long bq = gid / units;
  const long long q = bq % Q;
  const long long b = bq / Q;
  const int m = j / D;
  const long long tmd = (long long)NT * MD;
  const long long tm = (long long)NT * M;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int p = 0; p < P; ++p) {
    const long long row = b * P * Q + (long long)p * Q + q;  // point-major rows
    const T* taps_row = taps + row * tmd + j;
    const T* w_row = w + row * tm + m;
#pragma unroll 4
    for (int t = 0; t < NT; ++t) {
      const Pack<T, VEC> x = *reinterpret_cast<const Pack<T, VEC>*>(taps_row + (long long)t * MD);
      const float wt = to_float(w_row[t * M]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_float(x.v[k]) * wt;
    }
  }
  Pack<T, VEC> y;
#pragma unroll
  for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[k]);
  *reinterpret_cast<Pack<T, VEC>*>(out + bq * MD + j) = y;
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* taps, const void* w, void* out, long long B, long long Q,
                       int P, int NT, int M, int D, cudaStream_t stream) {
  const long long total = B * Q * (M * D / VEC);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  tap_weight_fwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(taps), static_cast<const T*>(w), static_cast<T*>(out),
      B, Q, P, NT, M, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* taps, const void* w, void* out, long long B, long long Q,
                   int P, int NT, int M, int D, cudaStream_t stream) {
  // 4 channels a thread where they share a head and every unit is aligned
  // (rows are multiples of D, so D % 4 == 0 and aligned bases suffice)
  const uintptr_t align = sizeof(T) * 4;
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(taps) % align == 0 &&
                    reinterpret_cast<uintptr_t>(out) % align == 0;
  return vec4 ? launch_vec<T, 4>(taps, w, out, B, Q, P, NT, M, D, stream)
              : launch_vec<T, 1>(taps, w, out, B, Q, P, NT, M, D, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. NT = taps per point (4 for a 2x2 patch).
// Returns the launch's cudaError_t (0 = cudaSuccess); asynchronous on `stream`.
extern "C" int tap_weight_fwd(const void* taps, const void* w, void* out,
                              long long B, long long Q, int P, int NT, int M, int D,
                              int dtype, void* stream) {
  if (B < 0 || Q < 0 || P < 0 || NT <= 0 || M <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(taps, w, out, B, Q, P, NT, M, D, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(taps, w, out, B, Q, P, NT, M, D, s);
  return (int)cudaErrorInvalidValue;
}
