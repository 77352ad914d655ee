// Row gather and row gather-sum, for sm_90a.
//
// Replaces the three TPU row-gather probes: tools/bench_sampling_engines.py
// `probe_mosaic_take` (tab[idx] inside a kernel) and `probe_pallas_dma` (rows
// fetched one by one and summed into a few slots), and the in-kernel
// `jnp.take` of tools/probe_msda_kernel.py. Same results as the plain versions
// in mp_former_tpu_torch/ops/row_gather.py:
//
//   row_gather:      out[i, :]  = tab[idx[i], :]                    (N, W)
//   row_gather_sum:  out[s, :]  = sum over i with i % slots == s of tab[idx[i], :]
//                                                                   (slots, W), float32
//
// The indices are the caller's promise to lie in [0, R): the kernels do not
// check them, as the TPU probes did not.
//
// Design. A gather of whole rows is a copy: row_gather moves each row in the
// widest aligned unit its byte length allows (16, 4 or 2 bytes), one unit per
// thread, neighbouring threads on neighbouring units of one row, so a 512-byte
// row is one coalesced request of a warp. row_gather_sum gives each block a
// run of rows (a multiple of `slots`) and each thread (slot, column) pairs; a
// thread sums its rows in a register and adds the partial sum to the output
// with one atomicAdd, so the gathered rows never reach memory. The order of
// the atomic additions changes from run to run, hence a tolerance in the
// comparison with the plain version.
//
// What bounds them on the H100: bytes, and for small N the launch itself; the
// tables of the probes (128 KB to 8.5 MB) stay in the 50 MB L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerSlotPerBlock = 64;  // row_gather_sum: rows a thread sums per pair

template <typename U, typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const U* __restrict__ tab, const I* __restrict__ idx, U* __restrict__ out,
                  long long N, long long units) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (gid >= N * units) return;
  const long long i = gid / units;
  const long long u = gid % units;
  out[gid] = tab[(long long)idx[i] * units + u];
}

template <typename U, typename I>
cudaError_t launch_gather(const void* tab, const void* idx, void* out, long long N,
                          long long units, cudaStream_t stream) {
  const long long blocks = (N * units + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  row_gather_kernel<U, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(tab), static_cast<const I*>(idx), static_cast<U*>(out), N, units);
  return cudaGetLastError();
}

template <typename I>
cudaError_t gather_by_unit(const void* tab, const void* idx, void* out, long long N,
                           long long row_bytes, cudaStream_t stream) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && both % 16 == 0)
    return launch_gather<uint4, I>(tab, idx, out, N, row_bytes / 16, stream);
  if (row_bytes % 4 == 0 && both % 4 == 0)
    return launch_gather<uint32_t, I>(tab, idx, out, N, row_bytes / 4, stream);
  if (row_bytes % 2 == 0 && both % 2 == 0)
    return launch_gather<uint16_t, I>(tab, idx, out, N, row_bytes / 2, stream);
  return cudaErrorInvalidValue;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
row_gather_sum_kernel(const float* __restrict__ tab, const I* __restrict__ idx,
                      float* __restrict__ out, long long N, int W, int slots) {
  const long long rows_per_block = (long long)kRowsPerSlotPerBlock * slots;
  const long long first = (long long)blockIdx.x * rows_per_block;
  const long long last = min(first + rows_per_block, N);
  const int pairs = slots * W;
  for (int pair = threadIdx.x; pair < pairs; pair += kThreads) {
    const int s = pair / W;
    const int c = pair % W;
    float acc = 0.f;
    // `first` is a multiple of `slots`, so row i belongs to slot i % slots = s
    for (long long i = first + s; i < last; i += slots)
      acc += tab[(long long)idx[i] * W + c];
    atomicAdd(out + pair, acc);
  }
}

template <typename I>
cudaError_t launch_sum(const void* tab, const void* idx, void* out, long long N, int W,
                       int slots, cudaStream_t stream) {
  const long long rows_per_block = (long long)kRowsPerSlotPerBlock * slots;
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  row_gather_sum_kernel<I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(tab), static_cast<const I*>(idx), static_cast<float*>(out),
      N, W, slots);
  return cudaGetLastError();
}

}  // namespace

// idx_is_64: 0 = int32 indices, 1 = int64. row_bytes = W * element size.
// Returns the launch's cudaError_t (0 = cudaSuccess); asynchronous on `stream`.
extern "C" int row_gather(const void* tab, const void* idx, void* out, long long N,
                          long long row_bytes, int idx_is_64, void* stream) {
  if (N < 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(idx_is_64 ? gather_by_unit<int64_t>(tab, idx, out, N, row_bytes, s)
                         : gather_by_unit<int32_t>(tab, idx, out, N, row_bytes, s));
}

// float32 table; `out` (slots, W) must be zero when the kernel starts.
extern "C" int row_gather_sum(const void* tab, const void* idx, void* out, long long N,
                              int W, int slots, int idx_is_64, void* stream) {
  if (N < 0 || W <= 0 || slots <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(idx_is_64 ? launch_sum<int64_t>(tab, idx, out, N, W, slots, s)
                         : launch_sum<int32_t>(tab, idx, out, N, W, slots, s));
}
