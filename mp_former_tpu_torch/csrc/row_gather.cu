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
// widest aligned unit its byte length allows (16, 4 or 2 bytes). A row belongs
// to a team of 2^k neighbouring lanes, the smallest power of two that covers
// the row's units, up to a warp: a 512-byte row is one coalesced 16-byte
// request of a warp, and several short rows share a warp. A thread finds its
// row and its unit by a shift and a mask of its 32-bit index (no division),
// reads the row's index once (the team's lanes read one address, which is one
// request), and copies up to kUnitsPerLane units in strides of the team; a
// row longer than a team's share continues in the next block along y. Blocks
// are 128 threads, so 64 rows of 512 bytes already make 16 blocks.
// row_gather_sum never writes the gathered rows. At the probe's shape (65536
// rows of 512 bytes from an 8.5 MB table into 8 slots) the rows come from the
// L2, 33.5 MB of them, and what bounds the kernel is how many row loads are in
// flight, not bytes from device memory: the first design (a thread a (slot,
// column) pair, one 4-byte load after the other behind its index load, 128
// blocks) reached 0.56 TB/s. Now a block of 16 warps owns a run of rows (a
// multiple of `slots`, chosen by the wrapper from N and the SM count so that
// the grid is about two blocks an SM) and stages their indices in shared
// memory with one coalesced read; a team of lanes (the same teams as
// row_gather, up to a warp) reads a row in 16-byte units where the width and
// the table's address allow, in 4-byte units otherwise; the teams of a block
// take a slot each (or share one, in turns, where there are more teams than
// slots) and keep 8 independent row loads in flight per lane before the first
// add. The sums meet in a (slots, W) accumulator in shared memory (where it
// fits 16 KB) and leave it as one atomicAdd per entry and block, a warp on
// 128 consecutive bytes: every block adds to the same few lines of the output,
// which serialise in the L2, so a request should cover a whole line. The order
// of the atomic additions changes from run to run, hence a tolerance in the
// comparison with the plain version.
//
// What bounds them on the H100: bytes, and for small N the launch itself; the
// tables of the probes (128 KB to 8.5 MB) stay in the 50 MB L2, so the bytes
// that count are the L2's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumThreads = 512;          // row_gather_sum
constexpr int kSumMaxRows = 2048;         // row_gather_sum: indices a block stages
constexpr int kSumUnroll = 8;             // row_gather_sum: row loads in flight per lane (8 = the sum tree)
constexpr int kSumSharedFloats = 4096;    // row_gather_sum: a block's shared accumulator
constexpr int kGatherThreads = 128;       // row_gather
constexpr int kUnitsPerLane = 8;          // row_gather: units a lane copies of one row

// team = 1 << team_shift lanes per row; a block holds kGatherThreads >> team_shift
// rows along x and one share of (kUnitsPerLane << team_shift) units along y.
template <typename U, typename I>
__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const U* __restrict__ tab, const I* __restrict__ idx, U* __restrict__ out,
                  unsigned N, long long units, int team_shift) {
  const unsigned team = 1u << team_shift;
  const unsigned row = blockIdx.x * (kGatherThreads >> team_shift) + (threadIdx.x >> team_shift);
  if (row >= N) return;
  const unsigned lane = threadIdx.x & (team - 1);
  const U* src = tab + (long long)idx[row] * units;
  U* dst = out + (long long)row * units;
  const long long share = (long long)kUnitsPerLane << team_shift;
  for (long long first = blockIdx.y * share; first < units; first += gridDim.y * share) {
    const long long last = min(first + share, units);
#pragma unroll 4
    for (long long u = first + lane; u < last; u += team) dst[u] = src[u];
  }
}

template <typename U, typename I>
cudaError_t launch_gather(const void* tab, const void* idx, void* out, long long N,
                          long long units, cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  if (N > 0x7fffffffLL) return cudaErrorInvalidValue;
  int team_shift = 0;
  while (team_shift < 5 && (1LL << team_shift) < units) ++team_shift;
  const long long rows_per_block = kGatherThreads >> team_shift;
  const long long share = (long long)kUnitsPerLane << team_shift;
  const long long shares = (units + share - 1) / share;
  const dim3 grid((unsigned)((N + rows_per_block - 1) / rows_per_block),
                  (unsigned)(shares < 65535 ? shares : 65535));
  row_gather_kernel<U, I><<<grid, kGatherThreads, 0, stream>>>(
      static_cast<const U*>(tab), static_cast<const I*>(idx), static_cast<U*>(out),
      (unsigned)N, units, team_shift);
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

// Read-only loads as volatile asm: they are issued in program order, all of a
// batch before the first add (left to itself the compiler puts each add right
// behind its load and keeps two rows in flight instead of eight).
__device__ __forceinline__ float4 load_row_unit(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0,%1,%2,%3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_row_unit(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float sum2(float a, float b) { return a + b; }
__device__ __forceinline__ float4 sum2(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
// dst[0 .. kVec) (op)= x, where op is a store, a shared-memory or a global atomic add
template <int kOp> __device__ __forceinline__ void put(float* dst, float x) {
  if (kOp == 0) *dst = x; else atomicAdd(dst, x);
}
template <int kOp> __device__ __forceinline__ void put(float* dst, const float4& x) {
  put<kOp>(dst, x.x); put<kOp>(dst + 1, x.y); put<kOp>(dst + 2, x.z); put<kOp>(dst + 3, x.w);
}

// A block owns `rows_per_block` consecutive rows (a multiple of `slots`, so
// its row i belongs to slot i % slots) and stages their indices in shared
// memory (kStaged; a block with more rows than kSumMaxRows reads them from
// global memory instead). V is the unit a lane loads, float4 or float. A team
// of 1 << team_shift lanes covers a row's units; a task is (slot, part): the
// `split` teams that share a slot take its rows in turn. `via_shared`: the
// tasks' sums go into a (slots, W) accumulator in shared memory first (plain
// stores where a slot has one team), and the block adds it to the output with
// one atomicAdd an entry, a warp on 32 consecutive floats: a request a line.
template <typename V, typename I, bool kStaged>
__global__ void __launch_bounds__(kSumThreads)
row_gather_sum_kernel(const V* __restrict__ tab, const I* __restrict__ idx,
                      float* __restrict__ out, long long N, int units, int slots,
                      int rows_per_block, int team_shift, int via_shared) {
  __shared__ I sidx[kStaged ? kSumMaxRows : 1];
  __shared__ float sacc[kSumSharedFloats];
  constexpr int kVec = sizeof(V) / 4;
  const long long first = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, N - first);
  const int width = units * kVec;
  if (kStaged)
    for (int i = threadIdx.x; i < rows; i += kSumThreads) sidx[i] = idx[first + i];
  if (via_shared)
    for (int i = threadIdx.x; i < slots * width; i += kSumThreads) sacc[i] = 0.f;
  if (kStaged || via_shared) __syncthreads();
  auto row_of = [&](int i) -> const V* {
    return tab + (long long)(kStaged ? sidx[i] : idx[first + i]) * units;
  };

  const int team = 1 << team_shift, teams = kSumThreads >> team_shift;
  const int lane = threadIdx.x & (team - 1);
  const int split = (teams + slots - 1) / slots;
  const int per_slot = rows / slots;
  for (int task = threadIdx.x >> team_shift; task < slots * split; task += teams) {
    const int s = task % slots, part = task / slots;
    for (int u = lane; u < units; u += team) {
      V acc = V();
      int r = part;
      for (; r + (kSumUnroll - 1) * split < per_slot; r += kSumUnroll * split) {
        const V* src[kSumUnroll];
        V x[kSumUnroll];
#pragma unroll
        for (int e = 0; e < kSumUnroll; ++e) src[e] = row_of(s + slots * (r + e * split)) + u;
#pragma unroll
        for (int e = 0; e < kSumUnroll; ++e) x[e] = load_row_unit(src[e]);
#pragma unroll
        for (int e = 0; e < kSumUnroll; e += 2) x[e] = sum2(x[e], x[e + 1]);
#pragma unroll
        for (int e = 0; e < kSumUnroll; e += 4) x[e] = sum2(x[e], x[e + 2]);
#pragma unroll
        for (int e = 0; e < kSumUnroll; e += 8) acc = sum2(acc, sum2(x[e], x[e + 4]));
      }
      for (; r < per_slot; r += split) acc = sum2(acc, load_row_unit(row_of(s + slots * r) + u));
      const long long at = (long long)s * width + (long long)u * kVec;
      if (!via_shared) put<1>(out + at, acc);
      else if (split == 1) put<0>(sacc + at, acc);
      else put<1>(sacc + at, acc);
    }
  }
  if (via_shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < slots * width; i += kSumThreads) atomicAdd(out + i, sacc[i]);
  }
}

template <typename V, typename I>
cudaError_t launch_sum_units(const void* tab, const void* idx, void* out, long long N,
                             int units, int slots, int rows_per_block, cudaStream_t stream) {
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int team_shift = 0;
  while (team_shift < 5 && (1 << team_shift) < units) ++team_shift;
  const int teams = kSumThreads >> team_shift;
  const long long outputs = (long long)slots * units * (sizeof(V) / 4);
  const int via_shared = outputs <= kSumSharedFloats;
  const V* t = static_cast<const V*>(tab);
  const I* i = static_cast<const I*>(idx);
  float* o = static_cast<float*>(out);
  if (rows_per_block <= kSumMaxRows)
    row_gather_sum_kernel<V, I, true><<<(unsigned)blocks, kSumThreads, 0, stream>>>(
        t, i, o, N, units, slots, rows_per_block, team_shift, via_shared);
  else
    row_gather_sum_kernel<V, I, false><<<(unsigned)blocks, kSumThreads, 0, stream>>>(
        t, i, o, N, units, slots, rows_per_block, team_shift, via_shared);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_sum(const void* tab, const void* idx, void* out, long long N, int W,
                       int slots, int rows_per_block, cudaStream_t stream) {
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(tab) % 16 == 0)
    return launch_sum_units<float4, I>(tab, idx, out, N, W / 4, slots, rows_per_block, stream);
  return launch_sum_units<float, I>(tab, idx, out, N, W, slots, rows_per_block, stream);
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

// float32 table; `out` (slots, W) must be zero when the kernel starts. N and
// rows_per_block (the rows a block sums) are multiples of `slots`.
extern "C" int row_gather_sum(const void* tab, const void* idx, void* out, long long N,
                              int W, int slots, int rows_per_block, int idx_is_64,
                              void* stream) {
  if (N < 0 || W <= 0 || slots <= 0 || rows_per_block <= 0 || N % slots != 0 ||
      rows_per_block % slots != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(idx_is_64 ? launch_sum<int64_t>(tab, idx, out, N, W, slots, rows_per_block, s)
                         : launch_sum<int32_t>(tab, idx, out, N, W, slots, rows_per_block, s));
}
