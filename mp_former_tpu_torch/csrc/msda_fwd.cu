// Multi-scale deformable sampling, forward (K1), for sm_90a.
//
// Replaces the TPU kernel mp_former_tpu/ops/msda_pallas.py:_gather_weight_level
// (body `_kernel`) together with the XLA index and weight math around it
// (`_msda_pallas_impl`). Same result as the plain versions in
// mp_former_tpu_torch/ops/msda_cuda.py: `ms_deform_attn_plain` (bilinear
// sampling with zero padding as grid_sample's align_corners=False, weighted by
// the attention weights and summed over levels and points) and
// `ms_deform_attn_folded`, which does the arithmetic in this kernel's order.
//
//   value               (B, S, M, D)        S = sum over levels of H_l * W_l
//   levels              (L, 3) int32        (H_l, W_l, first token of level l)
//   sampling_locations  (B, Q, M, L, P, 2)  in [0, 1], (x, y) order
//   attention_weights   (B, Q, M, L, P)
//   out                 (B, Q, M * D)       in the input type, fp32 accumulation
//
// What bounds it on the H100. At the slice's 800x1088 canvas S = Q = 17850,
// so one layer samples 17850 * 8 heads * 12 points = 1.71 M points, i.e.
// 6.85 M taps of 32 channels: 877 MB of loads in fp32 from a value tensor of
// 18.3 MB that stays in the 50 MB L2. HBM sees 44 MB (0.017 ms). A design with
// one warp per (query, head) and one lane per channel took 0.25 ms whether the
// taps were spread over the map, near their query or all on one pixel: it was
// bound by instruction issue, since all 32 lanes repeated the same ~80
// instructions of coordinate, bounds and address arithmetic per point, and
// only the 4 loads and 4 multiply-adds differed by lane.
//
// Design.
// - 8 lanes per (batch, query, head), 4 channels a lane in both types: a tap
//   is one 16-byte load a lane in fp32 (8 bytes in bf16), still one 128-byte
//   line per tap, and a warp serves 4 pairs with one instruction stream.
// - A block owns 16 consecutive queries of one head. In the model a query
//   samples within a few pixels of itself and consecutive queries are
//   neighbours on the map, so the block's taps fall on few lines of one head's
//   values and the L1 serves part of them (a block that holds every head of
//   two queries, as the pair index runs, spreads its taps over eight times the
//   lines and was measurably slower).
// - The scalar work of a point is done once, not by every lane: the points of
//   a pair are dealt out over its 8 lanes, 8 points a round. A lane reads its
//   point's location and weight (a pair's rows are contiguous, so the reads
//   coalesce), finds the pixel corner and folds bilinear weight x validity x
//   attention weight into four tap weights, with the tap index clamped onto
//   the map: a tap off the map has weight 0 and a safe address, as the TPU
//   kernel's formulation has it. (So a non-finite value next to the map's edge
//   can reach the sum as 0 * inf, as in the plain versions; grid_sample
//   skips the tap.) A point whose location is not finite or lies a pixel or
//   more off the map gets four zero weights.
// - The loop over the round's points takes offsets and weights from the
//   owning lane by __shfl_sync within the group. It has no branch that
//   depends on the data, and is unrolled kChunk points at a time so that
//   4 * kChunk loads are issued before the first is used.
// - Level sizes are int32 in shared memory; offsets inside a batch element are
//   32-bit (the launch refuses S * M * D >= 2^31), only the base is 64-bit.
// Any level sizes, L, P, B, Q, M; D = 32. A group past the last query works on
// the last query and stores nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;                      // channels per head
constexpr int kLanes = 8;                   // lanes per (batch, query, head)
constexpr int kVec = kD / kLanes;           // channels per lane
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kQueriesPerBlock = kThreads / kLanes;
constexpr int kChunk = 4;                   // points whose taps are in flight together
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// kVec channels of one pixel
__device__ __forceinline__ float4 load_vec(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_vec(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store_vec(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
// one (x, y) location
__device__ __forceinline__ float2 load_xy(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_xy(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void fma_vec(float4& acc, float w, const float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// The four taps of one point: element offsets from the lane's base pointer and
// the folded weights, in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1).
struct Taps {
  int o00, o01, o10, o11;
  float w00, w01, w10, w11;
};

// The taps of point k of the round, from the lane of the group that owns it.
template <typename T>
__device__ __forceinline__ void add_point(float4& acc, const T* __restrict__ base,
                                          const Taps& mine, int k) {
  const int o00 = __shfl_sync(kFullMask, mine.o00, k, kLanes);
  const int o01 = __shfl_sync(kFullMask, mine.o01, k, kLanes);
  const int o10 = __shfl_sync(kFullMask, mine.o10, k, kLanes);
  const int o11 = __shfl_sync(kFullMask, mine.o11, k, kLanes);
  const float4 v00 = load_vec(base + o00);
  const float4 v01 = load_vec(base + o01);
  const float4 v10 = load_vec(base + o10);
  const float4 v11 = load_vec(base + o11);
  fma_vec(acc, __shfl_sync(kFullMask, mine.w00, k, kLanes), v00);
  fma_vec(acc, __shfl_sync(kFullMask, mine.w01, k, kLanes), v01);
  fma_vec(acc, __shfl_sync(kFullMask, mine.w10, k, kLanes), v10);
  fma_vec(acc, __shfl_sync(kFullMask, mine.w11, k, kLanes), v11);
}

// T: value and out; U: locations and weights (T, or float32 for a bfloat16 value)
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                const U* __restrict__ loc, const U* __restrict__ attn, T* __restrict__ out,
                int S, int Q, int M, int L, int P) {
  extern __shared__ int s_levels[];  // (L, 3): H, W, first token
  for (int i = threadIdx.x; i < 3 * L; i += kThreads) s_levels[i] = levels[i];
  __syncthreads();

  const int lane = threadIdx.x & (kLanes - 1);
  // blockIdx.x = (b * M + m) * query blocks + query block
  const int query_blocks = (Q + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const int bm = blockIdx.x / query_blocks;
  const int b = bm / M;
  const int m = bm % M;
  const int q = (blockIdx.x % query_blocks) * kQueriesPerBlock + threadIdx.x / kLanes;
  const bool live = q < Q;
  // every lane stays in the shuffles
  const int pair = (b * Q + (live ? q : Q - 1)) * M + m;
  const int LP = L * P;
  // the pair's rows of locations and weights are contiguous
  const U* loc_p = loc + (long long)pair * LP * 2;
  const U* attn_p = attn + (long long)pair * LP;
  const int pix_stride = M * kD;  // elements between pixels
  const T* base = value + (long long)b * S * pix_stride + m * kD + lane * kVec;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int first = 0; first < LP; first += kLanes) {
    // this lane's point of the round
    Taps mine = {0, 0, 0, 0, 0.f, 0.f, 0.f, 0.f};
    const int i = first + lane;
    if (i < LP) {
      const int l = i / P;
      const int H = s_levels[3 * l], W = s_levels[3 * l + 1], start = s_levels[3 * l + 2];
      const float2 xy = load_xy(loc_p + 2 * i);
      // loc * W rounded, then - 0.5, as the JAX package and the plain version
      // round it: contracted into one FMA, a location within an ulp of a pixel
      // centre (every location at the reference init, on a level whose size is
      // no power of two) would floor to the other side of the centre
      const float x = __fmul_rn(xy.x, (float)W) - 0.5f;
      const float y = __fmul_rn(xy.y, (float)H) - 0.5f;
      const float x0f = floorf(x), y0f = floorf(y);
      // false for a location that is not finite; also keeps the int
      // conversions in range
      if (x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)) {
        const float tx = x - x0f, ty = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;  // in [-1, W - 1], [-1, H - 1]
        const float a = to_float(attn_p[i]);
        const float wx0 = x0 >= 0 ? 1.f - tx : 0.f;
        const float wx1 = x0 + 1 < W ? tx : 0.f;
        const float wy0 = y0 >= 0 ? a * (1.f - ty) : 0.f;
        const float wy1 = y0 + 1 < H ? a * ty : 0.f;
        const int xa = max(x0, 0), xb = min(x0 + 1, W - 1);
        const int ra = start + max(y0, 0) * W, rb = start + min(y0 + 1, H - 1) * W;
        mine.o00 = (ra + xa) * pix_stride;
        mine.o01 = (ra + xb) * pix_stride;
        mine.o10 = (rb + xa) * pix_stride;
        mine.o11 = (rb + xb) * pix_stride;
        mine.w00 = wy0 * wx0;
        mine.w01 = wy0 * wx1;
        mine.w10 = wy1 * wx0;
        mine.w11 = wy1 * wx1;
      }
    }
    // the round's points, the same count in every group of the grid
    const int n = min(kLanes, LP - first);
    int k = 0;
    for (; k + kChunk <= n; k += kChunk) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) add_point(acc, base, mine, k + j);
    }
    for (; k < n; ++k) add_point(acc, base, mine, k);
  }
  if (live) store_vec(out + (long long)pair * kD + lane * kVec, acc);
}

template <typename T, typename U>
cudaError_t launch(const void* value, const void* levels, const void* loc, const void* attn,
                   void* out, int B, int S, int Q, int M, int L, int P, cudaStream_t stream) {
  if ((long long)B * Q * M == 0) return cudaSuccess;
  if (L <= 0 || P <= 0 || S <= 0) return cudaErrorInvalidValue;
  // 32-bit pair indices and 32-bit element offsets inside a batch element
  if ((long long)B * Q * M > 0x7fffffffLL || (long long)S * M * kD > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * 3 * L;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * M * ((Q + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_fwd_kernel<T, U><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(levels), static_cast<const U*>(loc),
      static_cast<const U*>(attn), static_cast<T*>(out), S, Q, M, L, P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = bfloat16 value and out with float32
// locations and weights. Every pointer must be 16-byte aligned.
// Returns the launch's cudaError_t (0 = cudaSuccess); the launch is
// asynchronous on `stream`.
extern "C" int msda_fwd(const void* value, const void* levels, const void* loc,
                        const void* attn, void* out,
                        int B, int S, int Q, int M, int L, int P, int D, int dtype,
                        void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, float>(value, levels, loc, attn, out, B, S, Q, M, L, P, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(value, levels, loc, attn, out, B, S, Q, M,
                                                     L, P, s);
  if (dtype == 2)
    return (int)launch<__nv_bfloat16, float>(value, levels, loc, attn, out, B, S, Q, M, L, P, s);
  return (int)cudaErrorInvalidValue;
}
