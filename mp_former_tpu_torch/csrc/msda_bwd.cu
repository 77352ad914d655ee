// Multi-scale deformable sampling, backward (K1 backward), for sm_90a.
//
// The gradient of csrc/msda_fwd.cu. The TPU kernel it belongs to
// (mp_former_tpu/ops/msda_pallas.py:_gather_weight_level) has no backward
// kernel: its VJP (msda_pallas.py:249-258) recomputes through the XLA
// formulation and lets autodiff scatter. Here the three gradients come from one
// kernel. Same result as ms_deform_attn_backward_plain in
// mp_former_tpu_torch/ops/msda_cuda.py.
//
//   grad_out            (B, Q, M * D)
//   value               (B, S, M, D)        S = sum over levels of H_l * W_l
//   levels              (L, 3) int32        (H_l, W_l, first token of level l)
//   sampling_locations  (B, Q, M, L, P, 2)  in [0, 1], (x, y) order
//   attention_weights   (B, Q, M, L, P)
//   grad_value          (B, S, M, D) float32, zeroed by the caller
//   grad_loc, grad_attn in the input type, the inputs' shapes
//
// Per point, with bilinear weights b_t of its four taps t (0 for a tap off
// the map, exactly as the forward's validity has it), attention weight a,
// g = grad_out[b, q, m, :] and d_t = <value[tap t], g>:
//
//   grad_value[tap t] += a b_t g
//   grad_attn          = sum_t b_t d_t
//   grad_loc.x         = a W sum_t (d b_t / d x) d_t     (x in pixels = loc.x W - 0.5)
//   grad_loc.y         = a H sum_t (d b_t / d y) d_t
//
// floor() has no gradient, and a point whose location is not finite or lies a
// pixel or more off the map contributes to none of the three.
//
// What bounds it on the H100. At the training shape (B = 8, 512x512: Q = S =
// 5376, 8 heads, 12 points) a layer has 4.1 M points, 16.5 M taps of 32
// channels: 2.1 GB of loads from a value tensor of 44 MB that stays in the L2,
// and as many bytes of float32 atomic adds into a grad_value of 44 MB. HBM
// sees ~150 MB (0.05 ms); the kernel is bound by the L2's atomic throughput
// and by contention: the 16 consecutive queries of a block sample neighbouring
// pixels of one head, so their adds hit the same lines.
//
// Design. The forward's layout, so that its index arithmetic is done once per
// point and not per lane:
// - 8 lanes per (batch, query, head), 4 channels a lane; a block owns 16
//   consecutive queries of one head; the points of a pair are dealt out over
//   its 8 lanes, 8 points a round. The owning lane computes the four tap
//   offsets and folded weights, and keeps the factors of its point's
//   derivatives.
// - In the loop over the round's points every lane loads its 4 channels of the
//   four taps, multiplies them with its 4 channels of g and the group reduces
//   the four dot products by __shfl_xor_sync over its 8 lanes; the owning lane
//   keeps them. Each lane adds w_t * g for its 4 channels to grad_value with
//   one 16-byte atomic a tap (atomicAdd on a float4, which sm_90 has), skipping taps
//   of weight 0.
// - After the loop the owning lane writes its point's grad_attn and grad_loc:
//   each is written exactly once, in the input type, with coalesced rows.
// - grad_value is accumulated in float32 whatever the input type; the wrapper
//   casts it. The order of the atomic adds varies from run to run, so
//   grad_value is reproducible to rounding only.
// What the adds cost, and what did not help (tools/probe_torch_msda_bwd_bound.py
// on an H100 at the training shape): without any add to grad_value the kernel
// takes about a third of its time, and with plain stores instead of atomics
// ~90%: the bytes written into the L2, not the atomics, bound it. Blocks that
// own 2-D tiles of tokens, and taps binned by pixel in shared memory with one
// add a pixel and block (tools/probe_torch_msda_bwd_binned.cu), measured no
// faster and slower than this design: the binning's bookkeeping costs about
// what the adds it saves cost.

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
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_scalar(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
// one (x, y) location
__device__ __forceinline__ float2 load_xy(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_xy(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_xy(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_xy(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float dot_vec(const float4 a, const float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// sum over the 8 lanes of a group; every lane gets it
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 4, kLanes);
  x += __shfl_xor_sync(kFullMask, x, 2, kLanes);
  x += __shfl_xor_sync(kFullMask, x, 1, kLanes);
  return x;
}

// p[0..3] += w * g, one 16-byte atomic (p is 16-byte aligned)
__device__ __forceinline__ void atomic_add_vec(float* p, float w, const float4 g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
}

// The four taps of one point: element offsets from the lane's base pointer and
// the folded weights (bilinear x validity x attention), in the order (y0, x0),
// (y0, x1), (y1, x0), (y1, x1).
struct Taps {
  int o00, o01, o10, o11;
  float w00, w01, w10, w11;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const T* __restrict__ grad_out, const T* __restrict__ value,
                const int* __restrict__ levels, const T* __restrict__ loc,
                const T* __restrict__ attn, float* __restrict__ grad_value,
                T* __restrict__ grad_loc, T* __restrict__ grad_attn,
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
  // every lane stays in the shuffles; a group past the last query adds and writes nothing
  const int pair = (b * Q + (live ? q : Q - 1)) * M + m;
  const int LP = L * P;
  const T* loc_p = loc + (long long)pair * LP * 2;
  const T* attn_p = attn + (long long)pair * LP;
  const int pix_stride = M * kD;  // elements between pixels
  const long long lane_base = (long long)b * S * pix_stride + m * kD + lane * kVec;
  const T* base = value + lane_base;
  float* gbase = grad_value + lane_base;
  const float4 g = load_vec(grad_out + (long long)pair * kD + lane * kVec);

  for (int first = 0; first < LP; first += kLanes) {
    // this lane's point of the round: its taps, and the factors of its gradients
    Taps mine = {0, 0, 0, 0, 0.f, 0.f, 0.f, 0.f};
    float a = 0.f, bx0 = 0.f, bx1 = 0.f, by0 = 0.f, by1 = 0.f;  // bilinear factors x validity
    float sx0 = 0.f, sx1 = 0.f, sy0 = 0.f, sy1 = 0.f;           // their derivatives
    float Wf = 0.f, Hf = 0.f;
    const int i = first + lane;
    if (i < LP) {
      const int l = i / P;
      const int H = s_levels[3 * l], W = s_levels[3 * l + 1], start = s_levels[3 * l + 2];
      const float2 xy = load_xy(loc_p + 2 * i);
      const float x = xy.x * W - 0.5f;
      const float y = xy.y * H - 0.5f;
      const float x0f = floorf(x), y0f = floorf(y);
      // false for a location that is not finite; also keeps the int conversions in range
      if (x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)) {
        const float tx = x - x0f, ty = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;  // in [-1, W - 1], [-1, H - 1]
        a = to_float(attn_p[i]);
        Wf = (float)W;
        Hf = (float)H;
        if (x0 >= 0) { bx0 = 1.f - tx; sx0 = -1.f; }
        if (x0 + 1 < W) { bx1 = tx; sx1 = 1.f; }
        if (y0 >= 0) { by0 = 1.f - ty; sy0 = -1.f; }
        if (y0 + 1 < H) { by1 = ty; sy1 = 1.f; }
        const int xa = max(x0, 0), xb = min(x0 + 1, W - 1);
        const int ra = start + max(y0, 0) * W, rb = start + min(y0 + 1, H - 1) * W;
        mine.o00 = (ra + xa) * pix_stride;
        mine.o01 = (ra + xb) * pix_stride;
        mine.o10 = (rb + xa) * pix_stride;
        mine.o11 = (rb + xb) * pix_stride;
        mine.w00 = a * by0 * bx0;
        mine.w01 = a * by0 * bx1;
        mine.w10 = a * by1 * bx0;
        mine.w11 = a * by1 * bx1;
      }
    }
    // <value[tap], g> of this lane's point, kept when its turn comes
    float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
    // the round's points, the same count in every group of the grid
    const int n = min(kLanes, LP - first);
    for (int k = 0; k < n; ++k) {
      const int o00 = __shfl_sync(kFullMask, mine.o00, k, kLanes);
      const int o01 = __shfl_sync(kFullMask, mine.o01, k, kLanes);
      const int o10 = __shfl_sync(kFullMask, mine.o10, k, kLanes);
      const int o11 = __shfl_sync(kFullMask, mine.o11, k, kLanes);
      const float w00 = __shfl_sync(kFullMask, mine.w00, k, kLanes);
      const float w01 = __shfl_sync(kFullMask, mine.w01, k, kLanes);
      const float w10 = __shfl_sync(kFullMask, mine.w10, k, kLanes);
      const float w11 = __shfl_sync(kFullMask, mine.w11, k, kLanes);
      const float e00 = group_sum(dot_vec(load_vec(base + o00), g));
      const float e01 = group_sum(dot_vec(load_vec(base + o01), g));
      const float e10 = group_sum(dot_vec(load_vec(base + o10), g));
      const float e11 = group_sum(dot_vec(load_vec(base + o11), g));
      if (lane == k) { d00 = e00; d01 = e01; d10 = e10; d11 = e11; }
      if (live) {
        if (w00 != 0.f) atomic_add_vec(gbase + o00, w00, g);
        if (w01 != 0.f) atomic_add_vec(gbase + o01, w01, g);
        if (w10 != 0.f) atomic_add_vec(gbase + o10, w10, g);
        if (w11 != 0.f) atomic_add_vec(gbase + o11, w11, g);
      }
    }
    if (live && i < LP) {
      const float top = bx0 * d00 + bx1 * d01, bottom = bx0 * d10 + bx1 * d11;
      const float ga = by0 * top + by1 * bottom;
      const float gx = a * Wf * (by0 * (sx0 * d00 + sx1 * d01) + by1 * (sx0 * d10 + sx1 * d11));
      const float gy = a * Hf * (sy0 * top + sy1 * bottom);
      store_scalar(grad_attn + (long long)pair * LP + i, ga);
      store_xy(grad_loc + ((long long)pair * LP + i) * 2, gx, gy);
    }
  }
}

template <typename T>
cudaError_t launch(const void* grad_out, const void* value, const void* levels, const void* loc,
                   const void* attn, void* grad_value, void* grad_loc, void* grad_attn,
                   int B, int S, int Q, int M, int L, int P, cudaStream_t stream) {
  if ((long long)B * Q * M == 0) return cudaSuccess;
  if (L <= 0 || P <= 0 || S <= 0) return cudaErrorInvalidValue;
  // 32-bit pair indices and 32-bit element offsets inside a batch element; the
  // batch element's base is 64-bit
  if ((long long)B * Q * M > 0x7fffffffLL || (long long)S * M * kD > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * 3 * L;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * M * ((Q + kQueriesPerBlock - 1) / kQueriesPerBlock);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(grad_out), static_cast<const T*>(value),
      static_cast<const int*>(levels), static_cast<const T*>(loc), static_cast<const T*>(attn),
      static_cast<float*>(grad_value), static_cast<T*>(grad_loc), static_cast<T*>(grad_attn),
      S, Q, M, L, P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer must be 16-byte aligned.
// grad_value is float32 for both types and must be zero on entry. Returns the
// launch's cudaError_t (0 = cudaSuccess); the launch is asynchronous on
// `stream`.
extern "C" int msda_bwd(const void* grad_out, const void* value, const void* levels,
                        const void* loc, const void* attn, void* grad_value, void* grad_loc,
                        void* grad_attn, int B, int S, int Q, int M, int L, int P, int D,
                        int dtype, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(grad_out, value, levels, loc, attn, grad_value, grad_loc,
                              grad_attn, B, S, Q, M, L, P, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(grad_out, value, levels, loc, attn, grad_value, grad_loc,
                                      grad_attn, B, S, Q, M, L, P, s);
  return (int)cudaErrorInvalidValue;
}
