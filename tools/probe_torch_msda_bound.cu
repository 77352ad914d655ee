// Probe kernels for tools/probe_torch_msda_bound.py: what bounds deformable
// sampling (K1) on an H100. They are measuring instruments, not part of the
// port; the port's K1 is mp_former_tpu_torch/csrc/msda_fwd.cu.
//
// Both give one warp to a (batch, query, head) pair and one lane to a channel
// (D = 32), so a tap is one coalesced 128-byte load of a warp:
//
//   msda_probe_per_lane  every lane computes every point's pixel corner,
//                        bounds and addresses itself (the design the port
//                        started with);
//   msda_probe_hoisted   the same loads and multiply-adds, but a point's
//                        scalar work is done by one lane (lane p owns point p
//                        of a round of 32) and handed round by __shfl_sync.
//
// The difference between the two is the cost of the repeated scalar work; the
// difference between their times on scattered and on single-pixel locations is
// the cost of the cache path.
//
//   value (B, S, M, 32) fp32; shapes (L, 2) int64 (H, W); level_start (L,)
//   int64; loc (B, Q, M, L, P, 2); attn (B, Q, M, L, P); out (B, Q, M * 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
per_lane_kernel(const float* __restrict__ value, const int64_t* __restrict__ shapes,
                const int64_t* __restrict__ level_start, const float* __restrict__ loc,
                const float* __restrict__ attn, float* __restrict__ out,
                int B, int S, int Q, int M, int L, int P) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)B * Q * M) return;
  const int m = (int)(warp % M);
  const int b = (int)(warp / ((long long)Q * M));
  const int LP = L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const long long pix_stride = (long long)M * kD;
  const float* value_bm = value + (long long)b * S * pix_stride + (long long)m * kD + lane;

  float acc = 0.f;
  for (int l = 0; l < L; ++l) {
    const int H = (int)shapes[2 * l];
    const int W = (int)shapes[2 * l + 1];
    const float* v = value_bm + level_start[l] * pix_stride;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float x = loc_w[2 * i] * W - 0.5f;
      const float y = loc_w[2 * i + 1] * H - 0.5f;
      const float x0f = floorf(x), y0f = floorf(y);
      if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)))
        continue;
      const float tx = x - x0f, ty = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      auto tap = [&](int yy, int xx) -> float {
        return (yy >= 0 && yy < H && xx >= 0 && xx < W)
                   ? v[((long long)yy * W + xx) * pix_stride] : 0.f;
      };
      const float v00 = tap(y0, x0), v01 = tap(y0, x0 + 1);
      const float v10 = tap(y0 + 1, x0), v11 = tap(y0 + 1, x0 + 1);
      const float s = (1.f - tx) * (1.f - ty) * v00 + tx * (1.f - ty) * v01
                    + (1.f - tx) * ty * v10 + tx * ty * v11;
      acc += attn_w[i] * s;
    }
  }
  out[warp * kD + lane] = acc;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
hoisted_kernel(const float* __restrict__ value, const int64_t* __restrict__ shapes,
               const int64_t* __restrict__ level_start, const float* __restrict__ loc,
               const float* __restrict__ attn, float* __restrict__ out,
               int B, int S, int Q, int M, int L, int P) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)B * Q * M) return;
  const int m = (int)(warp % M);
  const int b = (int)(warp / ((long long)Q * M));
  const int LP = L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const int pix_stride = M * kD;
  const float* base = value + (long long)b * S * pix_stride + m * kD + lane;

  float acc = 0.f;
  for (int first = 0; first < LP; first += 32) {
    int o00 = 0, o01 = 0, o10 = 0, o11 = 0;
    float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
    const int i = first + lane;
    if (i < LP) {
      const int l = i / P;
      const int H = (int)shapes[2 * l], W = (int)shapes[2 * l + 1];
      const int start = (int)level_start[l];
      const float x = loc_w[2 * i] * W - 0.5f;
      const float y = loc_w[2 * i + 1] * H - 0.5f;
      const float x0f = floorf(x), y0f = floorf(y);
      if (x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)) {
        const float tx = x - x0f, ty = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float a = attn_w[i];
        const float wx0 = x0 >= 0 ? 1.f - tx : 0.f, wx1 = x0 + 1 < W ? tx : 0.f;
        const float wy0 = y0 >= 0 ? a * (1.f - ty) : 0.f, wy1 = y0 + 1 < H ? a * ty : 0.f;
        const int xa = max(x0, 0), xb = min(x0 + 1, W - 1);
        const int ra = start + max(y0, 0) * W, rb = start + min(y0 + 1, H - 1) * W;
        o00 = (ra + xa) * pix_stride; o01 = (ra + xb) * pix_stride;
        o10 = (rb + xa) * pix_stride; o11 = (rb + xb) * pix_stride;
        w00 = wy0 * wx0; w01 = wy0 * wx1; w10 = wy1 * wx0; w11 = wy1 * wx1;
      }
    }
    const int n = min(32, LP - first);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float v00 = base[__shfl_sync(kFullMask, o00, k)];
      const float v01 = base[__shfl_sync(kFullMask, o01, k)];
      const float v10 = base[__shfl_sync(kFullMask, o10, k)];
      const float v11 = base[__shfl_sync(kFullMask, o11, k)];
      acc = fmaf(__shfl_sync(kFullMask, w00, k), v00, acc);
      acc = fmaf(__shfl_sync(kFullMask, w01, k), v01, acc);
      acc = fmaf(__shfl_sync(kFullMask, w10, k), v10, acc);
      acc = fmaf(__shfl_sync(kFullMask, w11, k), v11, acc);
    }
  }
  out[warp * kD + lane] = acc;
}

}  // namespace

// variant: 0 = per_lane, 1 = hoisted. Returns the launch's cudaError_t.
extern "C" int msda_probe(const void* value, const void* shapes, const void* level_start,
                          const void* loc, const void* attn, void* out,
                          int B, int S, int Q, int M, int L, int P, int variant, void* stream) {
  const long long warps = (long long)B * Q * M;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL || (long long)S * M * kD > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  auto kernel = variant == 0 ? per_lane_kernel : hoisted_kernel;
  kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const int64_t*>(shapes),
      static_cast<const int64_t*>(level_start), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<float*>(out), B, S, Q, M, L, P);
  return cudaGetLastError();
}
