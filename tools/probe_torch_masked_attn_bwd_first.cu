// The first design of K3 backward (a thread a key, float32 multiply-adds on
// the CUDA cores, dQ by float32 atomics), kept as it was so that
// tools/probe_torch_masked_attn_bound.py --backward can time it beside the
// port's kernel (csrc/masked_attn_bwd.cu); only the entry point's name
// (masked_attn_bwd_first) differs. Not built into the port.
//
// Masked cross-attention, backward (K3 backward), for sm_90a.
//
// The gradient of csrc/masked_attn_fwd.cu. The TPU kernel it belongs to
// (mp_former_tpu/ops/fused_masked_attention.py:masked_attention) has no
// gradient of its own: the JAX package trains through the einsum form of
// mp_former_tpu/models/transformer_decoder/primitives.py:72-80, whose autodiff
// this kernel reproduces without writing the (Q, S) weights to device memory.
// Same result as masked_attention_backward_plain in
// mp_former_tpu_torch/ops/masked_attention_cuda.py.
//
//   out = softmax(q k^T / sqrt(D), masked logits REPLACED by -1e9) v
//
//   delta = rowsum(dO * O)
//   s     = q k^T / sqrt(D), or -1e9 where the mask blocks
//   p     = exp(s - max) / sum              (max and sum from the forward)
//   dV    = p^T dO
//   dP    = dO v^T
//   dS    = p * (dP - delta), and 0 where the mask blocks: the -1e9 is a
//           constant, so no gradient passes through a blocked logit
//   dQ    = dS k / sqrt(D)        dK = dS^T q / sqrt(D)
//
// A row whose keys are all blocked is uniform over all keys in the forward
// (every logit is -1e9): dV receives dO / S from it, dQ and dK nothing.
//
//   q, out, d_out  logical (B, H, Q, D)    k, v  logical (B, H, S, D)    D = 32
//           float32 or bfloat16, each with its own batch, head and row stride in
//           elements (last dimension contiguous, rows on 16-byte boundaries)
//   mask    1 byte per entry, 1 = blocked, (B, Q, S) (mask_sh = 0) or
//           (B, H, Q, S), contiguous, any alignment
//   stats   (B * H, Q, 2) float32 from the forward: the row's maximum score in
//           the base-2 domain and the sum of its weights relative to it
//   dq      float32 (B, Q, H, D), zeroed by the caller: summed with atomics
//   dk, dv  in the input type, (B, S, H, D) in memory, each row written once
//
// What bounds it on the H100. Five products of 2 Q S D operations per head:
// at the training shape B = 8, H = 8, Q = 120, S = 4096 that is 10 GFLOP
// (0.06 ms as 3xTF32 on the tensor cores, the same rule as the forward's
// bound) against 76 MB of q, k, v, mask and gradients (0.02 ms): bound by
// operations. This first design runs them as plain float32 multiply-adds on
// the float32 cores, whose 67 TFLOP/s alone would take 0.15 ms.
//
// Design.
// * A block owns 128 keys of one (batch, head): a thread a key. The thread
//   keeps its key's k and v rows and its dK and dV rows in registers for the
//   whole kernel and writes them once, so dK and dV need no atomics and the
//   (Q, S) weights never leave the SM.
// * The queries go by in tiles of 16: their q rows (pre-scaled by log2(e) /
//   sqrt(D), as in the forward), d_out rows, statistics and deltas are staged
//   in shared memory and read by all threads as broadcasts. Per (key, query) a
//   thread does 4 x 32 multiply-adds: the score, dP, and the updates of dV and
//   dK.
// * dQ sums over keys, i.e. across threads and blocks. The tile's dS go to
//   shared memory, and in a second phase 8 threads a query multiply them with
//   the block's K tile (also in shared memory), 4 channels a thread, and add
//   the 16 x 32 partial sums to dq with float32 atomics: one atomic per
//   (query, channel) and 128 keys. The order of these sums varies from run to
//   run, so dq is reproducible to rounding only.
// * The forward's products are 3xTF32 and these are float32: the weights
//   recomputed here differ from the forward's by ~1e-6 relative.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;          // channels per head
constexpr int kKT = 128;        // keys per block, one per thread
constexpr int kQT = 16;         // queries per tile
constexpr int kDsPitch = kKT + 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e9f * kLog2e;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* d_out;
  const uint8_t* mask;
  const float* stats;
  float* delta;  // (B*H, Q) scratch
  float* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr;
  long long o_sb, o_sh, o_sr, g_sb, g_sh, g_sr;
  long long mask_sb, mask_sh;
  int H, Q, S;
  float scale;  // 1 / sqrt(D)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 32 channels of one row into registers
__device__ __forceinline__ void load_row(float (&r)[kD], const float* p) {
  #pragma unroll
  for (int j = 0; j < kD / 4; ++j) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + j);
    r[4 * j] = x.x; r[4 * j + 1] = x.y; r[4 * j + 2] = x.z; r[4 * j + 3] = x.w;
  }
}
__device__ __forceinline__ void load_row(float (&r)[kD], const __nv_bfloat16* p) {
  #pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + j);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      r[8 * j + 2 * e] = f.x;
      r[8 * j + 2 * e + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void store_row(float* p, const float (&r)[kD], float scale) {
  #pragma unroll
  for (int j = 0; j < kD / 4; ++j)
    reinterpret_cast<float4*>(p)[j] = make_float4(r[4 * j] * scale, r[4 * j + 1] * scale,
                                                  r[4 * j + 2] * scale, r[4 * j + 3] * scale);
}
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float (&r)[kD], float scale) {
  #pragma unroll
  for (int j = 0; j < kD / 2; ++j)
    reinterpret_cast<__nv_bfloat162*>(p)[j] =
        __floats2bfloat162_rn(r[2 * j] * scale, r[2 * j + 1] * scale);
}

// delta[bh, q] = sum_d d_out[q, d] * out[q, d]: a warp a row, a lane a channel
template <typename T>
__global__ void __launch_bounds__(256)
masked_attn_bwd_delta(const Params p, int BH) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)BH * p.Q) return;
  const long long bh = row / p.Q, qi = row % p.Q;
  const long long b = bh / p.H, h = bh % p.H;
  const T* o = static_cast<const T*>(p.out) + b * p.o_sb + h * p.o_sh + qi * p.o_sr;
  const T* g = static_cast<const T*>(p.d_out) + b * p.g_sb + h * p.g_sh + qi * p.g_sr;
  float x = to_float(o[lane]) * to_float(g[lane]);
  #pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  if (lane == 0) p.delta[row] = x;
}

// grid (ceil(S / 128), B * H), block 128 threads
template <typename T>
__global__ void __launch_bounds__(kKT)
masked_attn_bwd_keys(const Params p) {
  __shared__ __align__(16) float s_k[kKT][kD];       // the block's K tile, for dQ
  __shared__ __align__(16) float s_q[kQT][kD];       // q * log2(e) / sqrt(D)
  __shared__ __align__(16) float s_g[kQT][kD];       // d_out
  __shared__ float s_ds[kQT][kDsPitch];
  __shared__ float s_max[kQT], s_inv_sum[kQT], s_delta[kQT];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const long long b = bh / p.H, h = bh % p.H;
  const int key = blockIdx.x * kKT + tid;
  const bool key_ok = key < p.S;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* gb = static_cast<const T*>(p.d_out) + b * p.g_sb + h * p.g_sh;
  const uint8_t* mb = p.mask + b * p.mask_sb + h * p.mask_sh;
  const float2* stats = reinterpret_cast<const float2*>(p.stats) + (long long)bh * p.Q;
  const float* delta = p.delta + (long long)bh * p.Q;
  const float scale_log2 = p.scale * kLog2e;

  float kr[kD], vr[kD], dk[kD], dv[kD];
  #pragma unroll
  for (int d = 0; d < kD; ++d) kr[d] = vr[d] = dk[d] = dv[d] = 0.f;
  if (key_ok) {
    load_row(kr, static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + (long long)key * p.k_sr);
    load_row(vr, static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + (long long)key * p.v_sr);
  }
  #pragma unroll
  for (int j = 0; j < kD / 4; ++j)
    *reinterpret_cast<float4*>(&s_k[tid][4 * j]) =
        make_float4(kr[4 * j], kr[4 * j + 1], kr[4 * j + 2], kr[4 * j + 3]);

  // the second phase's share: query tid / 8 of the tile, channels 4 * (tid % 8) ...
  const int dq_row = tid >> 3, dq_col = (tid & 7) * 4;

  for (int q0 = 0; q0 < p.Q; q0 += kQT) {
    const int qn = min(kQT, p.Q - q0);
    __syncthreads();  // the last tile's second phase is over (and s_k is written)
    for (int i = tid; i < qn * kD; i += kKT) {
      const int r = i / kD, d = i % kD;
      s_q[r][d] = to_float(qb[(long long)(q0 + r) * p.q_sr + d]) * scale_log2;
      s_g[r][d] = to_float(gb[(long long)(q0 + r) * p.g_sr + d]);
    }
    if (tid < qn) {
      const float2 st = stats[q0 + tid];
      s_max[tid] = st.x;
      s_inv_sum[tid] = 1.f / st.y;
      s_delta[tid] = delta[q0 + tid];
    }
    // this key's mask bytes of the tile, all loads in flight together
    uint8_t blocked[kQT];
    #pragma unroll
    for (int r = 0; r < kQT; ++r)
      blocked[r] = (key_ok && r < qn) ? __ldg(mb + (long long)(q0 + r) * p.S + key) : 1;
    __syncthreads();

    #pragma unroll
    for (int r = 0; r < kQT; ++r) {
      if (r >= qn) break;
      float s = 0.f, dp = 0.f;
      #pragma unroll
      for (int j = 0; j < kD / 4; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(&s_q[r][4 * j]);
        const float4 gv = *reinterpret_cast<const float4*>(&s_g[r][4 * j]);
        s = fmaf(qv.x, kr[4 * j], s);
        s = fmaf(qv.y, kr[4 * j + 1], s);
        s = fmaf(qv.z, kr[4 * j + 2], s);
        s = fmaf(qv.w, kr[4 * j + 3], s);
        dp = fmaf(gv.x, vr[4 * j], dp);
        dp = fmaf(gv.y, vr[4 * j + 1], dp);
        dp = fmaf(gv.z, vr[4 * j + 2], dp);
        dp = fmaf(gv.w, vr[4 * j + 3], dp);
      }
      if (blocked[r]) s = kMasked;
      const float pw = key_ok ? exp2f(s - s_max[r]) * s_inv_sum[r] : 0.f;
      const float ds = blocked[r] ? 0.f : pw * (dp - s_delta[r]);
      s_ds[r][tid] = ds;
      #pragma unroll
      for (int j = 0; j < kD / 4; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(&s_q[r][4 * j]);
        const float4 gv = *reinterpret_cast<const float4*>(&s_g[r][4 * j]);
        dv[4 * j] = fmaf(pw, gv.x, dv[4 * j]);
        dv[4 * j + 1] = fmaf(pw, gv.y, dv[4 * j + 1]);
        dv[4 * j + 2] = fmaf(pw, gv.z, dv[4 * j + 2]);
        dv[4 * j + 3] = fmaf(pw, gv.w, dv[4 * j + 3]);
        dk[4 * j] = fmaf(ds, qv.x, dk[4 * j]);
        dk[4 * j + 1] = fmaf(ds, qv.y, dk[4 * j + 1]);
        dk[4 * j + 2] = fmaf(ds, qv.z, dk[4 * j + 2]);
        dk[4 * j + 3] = fmaf(ds, qv.w, dk[4 * j + 3]);
      }
    }
    __syncthreads();

    // dQ of the tile from this block's keys
    if (dq_row < qn) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      #pragma unroll 8
      for (int s = 0; s < kKT; ++s) {
        const float ds = s_ds[dq_row][s];
        const float4 kv = *reinterpret_cast<const float4*>(&s_k[s][dq_col]);
        acc.x = fmaf(ds, kv.x, acc.x);
        acc.y = fmaf(ds, kv.y, acc.y);
        acc.z = fmaf(ds, kv.z, acc.z);
        acc.w = fmaf(ds, kv.w, acc.w);
      }
      // dq is (B, Q, H, D) in memory
      float* dst = p.dq + ((b * p.Q + q0 + dq_row) * p.H + h) * kD + dq_col;
      atomicAdd(dst, acc.x * p.scale);
      atomicAdd(dst + 1, acc.y * p.scale);
      atomicAdd(dst + 2, acc.z * p.scale);
      atomicAdd(dst + 3, acc.w * p.scale);
    }
  }

  if (key_ok) {
    // (B, S, H, D) in memory; dk was summed against q * log2(e) / sqrt(D)
    const long long row = ((b * p.S + key) * p.H + h) * kD;
    store_row(static_cast<T*>(p.dk) + row, dk, kLn2);
    store_row(static_cast<T*>(p.dv) + row, dv, 1.f);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int BH = B * p.H;
  if (BH == 0 || p.Q == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidConfiguration;
  const long long rows = (long long)BH * p.Q;
  masked_attn_bwd_delta<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p, BH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kKT - 1) / kKT, BH);
  masked_attn_bwd_keys<T><<<grid, kKT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The 15 strides are in elements: (batch, head, row) of q, k, v, out and
// d_out. delta: B * H * Q floats of scratch. dq: B * Q * H * D floats, zeroed
// by the caller. dk, dv: B * S * H * D elements of the input type. dtype: 0 =
// float32, 1 = bfloat16. Returns the first failing launch's cudaError_t (0 =
// cudaSuccess); the launches are asynchronous on `stream`.
extern "C" int masked_attn_bwd_first(const void* q, const void* k, const void* v, const void* out,
                               const void* d_out, const void* mask, const void* stats,
                               void* delta, void* dq, void* dk, void* dv,
                               int B, int H, int Q, int S, int D,
                               long long q_sb, long long q_sh, long long q_sr,
                               long long k_sb, long long k_sh, long long k_sr,
                               long long v_sb, long long v_sh, long long v_sr,
                               long long o_sb, long long o_sh, long long o_sr,
                               long long g_sb, long long g_sh, long long g_sr,
                               long long mask_sb, long long mask_sh, int dtype, void* stream) {
  if (D != kD || S <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.d_out = d_out;
  p.mask = static_cast<const uint8_t*>(mask);
  p.stats = static_cast<const float*>(stats);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sr = q_sr;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sr = k_sr;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sr = v_sr;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sr = o_sr;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_sr = g_sr;
  p.mask_sb = mask_sb; p.mask_sh = mask_sh;
  p.H = H; p.Q = Q; p.S = S;
  p.scale = 1.f / sqrtf((float)kD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
