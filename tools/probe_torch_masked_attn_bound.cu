// Probe kernels for tools/probe_torch_masked_attn_bound.py: what bounded the
// first design of masked cross-attention (K3) on an H100. They are measuring
// instruments, not part of the port; the port's K3 is
// mp_former_tpu_torch/csrc/masked_attn_fwd.cu.
//
// The first design, kept here so that it can still be timed beside the port's
// kernel: one thread owns one query row (q and an fp32 accumulator in
// registers), tiles of 32 keys, 32 values and 128 x 32 mask bytes pass through
// shared memory by plain loads between two __syncthreads(), both products are
// scalar fp32 FMAs with a shared-memory operand each, the keys are split into
// chunks across blocks and a second kernel, one warp a row, walks the chunks
// one after the other to merge them.
//
//   variant 0  as it was
//   variant 1  the mask is not read (no key is masked): the cost of the 1-byte
//              mask loads and of the mask tile
//   variant 2  the products are removed: one FMA a key instead of 2 x 32, the
//              loads, the tiles, the softmax and the exponentials stay
//   which 0    both kernels; 1 the partial kernel alone; 2 the merge alone
//              (on whatever the scratch holds)
//
//   q (B, H, Q, 32), k, v (B, H, S, 32) float32, contiguous; mask 1 byte per
//   entry at mask[b * mask_sb + h * mask_sh + q * S + s]; out (B, H, Q, 32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;
constexpr int kKT = 32;
constexpr int kQT = 128;
constexpr int kMaskPitch = 36;
constexpr float kMasked = -1e9f;

template <bool kReadMask, bool kProducts>
__global__ void __launch_bounds__(kQT)
partial_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const uint8_t* __restrict__ mask,
               float* __restrict__ part_acc, float* __restrict__ part_m,
               float* __restrict__ part_l, int H, int Q, int S,
               long long mask_sb, long long mask_sh, int chunk, float scale) {
  __shared__ float ks[kKT][kD];
  __shared__ float vs[kKT][kD];
  __shared__ uint8_t ms[kQT][kMaskPitch];

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.z * kQT;
  const int qi = q0 + threadIdx.x;
  const bool active = qi < Q;
  const int s_begin = c * chunk;
  const int s_end = min(S, s_begin + chunk);
  const float* kb = k + (long long)bh * S * kD;
  const float* vb = v + (long long)bh * S * kD;
  const uint8_t* mb = mask + b * mask_sb + h * mask_sh;

  float qr[kD], acc[kD];
  #pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = active ? q[((long long)bh * Q + qi) * kD + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -1e30f, l_run = 0.f;

  for (int t0 = s_begin; t0 < s_end; t0 += kKT) {
    const int n = min(kKT, s_end - t0);
    for (int idx = threadIdx.x; idx < kKT * kD; idx += kQT) {
      const int r = idx / kD, col = idx % kD;
      const long long off = (long long)(t0 + r) * kD + col;
      ks[r][col] = r < n ? kb[off] : 0.f;
      vs[r][col] = r < n ? vb[off] : 0.f;
    }
    if (kReadMask) {
      for (int idx = threadIdx.x; idx < kQT * kKT; idx += kQT) {
        const int r = idx / kKT, col = idx % kKT;
        ms[r][col] = (q0 + r < Q && col < n) ? mb[(long long)(q0 + r) * S + t0 + col] : 1;
      }
    }
    __syncthreads();
    if (active) {
      float sc[kKT];
      float tmax = -INFINITY;
      #pragma unroll
      for (int j = 0; j < kKT; ++j) {
        float dot = 0.f;
        if (kProducts) {
          #pragma unroll
          for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        } else {
          dot = qr[j] * ks[j][j];
        }
        const bool blocked = kReadMask ? ms[threadIdx.x][j] != 0 : false;
        const float sj = j < n ? (blocked ? kMasked : dot) : -INFINITY;
        sc[j] = sj;
        tmax = fmaxf(tmax, sj);
      }
      const float m_new = fmaxf(m_run, tmax);
      const float alpha = expf(m_run - m_new);
      l_run *= alpha;
      #pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
      #pragma unroll
      for (int j = 0; j < kKT; ++j) {
        const float p = expf(sc[j] - m_new);
        l_run += p;
        if (kProducts) {
          #pragma unroll
          for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
        } else {
          acc[j] = fmaf(p, vs[j][j], acc[j]);
        }
      }
      m_run = m_new;
    }
    __syncthreads();
  }

  if (active) {
    const long long row = ((long long)bh * gridDim.x + c) * Q + qi;
    part_m[row] = m_run;
    part_l[row] = l_run;
    #pragma unroll
    for (int d = 0; d < kD; ++d) part_acc[row * kD + d] = acc[d];
  }
}

__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               float* __restrict__ out, int BH, int Q, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)BH * Q) return;
  const long long bh = row / Q, qi = row % Q;
  float m_all = -1e30f;
  for (int c = 0; c < chunks; ++c) m_all = fmaxf(m_all, part_m[(bh * chunks + c) * Q + qi]);
  float l_all = 0.f, a = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const long long r = (bh * chunks + c) * Q + qi;
    const float w = expf(part_m[r] - m_all);
    l_all += part_l[r] * w;
    a += part_acc[r * kD + lane] * w;
  }
  out[row * kD + lane] = a / fmaxf(l_all, 1e-30f);
}

}  // namespace

// part_acc (B*H, chunks, Q, 32), part_m / part_l (B*H, chunks, Q): fp32 scratch
// of the caller, chunks = ceil(S / chunk), chunk a positive multiple of 32.
// Returns the first failing launch's cudaError_t (0 = cudaSuccess).
extern "C" int masked_attn_probe(const void* q, const void* k, const void* v, const void* mask,
                                 void* part_acc, void* part_m, void* part_l, void* out,
                                 int B, int H, int Q, int S, long long mask_sb,
                                 long long mask_sh, int chunk, int variant, int which,
                                 void* stream) {
  if (S <= 0 || chunk <= 0 || chunk % kKT != 0 || variant < 0 || variant > 2 || which < 0 ||
      which > 2)
    return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const uint8_t* mf = static_cast<const uint8_t*>(mask);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  const int chunks = (S + chunk - 1) / chunk;
  const float scale = 1.f / sqrtf((float)kD);
  if (which != 2) {
    const dim3 grid(chunks, B * H, (Q + kQT - 1) / kQT);
    if (variant == 0)
      partial_kernel<true, true><<<grid, kQT, 0, st>>>(qf, kf, vf, mf, pa, pm, pl, H, Q, S,
                                                       mask_sb, mask_sh, chunk, scale);
    else if (variant == 1)
      partial_kernel<false, true><<<grid, kQT, 0, st>>>(qf, kf, vf, mf, pa, pm, pl, H, Q, S,
                                                        mask_sb, mask_sh, chunk, scale);
    else
      partial_kernel<true, false><<<grid, kQT, 0, st>>>(qf, kf, vf, mf, pa, pm, pl, H, Q, S,
                                                        mask_sb, mask_sh, chunk, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which != 1) {
    const long long rows = (long long)B * H * Q;
    const int warps = 8;
    combine_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, st>>>(
        pa, pm, pl, static_cast<float*>(out), B * H, Q, chunks);
  }
  return (int)cudaGetLastError();
}
