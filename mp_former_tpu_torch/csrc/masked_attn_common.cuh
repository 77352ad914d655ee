// Building blocks of masked cross-attention on the tensor cores, shared by
// the forward (masked_attn_fwd.cu) and the backward (masked_attn_bwd.cu):
// cp.async copies, the TF32 split and the mma.sync products of a 16-row
// fragment with a tile in shared memory. See masked_attn_fwd.cu for the
// arithmetic (3xTF32 in float32, m16n8k16 with ldmatrix in bfloat16).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;          // channels per head
constexpr int kStep = 32;       // keys per step of the online softmax: half a tile, which
                                // halves the score registers
constexpr int kJT = kStep / 8;  // 8-key column tiles of the scores per step
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;
constexpr unsigned kFull = 0xffffffffu;

// bytes of one K or V tile row of a stage in shared memory: 36 floats, or 40 bf16
template <typename T> struct Pitch;
template <> struct Pitch<float> { static constexpr int bytes = 144; };
template <> struct Pitch<__nv_bfloat16> { static constexpr int bytes = 80; };

// float32 tiles split into (big, small) TF32 pairs: row pitches in 8-byte
// pairs. 36 for K and 34 for V keep the fragments' 8-byte loads free of bank
// conflicts (either pitch serves both access patterns).
constexpr int kSplitKPitch = 36;
constexpr int kSplitVPitch = 34;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; `bytes` = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// c (16x8) += a (16x8, rows g and g+8, columns t and t+4) b (8x8, rows t and t+4, column g)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three products of 3xTF32 for four accumulators that share the A
// operand: the small terms first, then big * big. Each round's four MMAs are
// independent, so none waits for the one before it. b holds (big, small) pairs.
__device__ __forceinline__ void mma_3xtf32_x4(float (&c0)[4], float (&c1)[4], float (&c2)[4],
                                              float (&c3)[4], const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4],
                                              const uint2 (&b)[4][2]) {
  // .x is big, .y is small
  mma_tf32(c0, a_small, b[0][0].x, b[0][1].x);
  mma_tf32(c1, a_small, b[1][0].x, b[1][1].x);
  mma_tf32(c2, a_small, b[2][0].x, b[2][1].x);
  mma_tf32(c3, a_small, b[3][0].x, b[3][1].x);
  mma_tf32(c0, a_big, b[0][0].y, b[0][1].y);
  mma_tf32(c1, a_big, b[1][0].y, b[1][1].y);
  mma_tf32(c2, a_big, b[2][0].y, b[2][1].y);
  mma_tf32(c3, a_big, b[3][0].y, b[3][1].y);
  mma_tf32(c0, a_big, b[0][0].x, b[0][1].x);
  mma_tf32(c1, a_big, b[1][0].x, b[1][1].x);
  mma_tf32(c2, a_big, b[2][0].x, b[2][1].x);
  mma_tf32(c3, a_big, b[3][0].x, b[3][1].x);
}

// c (16x8) += a (16x16 bf16) b (16x8 bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The query tile of a warp as A fragments. float32: 4 k-steps of 8 channels,
// scaled, split into big and small. bfloat16: 2 k-steps of 16 channels, as
// they are (the scores are scaled after the product).
struct QFragF32 { uint32_t big[4][4], small[4][4]; };
struct QFragBf16 { uint32_t a[2][4]; };

__device__ __forceinline__ void load_q(QFragF32& f, const float* q_lo, const float* q_hi,
                                       bool lo_ok, bool hi_ok, int t, float scale) {
  #pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int col = kk * 8 + t;
    split_tf32(lo_ok ? q_lo[col] * scale : 0.f, f.big[kk][0], f.small[kk][0]);
    split_tf32(hi_ok ? q_hi[col] * scale : 0.f, f.big[kk][1], f.small[kk][1]);
    split_tf32(lo_ok ? q_lo[col + 4] * scale : 0.f, f.big[kk][2], f.small[kk][2]);
    split_tf32(hi_ok ? q_hi[col + 4] * scale : 0.f, f.big[kk][3], f.small[kk][3]);
  }
}

__device__ __forceinline__ void load_q(QFragBf16& f, const __nv_bfloat16* q_lo,
                                       const __nv_bfloat16* q_hi, bool lo_ok, bool hi_ok, int t,
                                       float) {
  #pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int col = kk * 16 + 2 * t;
    f.a[kk][0] = lo_ok ? *reinterpret_cast<const uint32_t*>(q_lo + col) : 0u;
    f.a[kk][1] = hi_ok ? *reinterpret_cast<const uint32_t*>(q_hi + col) : 0u;
    f.a[kk][2] = lo_ok ? *reinterpret_cast<const uint32_t*>(q_lo + col + 8) : 0u;
    f.a[kk][3] = hi_ok ? *reinterpret_cast<const uint32_t*>(q_hi + col + 8) : 0u;
  }
}

// s (16 rows x 32 keys, 4 column tiles) = q k^T for one step of keys
// kPitch: the float32 tile's row pitch in (big, small) pairs
template <int kPitch = kSplitKPitch>
__device__ __forceinline__ void scores(float (&s)[kJT][4], const QFragF32& q,
                                       const unsigned char* ks, int g, int t, float) {
  const uint2* k2 = reinterpret_cast<const uint2*>(ks);  // the split tile
  #pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint2 b[4][2];
    #pragma unroll
    for (int j = 0; j < kJT; ++j) {
      const uint2* row = k2 + (j * 8 + g) * kPitch + kk * 8 + t;  // key j*8+g, channels t, t+4
      b[j][0] = row[0];
      b[j][1] = row[4];
    }
    mma_3xtf32_x4(s[0], s[1], s[2], s[3], q.big[kk], q.small[kk], b);
  }
}

template <int kPitch = kSplitKPitch>  // the float32 overload's; unused here
__device__ __forceinline__ void scores(float (&s)[kJT][4], const QFragBf16& q,
                                       const unsigned char* ks, int, int, float scale) {
  const int lane = threadIdx.x & 31;
  #pragma unroll
  for (int j = 0; j < kJT; ++j) {
    // matrices: keys j*8 .. j*8+7 by channels 0-7, 8-15, 16-23, 24-31
    uint32_t b[4];
    ldmatrix_x4(b, ks + (j * 8 + (lane & 7)) * Pitch<__nv_bfloat16>::bytes + (lane >> 3) * 16);
    mma_bf16(s[j], q.a[0], b[0], b[1]);
    mma_bf16(s[j], q.a[1], b[2], b[3]);
  }
  #pragma unroll
  for (int j = 0; j < kJT; ++j)
    #pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale;
}

// o (16 rows x 32 channels, 4 column tiles) += p v for one step of keys
template <int kPitch = kSplitVPitch>
__device__ __forceinline__ void weighted_values(float (&o)[4][4], const float (&p)[kJT][4],
                                                const QFragF32&, const unsigned char* vs, int g,
                                                int t) {
  const uint2* v2 = reinterpret_cast<const uint2*>(vs);  // the split tile
  #pragma unroll
  for (int j = 0; j < kJT; ++j) {
    // k index t is key j*8+2t, k index t+4 is key j*8+2t+1: the accumulator's own columns
    uint32_t big[4], small[4];
    split_tf32(p[j][0], big[0], small[0]);
    split_tf32(p[j][2], big[1], small[1]);
    split_tf32(p[j][1], big[2], small[2]);
    split_tf32(p[j][3], big[3], small[3]);
    uint2 b[4][2];
    #pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint2* row = v2 + (j * 8 + 2 * t) * kPitch + nt * 8 + g;
      b[nt][0] = row[0];
      b[nt][1] = row[kPitch];
    }
    mma_3xtf32_x4(o[0], o[1], o[2], o[3], big, small, b);
  }
}

template <int kPitch = kSplitVPitch>  // the float32 overload's; unused here
__device__ __forceinline__ void weighted_values(float (&o)[4][4], const float (&p)[kJT][4],
                                                const QFragBf16&, const unsigned char* vs, int,
                                                int) {
  const int lane = threadIdx.x & 31;
  #pragma unroll
  for (int kk = 0; kk < kJT / 2; ++kk) {  // 16 keys: two column tiles of the scores
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    #pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      // matrices: keys 0-7 and 8-15 of the step by channels of tile 2*pair, then 2*pair+1
      uint32_t b[4];
      const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int channel = (2 * pair + (lane >> 4)) * 8;
      ldmatrix_x4_trans(b, vs + key * Pitch<__nv_bfloat16>::bytes + channel * 2);
      mma_bf16(o[2 * pair], a, b[0], b[1]);
      mma_bf16(o[2 * pair + 1], a, b[2], b[3]);
    }
  }
}

template <typename T> struct Frag;
template <> struct Frag<float> { using type = QFragF32; };
template <> struct Frag<__nv_bfloat16> { using type = QFragBf16; };

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

}  // namespace
