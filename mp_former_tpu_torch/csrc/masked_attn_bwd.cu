// Masked cross-attention, backward (K3 backward), for sm_90a.
//
// The gradient of csrc/masked_attn_fwd.cu. The TPU kernel it belongs to
// (mp_former_tpu/ops/fused_masked_attention.py:masked_attention) has no
// gradient of its own: the JAX package trains through the einsum form of
// mp_former_tpu/models/transformer_decoder/primitives.py:72-80, whose autodiff
// this kernel reproduces without writing the (Q, S) weights to device memory.
// Same result as masked_attention_backward_plain in
// mp_former_tpu_torch/ops/masked_attention_cuda.py; masked_attention_backward_
// tiled there repeats this kernel's arithmetic.
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
//   dq      (B, Q, H, D) in memory, in the input type
//   dk, dv  in the input type, (B, S, H, D) in memory, each row written once
//           (above 256 queries: float32, zeroed, the row blocks' shares added)
//
// What bounds it on the H100. Five products of 2 Q S D operations per head:
// at the training shape B = 8, H = 8, Q = 120, S = 4096 that is 10 GFLOP,
// 0.06 ms as 3xTF32 on the tensor cores (the forward's rule) against 76 MB of
// q, k, v, mask and gradients (0.02 ms). In bfloat16 the products take 0.01
// ms and the bytes bind. What bounds this design (tools/probe_torch_masked_
// attn_bound.py --backward --variants): no single part; at 8 warps an SM each
// 32-query step waits on its loads, three barriers and its chain of mma.sync.
//
// Design: the forward's tensor-core building blocks (masked_attn_common.cuh)
// with the roles of queries and keys exchanged.
// * A block owns a chunk of keys (whole 64-key tiles) of one (batch, head) and
//   up to 256 query rows; each of its 4 warps owns 16 keys of the tile, whose
//   k and v rows it keeps as A fragments in registers (float32: split into
//   TF32 big and small halves, k pre-scaled by log2(e) / sqrt(D)), and whose
//   dK and dV it accumulates in registers and writes once, without atomics.
// * The block walks the queries in tiles of 32 rows, key tile after key tile
//   in one pipeline: the tile's q, dO and O rows, its row statistics and its
//   mask bytes arrive by cp.async in a ring of 2 stages. The block then
//   computes each row's delta = dO . O (4 threads a row) and, in float32,
//   splits the q and dO tiles into (big, small) pairs once for all warps.
// * Per warp and tile, with the forward's products: S^T = K q^T and dP^T = V
//   dO^T (16 keys x 32 queries, mma.sync), P^T and dS^T on the accumulator
//   fragments (ex2 of the base-2 score less the row maximum, times 1 / sum;
//   dS 0 where the mask blocks or the key lies beyond S), dV += P^T dO and dK +=
//   dS^T q, with P^T and dS^T turned into A fragments in registers (bfloat16:
//   rounded to bfloat16 for these products, accumulated in float32).
// * dQ = dS K sums over keys. dS^T goes to shared memory (split, or as
//   bfloat16), and the 4 warps multiply the tile's dS (32 queries x 64 keys)
//   with the block's K tile (split once per key tile) on the tensor cores,
//   each warp 16 queries x 16 channels, into a per-block float32 dQ
//   accumulator in shared memory that no other warp touches. At the end the
//   block writes it once: straight to dq where one chunk holds all keys, else
//   into a per-chunk scratch that a second kernel sums in chunk order. dq is
//   therefore reproducible bit for bit. (dQ added by 16-byte atomics instead
//   reads within 4%: tools/probe_torch_masked_attn_bound.py --backward
//   --variants.)
// * The wrapper sizes the chunks so that the grid fills the card: at S = 256
//   and 64 (batch, head) pairs, 64 keys a block, 256 blocks.

#include "masked_attn_common.cuh"

namespace {

constexpr int kWarps = 4;                // each owns 16 keys of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 16 * kWarps;    // keys of a block's tile
constexpr int kNT = 8 / kWarps;          // 8-channel tiles of a warp's share of a tile's dQ
constexpr int kQT = kStep;               // queries of a tile: the products' 32-column step
constexpr int kMaxRows = 256;            // query rows of a block; more go to blockIdx.z
constexpr int kStages = 2;
constexpr int kMaskUnits = 5;            // 16-byte units per mask tile row: 64 bytes from any offset
constexpr int kMaskPitch = 16 * kMaskUnits;
constexpr int kSplitPitch = kSplitKPitch;  // pairs a row of the split q, dO and K tiles
constexpr int kDsPitch = kKeyTile + 4;     // float32 dS tile: pairs a query row
constexpr int kDsPitchBf16 = kKeyTile + 8; // bfloat16 dS tile: elements a query row (144 bytes)
constexpr int kDqPitch = kD + 4;           // floats a row of the dQ accumulator

// one stage: q, dO and O tiles (32 rows each), the rows' statistics, the mask tile
template <typename T> struct Stage {
  static constexpr int bytes = 3 * kQT * Pitch<T>::bytes + kQT * 8 + kQT * kMaskPitch;
};
// what a block holds besides the stages and the dQ accumulator: the split q and
// dO tiles (float32), the K tile (split, or as it is), the dS tile, the rows'
// (maximum, 1 / sum, delta, mask offset)
template <typename T> struct Rest;
template <> struct Rest<float> {
  static constexpr int bytes = 2 * kQT * kSplitPitch * 8 + kKeyTile * kSplitPitch * 8 +
                               kQT * kDsPitch * 8 + kQT * 16;
};
template <> struct Rest<__nv_bfloat16> {
  static constexpr int bytes = kKeyTile * Pitch<__nv_bfloat16>::bytes + kQT * kDsPitchBf16 * 2 +
                               kQT * 16;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* d_out;
  const uint8_t* mask;
  const float* stats;
  void* dq;     // (B, Q, H, D), input type
  float* part;  // (chunks, B*H, Q, D) scratch where chunks > 1
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr;
  long long o_sb, o_sh, o_sr, g_sb, g_sh, g_sr;
  long long mask_sb, mask_sh;
  int H, Q, S, chunk, chunks;
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

// 8 bytes global -> shared; `bytes` = 0 writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// 8 channels of a row in shared memory, as floats
__device__ __forceinline__ void load8(float (&r)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w; r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}
__device__ __forceinline__ void load8(float (&r)[8], const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  #pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    r[2 * e] = f.x;
    r[2 * e + 1] = f.y;
  }
}

// 16 rows x 32 channels of a float32 tile (pitch 144 bytes) -> (big, small)
// pairs, pitch kSplitPitch; the block's threads share the rows' 8 units each
__device__ __forceinline__ void split_tile(uint2* dst, const unsigned char* src, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += kThreads) {
    const int r = i / 8, unit = i % 8;
    const float4 x = *reinterpret_cast<const float4*>(src + r * Pitch<float>::bytes + unit * 16);
    uint4 lo, hi;
    split_tf32(x.x, lo.x, lo.y);
    split_tf32(x.y, lo.z, lo.w);
    split_tf32(x.z, hi.x, hi.y);
    split_tf32(x.w, hi.z, hi.w);
    uint2* d = dst + r * kSplitPitch + unit * 4;
    *reinterpret_cast<uint4*>(d) = lo;
    *reinterpret_cast<uint4*>(d + 2) = hi;
  }
}

// dQ of a tile, float32: the warp's 16 queries (m_tile) x kNT channel tiles
// from n_first = dS (split pairs, [query][key]) x K (split pairs,
// [key][channel]) over the tile's keys, 3xTF32
__device__ __forceinline__ void tile_dq(float (&acc)[kNT][4], const uint2* ds, const uint2* ks,
                                        int m_tile, int n_first, int g, int t) {
  #pragma unroll
  for (int kk = 0; kk < kKeyTile / 8; ++kk) {
    const uint2* a_lo = ds + (m_tile * 16 + g) * kDsPitch + kk * 8 + t;
    const uint2* a_hi = a_lo + 8 * kDsPitch;
    const uint2 a0 = a_lo[0], a1 = a_hi[0], a2 = a_lo[4], a3 = a_hi[4];
    const uint32_t big[4] = {a0.x, a1.x, a2.x, a3.x};
    const uint32_t small[4] = {a0.y, a1.y, a2.y, a3.y};
    uint2 b[kNT][2];
    #pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const uint2* row = ks + (kk * 8 + t) * kSplitPitch + (n_first + n) * 8 + g;
      b[n][0] = row[0];
      b[n][1] = row[4 * kSplitPitch];
    }
    #pragma unroll
    for (int n = 0; n < kNT; ++n) mma_tf32(acc[n], small, b[n][0].x, b[n][1].x);
    #pragma unroll
    for (int n = 0; n < kNT; ++n) mma_tf32(acc[n], big, b[n][0].y, b[n][1].y);
    #pragma unroll
    for (int n = 0; n < kNT; ++n) mma_tf32(acc[n], big, b[n][0].x, b[n][1].x);
  }
}

// the same in bfloat16: dS as bfloat16 [query][key], K as it is [key][channel]
__device__ __forceinline__ void tile_dq(float (&acc)[kNT][4], const __nv_bfloat16* ds,
                                        const unsigned char* ks, int m_tile, int n_first, int,
                                        int) {
  const int lane = threadIdx.x & 31;
  #pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, ds + (m_tile * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kDsPitchBf16 +
                       kk * 16 + (lane >> 4) * 8);
    // two channel tiles from the pair that holds n_first
    uint32_t b[4];
    const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int channel = ((n_first & ~1) + (lane >> 4)) * 8;
    ldmatrix_x4_trans(b, ks + key * Pitch<__nv_bfloat16>::bytes + channel * 2);
    #pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int which = (n_first + n) & 1;
      mma_bf16(acc[n], a, b[2 * which], b[2 * which + 1]);
    }
  }
}

__device__ __forceinline__ void put_ds(uint2* ds, int q, int key, float x) {
  uint2 pair;
  split_tf32(x, pair.x, pair.y);
  ds[q * kDsPitch + key] = pair;
}
__device__ __forceinline__ void put_ds(__nv_bfloat16* ds, int q, int key, float x) {
  ds[q * kDsPitchBf16 + key] = __float2bfloat16(x);
}

template <typename T> struct DsType;
template <> struct DsType<float> { using type = uint2; };
template <> struct DsType<__nv_bfloat16> { using type = __nv_bfloat16; };

// grid (chunks, B * H, ceil(Q / 256)), block 128 threads
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
masked_attn_bwd_keys(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = Pitch<T>::bytes;
  constexpr int kUnits = kD * (int)sizeof(T) / 16;  // 16-byte units a row
  constexpr int kStage = Stage<T>::bytes;
  constexpr bool kSingle = sizeof(T) == 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int row0 = blockIdx.z * kMaxRows;
  const int row_end = min(p.Q, row0 + kMaxRows);
  const int qtiles = (row_end - row0 + kQT - 1) / kQT;
  const int s_begin = c * p.chunk;
  const int s_end = min(p.S, s_begin + p.chunk);
  const int ktiles = (s_end - s_begin + kKeyTile - 1) / kKeyTile;
  const int items = ktiles * qtiles;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* ob = static_cast<const T*>(p.out) + b * p.o_sb + h * p.o_sh;
  const T* gb = static_cast<const T*>(p.d_out) + b * p.g_sb + h * p.g_sh;
  const uint8_t* mb = p.mask + b * p.mask_sb + h * p.mask_sh;
  const float* stats = p.stats + (long long)bh * p.Q * 2;

  // the block's shared memory: stages, then the rest, then the dQ accumulator
  unsigned char* rest = smem + kStages * kStage;
  uint2* q_split = reinterpret_cast<uint2*>(rest);      // float32 only
  uint2* g_split = q_split + kQT * kSplitPitch;
  unsigned char* k_tile = kSingle ? reinterpret_cast<unsigned char*>(g_split + kQT * kSplitPitch)
                                  : rest;
  using DS = typename DsType<T>::type;
  DS* ds_tile = reinterpret_cast<DS*>(k_tile + (kSingle ? kKeyTile * kSplitPitch * 8
                                                        : kKeyTile * kPitch));
  float4* row_data = reinterpret_cast<float4*>(
      reinterpret_cast<unsigned char*>(ds_tile) +
      (kSingle ? kQT * kDsPitch * 8 : kQT * kDsPitchBf16 * 2));
  float* dq_acc = reinterpret_cast<float*>(smem + kStages * kStage + Rest<T>::bytes);

  for (int i = tid; i < (row_end - row0) * kDqPitch; i += kThreads) dq_acc[i] = 0.f;

  auto load_stage = [&](int it) {
    const int kt = it / qtiles, qt = it % qtiles;
    unsigned char* st = smem + (it % kStages) * kStage;
    unsigned char* ss = st + 3 * kQT * kPitch;
    unsigned char* ms = ss + kQT * 8;
    const int q0 = row0 + qt * kQT, nq = min(kQT, row_end - q0);
    const int key0 = s_begin + kt * kKeyTile, nk = min(kKeyTile, s_end - key0);
    for (int i = tid; i < 3 * kQT * kUnits; i += kThreads) {
      const int which = i / (kQT * kUnits), r = (i / kUnits) % kQT, u = i % kUnits;
      const long long row = q0 + min(r, nq - 1);
      const T* src = which == 0 ? qb + row * p.q_sr : which == 1 ? gb + row * p.g_sr
                                                                 : ob + row * p.o_sr;
      cp_async16(st + (which * kQT + r) * kPitch + u * 16,
                 reinterpret_cast<const unsigned char*>(src) + u * 16, r < nq ? 16 : 0);
    }
    if (tid < kQT)
      cp_async8(ss + tid * 8, stats + 2LL * (q0 + min(tid, nq - 1)), tid < nq ? 8 : 0);
    for (int i = tid; i < nq * kMaskUnits; i += kThreads) {
      const int r = i / kMaskUnits, u = i % kMaskUnits;
      const uint8_t* first = mb + (long long)(q0 + r) * p.S + key0;
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(first) & ~(uintptr_t)15) +
          u * 16;
      // every unit copied holds at least one byte of the row: never off the tensor's pages
      if (src < first + nk) cp_async16(ms + r * kMaskPitch + u * 16, src, 16);
    }
  };

  load_stage(0);
  cp_async_commit();

  typename Frag<T>::type kf, vf;  // this warp's 16 keys as A fragments
  float dk[4][4], dv[4][4];
  int key_lo = 0;
  bool lo_ok = false, hi_ok = false;

  for (int it = 0; it < items; ++it) {
    const int kt = it / qtiles, qt = it % qtiles;
    const int key0 = s_begin + kt * kKeyTile;
    if (qt == 0) {  // a new key tile: fragments, accumulators and the block's K tile
      if (it > 0) __syncthreads();  // the last tile's dQ products are done with k_tile
      key_lo = key0 + warp * 16 + g;
      lo_ok = key_lo < s_end;
      hi_ok = key_lo + 8 < s_end;
      load_q(kf, kb + (long long)key_lo * p.k_sr, kb + (long long)(key_lo + 8) * p.k_sr, lo_ok,
             hi_ok, t, p.scale_log2);
      load_q(vf, vb + (long long)key_lo * p.v_sr, vb + (long long)(key_lo + 8) * p.v_sr, lo_ok,
             hi_ok, t, 1.f);
      #pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
      const int nk = min(kKeyTile, s_end - key0);
      for (int i = tid; i < kKeyTile * kUnits; i += kThreads) {
        const int r = i / kUnits, u = i % kUnits;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (r < nk)
          x = __ldg(reinterpret_cast<const uint4*>(kb + (long long)(key0 + r) * p.k_sr) + u);
        if constexpr (kSingle) {
          uint4 lo, hi;
          split_tf32(__uint_as_float(x.x), lo.x, lo.y);
          split_tf32(__uint_as_float(x.y), lo.z, lo.w);
          split_tf32(__uint_as_float(x.z), hi.x, hi.y);
          split_tf32(__uint_as_float(x.w), hi.z, hi.w);
          uint2* d = reinterpret_cast<uint2*>(k_tile) + r * kSplitPitch + u * 4;
          *reinterpret_cast<uint4*>(d) = lo;
          *reinterpret_cast<uint4*>(d + 2) = hi;
        } else {
          *reinterpret_cast<uint4*>(k_tile + r * kPitch + u * 16) = x;
        }
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // stage `it` has landed for all; the other stage is free
    if (it + 1 < items) load_stage(it + 1);
    cp_async_commit();

    const unsigned char* st = smem + (it % kStages) * kStage;
    const unsigned char* q_raw = st;
    const unsigned char* g_raw = st + kQT * kPitch;
    const unsigned char* o_raw = st + 2 * kQT * kPitch;
    const float2* st_rows = reinterpret_cast<const float2*>(st + 3 * kQT * kPitch);
    const unsigned char* ms = st + 3 * kQT * kPitch + kQT * 8;
    const int q0 = row0 + qt * kQT, nq = min(kQT, row_end - q0);
    if (tid < 4 * kQT) {  // each row's (maximum, 1 / sum, delta = dO . O, mask offset): 4 threads a row
      const int r = tid >> 2, part = tid & 3;
      float o8[8], g8[8];
      load8(o8, reinterpret_cast<const T*>(o_raw + r * kPitch) + part * 8);
      load8(g8, reinterpret_cast<const T*>(g_raw + r * kPitch) + part * 8);
      float x = 0.f;
      #pragma unroll
      for (int e = 0; e < 8; ++e) x = fmaf(o8[e], g8[e], x);
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      if (part == 0) {
        // a row beyond Q weighs nothing: 1 / sum = 0
        const float2 sr = st_rows[r];
        const int off = (int)(reinterpret_cast<uintptr_t>(mb + (long long)(q0 + r) * p.S +
                                                          s_begin) & 15);
        row_data[r] = r < nq ? make_float4(sr.x, 1.f / sr.y, x, __int_as_float(off))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if constexpr (kSingle) {
      split_tile(q_split, q_raw, kQT);
      split_tile(g_split, g_raw, kQT);
    }
    __syncthreads();
    const unsigned char* q_tile = kSingle ? reinterpret_cast<const unsigned char*>(q_split) : q_raw;
    const unsigned char* g_tile = kSingle ? reinterpret_cast<const unsigned char*>(g_split) : g_raw;

    // S^T and dP^T: 16 keys (rows g, g + 8) x 32 queries (columns j * 8 + 2t, + 1)
    float s[kJT][4], dp[kJT][4];
    #pragma unroll
    for (int j = 0; j < kJT; ++j)
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    scores<kSplitPitch>(s, kf, q_tile, g, t, p.scale_log2);
    scores<kSplitPitch>(dp, vf, g_tile, g, t, 1.f);

    const int key_local = warp * 16 + g;  // within the tile; + 8 for the high row
    #pragma unroll
    for (int j = 0; j < kJT; ++j) {
      #pragma unroll
      for (int col = 0; col < 2; ++col) {
        const int r = j * 8 + 2 * t + col;
        const float4 rd = row_data[r];
        const unsigned char* mrow = ms + r * kMaskPitch + __float_as_int(rd.w) + key_local;
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half + col;
          const bool blocked = mrow[8 * half] != 0;
          const bool ok = half ? hi_ok : lo_ok;
          const float pw = ok ? ex2((blocked ? kMasked : s[j][e]) - rd.x) * rd.y : 0.f;
          s[j][e] = pw;
          dp[j][e] = (ok && !blocked) ? pw * (dp[j][e] - rd.z) : 0.f;
          put_ds(ds_tile, r, key_local + 8 * half, dp[j][e]);
        }
      }
    }
    // dV += P^T dO, dK += dS^T q (scaled by 1 / sqrt(D) at the store)
    weighted_values<kSplitPitch>(dv, s, kf, g_tile, g, t);
    weighted_values<kSplitPitch>(dk, dp, kf, q_tile, g, t);
    __syncthreads();  // the tile's dS is in shared memory

    {  // dQ of the tile over this key tile: warp -> 16 queries x 8 kNT channels
      const int m_tile = warp & 1, n_first = (warp >> 1) * kNT;
      float acc[kNT][4];
      #pragma unroll
      for (int n = 0; n < kNT; ++n)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      if constexpr (kSingle)
        tile_dq(acc, ds_tile, reinterpret_cast<const uint2*>(k_tile), m_tile, n_first, g, t);
      else
        tile_dq(acc, ds_tile, k_tile, m_tile, n_first, g, t);
      const int r_lo = qt * kQT + m_tile * 16 + g;
      #pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float* lo = dq_acc + r_lo * kDqPitch + (n_first + n) * 8 + 2 * t;
        float* hi = lo + 8 * kDqPitch;
        // rows beyond Q exist in the accumulator only up to a tile's end: skip them
        if (r_lo < row_end - row0) { lo[0] += acc[n][0]; lo[1] += acc[n][1]; }
        if (r_lo + 8 < row_end - row0) { hi[0] += acc[n][2]; hi[1] += acc[n][3]; }
      }
    }

    if (qt == qtiles - 1) {  // the key tile is done: its dK and dV rows, (B, S, H, D)
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? hi_ok : lo_ok)) continue;
        const long long row = ((long long)b * p.S + key_lo + 8 * half) * p.H + h;
        #pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nt * 8 + 2 * t;
          const float2 k2 = make_float2(dk[nt][2 * half] * p.scale, dk[nt][2 * half + 1] * p.scale);
          const float2 v2 = make_float2(dv[nt][2 * half], dv[nt][2 * half + 1]);
          if (gridDim.z == 1) {
            store2(static_cast<T*>(p.dk) + row * kD + col, k2.x, k2.y);
            store2(static_cast<T*>(p.dv) + row * kD + col, v2.x, v2.y);
          } else {  // more than 256 queries: the row blocks' shares added in float32
            atomicAdd(reinterpret_cast<float2*>(static_cast<float*>(p.dk) + row * kD + col), k2);
            atomicAdd(reinterpret_cast<float2*>(static_cast<float*>(p.dv) + row * kD + col), v2);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's dQ, once: 8 threads a row, 4 channels each
  for (int i = tid; i < (row_end - row0) * 8; i += kThreads) {
    const int r = i / 8, u = i % 8;
    const float4 a = *reinterpret_cast<const float4*>(dq_acc + r * kDqPitch + u * 4);
    const long long q = row0 + r;
    if (p.chunks == 1) {
      T* dst = static_cast<T*>(p.dq) + ((b * p.Q + q) * p.H + h) * kD + u * 4;
      store2(dst, a.x * p.scale, a.y * p.scale);
      store2(dst + 2, a.z * p.scale, a.w * p.scale);
    } else {
      float* dst = p.part + (((long long)c * gridDim.y + bh) * p.Q + q) * kD + u * 4;
      *reinterpret_cast<float4*>(dst) = a;
    }
  }
}

// dq = (sum over the chunks in order) / sqrt(D): a thread a (b, q, h, 4 channels)
template <typename T>
__global__ void __launch_bounds__(256)
masked_attn_bwd_merge(const Params p, int B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long units = (long long)B * p.Q * p.H * 8;
  if (i >= units) return;
  const int u = (int)(i % 8);
  const long long row = i / 8;  // (b * Q + q) * H + h
  const int h = (int)(row % p.H);
  const long long bq = row / p.H;
  const int q = (int)(bq % p.Q), b = (int)(bq / p.Q);
  const long long bh = (long long)b * p.H + h;
  const long long stride = (long long)B * p.H * p.Q * kD;  // one chunk
  const float* src = p.part + (bh * p.Q + q) * kD + u * 4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < p.chunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(src + c * stride);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
  }
  T* dst = static_cast<T*>(p.dq) + row * kD + u * 4;
  store2(dst, a.x * p.scale, a.y * p.scale);
  store2(dst + 2, a.z * p.scale, a.w * p.scale);
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int BH = B * p.H;
  if (BH == 0 || p.Q == 0) return cudaSuccess;
  const int zsplits = (p.Q + kMaxRows - 1) / kMaxRows;
  if (BH > 65535 || zsplits > 65535) return cudaErrorInvalidConfiguration;
  const int rows = min(p.Q, kMaxRows);
  const int smem = kStages * Stage<T>::bytes + Rest<T>::bytes +
                   ((rows + kQT - 1) / kQT * kQT) * kDqPitch * 4;
  constexpr int kMaxSmem = kStages * Stage<T>::bytes + Rest<T>::bytes + kMaxRows * kDqPitch * 4;
  static bool asked[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || !asked[device]) {
    err = cudaFuncSetAttribute(masked_attn_bwd_keys<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) asked[device] = true;
  }
  const dim3 grid(p.chunks, BH, zsplits);
  masked_attn_bwd_keys<T><<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.chunks == 1) return err;
  const long long units = (long long)B * p.Q * p.H * 8;
  masked_attn_bwd_merge<T><<<(unsigned)((units + 255) / 256), 256, 0, stream>>>(p, B);
  return cudaGetLastError();
}

}  // namespace

// The 15 strides are in elements: (batch, head, row) of q, k, v, out and
// d_out. chunk: keys a block walks, a positive multiple of 64. part: float32
// scratch of chunks * B * H * Q * D floats (chunks = ceil(S / chunk)),
// required when chunks > 1 and unused when chunks is 1. dq: B * Q * H * D
// elements of the input type. dk, dv: B * S * H * D elements of the input
// type; above 256 queries float32, zeroed by the caller, which casts them.
// dtype: 0 = float32, 1 = bfloat16. Returns the first failing launch's
// cudaError_t (0 = cudaSuccess); the launches are asynchronous on `stream`.
extern "C" int masked_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                               const void* d_out, const void* mask, const void* stats,
                               void* part, void* dq, void* dk, void* dv,
                               int B, int H, int Q, int S, int D,
                               long long q_sb, long long q_sh, long long q_sr,
                               long long k_sb, long long k_sh, long long k_sr,
                               long long v_sb, long long v_sh, long long v_sr,
                               long long o_sb, long long o_sh, long long o_sr,
                               long long g_sb, long long g_sh, long long g_sr,
                               long long mask_sb, long long mask_sh, int chunk, int dtype,
                               void* stream) {
  if (D != kD || S <= 0 || chunk <= 0 || chunk % 64 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.d_out = d_out;
  p.mask = static_cast<const uint8_t*>(mask);
  p.stats = static_cast<const float*>(stats);
  p.part = static_cast<float*>(part);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sr = q_sr;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sr = k_sr;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sr = v_sr;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sr = o_sr;
  p.g_sb = g_sb; p.g_sh = g_sh; p.g_sr = g_sr;
  p.mask_sb = mask_sb; p.mask_sh = mask_sh;
  p.H = H; p.Q = Q; p.S = S; p.chunk = chunk;
  p.chunks = (S + chunk - 1) / chunk;
  if (p.chunks > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  p.scale = 1.f / sqrtf((float)kD);
  p.scale_log2 = kLog2e * p.scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
