// Masked cross-attention, forward (K3), for sm_90a.
//
// Replaces the TPU kernel mp_former_tpu/ops/fused_masked_attention.py:
// masked_attention (body `_kernel`). Computes, without writing the (Q, S)
// scores to device memory,
//
//   out = softmax(q k^T / sqrt(D), masked logits set to -1e9) v
//
//   q, out  logical (B, H, Q, D)     k, v  logical (B, H, S, D)     D = 32,
//           float32 or bfloat16, each with its own batch, head and row stride
//           in elements (the last dimension is contiguous, every row starts on
//           a 16-byte boundary): the (B, N, H, D) projection of the decoder is
//           read where it lies, and out is written in that order too
//   mask    1 byte per entry, 1 = blocked, at mask[b * mask_sb + h * mask_sh +
//           q * S + s]: (B, Q, S) shared by all heads (mask_sh = 0) or
//           (B, H, Q, S), contiguous, any alignment
//
// A masked logit is exactly -1e9 (not -inf), as in the plain version
// (mp_former_tpu_torch/ops/masked_attention_cuda.py:masked_attention_plain):
// a row whose keys are all masked is a uniform average of v, not NaN. The
// kernel keeps its scores in the base-2 domain (q is scaled by log2(e) /
// sqrt(D), a masked score is -1e9 * log2(e), the exponential is ex2), which
// is the same function.
//
// What bounds it on the H100. The decoder has few queries (Q = 100) and long
// key sequences (S = 850, 3400, 13600 at an 800x1088 canvas, none a multiple
// of a tile). At S = 13600 K, V and the shared mask are 29 MB (9 us at 3.35
// TB/s) and the two products 1.4 GFLOP: 21 us on the fp32 CUDA cores, which
// is what bounded the first design (one thread a query row, scalar FMAs with
// a shared-memory operand each, loads not overlapped, a serial merge). On the
// tensor cores the products are 3 x 1.4 GFLOP of TF32 (see below), 8.5 us at
// 495 TFLOP/s, or 1.4 GFLOP of bf16: the kernel is then bound by the issue of
// everything around the products (operand splits, mask bytes, exponentials),
// and at S = 850 by the launch and by how many SMs 8 heads can fill.
//
// Design.
// * A warp owns a 16-row query tile (Q = 100 is 7 tiles) and a block up to 8
//   of them; all warps of a block share the 64-key tiles of K, V and mask in
//   shared memory. Both products are mma.sync, the scores stay in the
//   accumulator fragments and the online softmax (row maximum and sum by quad
//   shuffles, fp32) runs on them, as in FlashAttention-2, in steps of 32 keys
//   (half a tile: 16 score registers a lane instead of 32). MMAs that follow
//   each other go to different accumulators, so none waits for the last.
// * bfloat16: m16n8k16 with fp32 accumulation; K by ldmatrix, V by
//   ldmatrix.trans; the score fragment, packed to bf16, is the A fragment of
//   the second product.
// * float32: 3xTF32. Plain TF32 keeps 10 bits of mantissa (1e-3 on the
//   logits). Each operand is split into big = tf32(x) and small = tf32(x -
//   big), and m16n8k8 accumulates small*big + big*small, then big*big, in
//   fp32: only the small*small term (2^-22 relative) is left out. The split
//   (two conversions and a subtraction an element) was a third of the time
//   when every warp did it for itself: the block splits each K and V tile
//   once, into (big, small) pairs in shared memory. ldmatrix does not serve
//   32-bit elements: a fragment entry is one 8-byte load of a pair, with row
//   pitches (36 pairs for K, 34 for V) that keep both products free of bank
//   conflicts.
//   The accumulator holds columns (2t, 2t+1) of a row where the next A
//   fragment wants (t, t+4): V's rows are taken in that order as the k index,
//   which costs nothing.
// * K, V and mask tiles arrive by 16-byte cp.async into a ring of 2 stages,
//   so a tile's latency hides behind the products of the one before it (a
//   third stage gains nothing and, in float32, costs an SM its second block).
//   Rows beyond the ragged end of S are zero-filled (a padded key scores -inf and
//   weighs 0, and 0 x garbage could be NaN). A mask row starts at any byte:
//   the tile row is copied from the 16-byte boundary below its first byte, 5
//   units instead of 4, and read back from its offset.
// * The keys are split into chunks across blocks so that the grid fills the
//   card (the wrapper chooses the chunk from S, the heads and the SM count).
//   One chunk writes out directly. Otherwise each block writes its (max, sum,
//   accumulator) and a second kernel, a warp a row, merges them: the lanes
//   take the chunks' maxima and sums in parallel, then a channel each with all
//   loads independent. A chunk whose keys are all masked has maximum -1e9 and
//   weighs 0 unless every chunk is so, and then the row is the mean of v.

#include "masked_attn_common.cuh"

namespace {

constexpr int kKT = 64;         // keys per shared-memory tile
constexpr int kMaxWarps = 8;    // 16-row query tiles per block
constexpr int kStages = 2;      // ring of tiles in flight
constexpr int kMaskUnits = 5;   // 16-byte units per mask tile row: 64 bytes from any offset
constexpr int kMaskPitch = 16 * kMaskUnits;

// one stage of the ring: a K tile, a V tile and the block's mask tile
template <typename T> struct Stage {
  static constexpr int bytes = 2 * kKT * Pitch<T>::bytes + 16 * kMaxWarps * kMaskPitch;
};

// float32 only: a tile's K and V as (big, small) TF32 pairs, split once by the
// whole block instead of by each of its warps.
template <typename T> struct Split { static constexpr int bytes = 0; };
template <> struct Split<float> {
  static constexpr int bytes = kKT * (kSplitKPitch + kSplitVPitch) * 8;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  void* out;
  float* part;  // (B*H, chunks, Q, D) accumulators, then (B*H, chunks, Q) maxima, then sums
  float* stats;  // (B*H, Q, 2): each row's maximum (base 2) and sum, for the backward; or null
  float* out32;  // bfloat16 with stats: out in float32, before its rounding, for the backward
  long long q_sb, q_sh, q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, o_sb, o_sh, o_sr;
  long long mask_sb, mask_sh;
  int H, Q, S, chunk, chunks;
  float scale_log2;  // log2(e) / sqrt(D)
};

// grid (chunks, B * H, ceil(Q / 128)), block 32 * min(8, ceil(Q / 16)) threads.
// kStats: also write each row's maximum and sum (p.stats) and, in bfloat16, out
// before its rounding (p.out32), for the backward; a template parameter, so that the serving instantiation carries none of it
// (as a run-time branch on p.stats it cost the forward 5-25% on an H100).
template <typename T, bool kStats>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
masked_attn_tiles(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = Pitch<T>::bytes;
  constexpr int kUnitsPerRow = kD * (int)sizeof(T) / 16;
  constexpr int kStage = Stage<T>::bytes;

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.z * (kMaxWarps * 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows_here = min(p.Q - q0, (int)(blockDim.x >> 5) * 16);
  const int s_begin = c * p.chunk;
  const int s_end = min(p.S, s_begin + p.chunk);
  const int tiles = (s_end - s_begin + kKT - 1) / kKT;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* mb = p.mask + b * p.mask_sb + h * p.mask_sh + (long long)q0 * p.S;

  auto load_tile = [&](int tile) {
    unsigned char* ks = smem + (tile % kStages) * kStage;
    unsigned char* vs = ks + kKT * kPitch;
    unsigned char* ms = vs + kKT * kPitch;
    const int t0 = s_begin + tile * kKT;
    const int n = min(kKT, s_end - t0);
    for (int i = threadIdx.x; i < kKT * kUnitsPerRow; i += blockDim.x) {
      const int r = i / kUnitsPerRow, u = i % kUnitsPerRow;
      const long long key = t0 + min(r, n - 1);
      const int bytes = r < n ? 16 : 0;
      cp_async16(ks + r * kPitch + u * 16,
                 reinterpret_cast<const unsigned char*>(kb + key * p.k_sr) + u * 16, bytes);
      cp_async16(vs + r * kPitch + u * 16,
                 reinterpret_cast<const unsigned char*>(vb + key * p.v_sr) + u * 16, bytes);
    }
    for (int i = threadIdx.x; i < rows_here * kMaskUnits; i += blockDim.x) {
      const int r = i / kMaskUnits, u = i % kMaskUnits;
      const uint8_t* first = mb + (long long)r * p.S + t0;  // the row's first byte of the tile
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(first) & ~(uintptr_t)15) +
          u * 16;
      // every unit copied holds at least one byte of the row: never off the tensor's pages
      if (src < first + n) cp_async16(ms + r * kMaskPitch + u * 16, src, 16);
    }
  };

  #pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s);
    cp_async_commit();
  }

  // rows g and g + 8 of the warp's query tile
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const bool warp_active = q0 + warp * 16 < p.Q;
  const bool lo_ok = row_lo < p.Q, hi_ok = row_hi < p.Q;
  typename Frag<T>::type qf;
  float o[4][4];
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;
  int off_lo = 0, off_hi = 0;  // where a mask row starts in its 16-byte unit
  if (warp_active) {
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    load_q(qf, qb + row_lo * p.q_sr, qb + row_hi * p.q_sr, lo_ok, hi_ok, t, p.scale_log2);
    #pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      #pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    // chunk is a multiple of 64, so the offset is the same in every tile
    off_lo = (int)(reinterpret_cast<uintptr_t>(mb + (long long)(warp * 16 + g) * p.S + s_begin) & 15);
    off_hi = (int)(reinterpret_cast<uintptr_t>(mb + (long long)(warp * 16 + g + 8) * p.S + s_begin) & 15);
  }

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the tile has landed for all, and the stage refilled below is free
    if (tile + kStages - 1 < tiles) load_tile(tile + kStages - 1);
    cp_async_commit();

    // what the products read, and the bytes of a row there
    const unsigned char* ks = smem + (tile % kStages) * kStage;
    const unsigned char* vs = ks + kKT * kPitch;
    const unsigned char* ms = vs + kKT * kPitch;
    int k_row = kPitch, v_row = kPitch;
    if constexpr (sizeof(T) == 4) {
      // float32: the block splits the tile's K and V into (big, small) pairs once
      uint2* split_k = reinterpret_cast<uint2*>(smem + kStages * kStage);
      uint2* split_v = split_k + kKT * kSplitKPitch;
      for (int i = threadIdx.x; i < 2 * kKT * 8; i += blockDim.x) {
        const int is_v = i / (kKT * 8), r = (i / 8) % kKT, unit = i % 8;
        // the V tile follows the K tile in the stage
        const float4 x =
            *reinterpret_cast<const float4*>(ks + (is_v * kKT + r) * kPitch + unit * 16);
        uint4 lo, hi;
        split_tf32(x.x, lo.x, lo.y);
        split_tf32(x.y, lo.z, lo.w);
        split_tf32(x.z, hi.x, hi.y);
        split_tf32(x.w, hi.z, hi.w);
        uint2* dst = (is_v ? split_v + r * kSplitVPitch : split_k + r * kSplitKPitch) + unit * 4;
        *reinterpret_cast<uint4*>(dst) = lo;
        *reinterpret_cast<uint4*>(dst + 2) = hi;
      }
      __syncthreads();  // the next tile's split waits at the barrier above
      ks = reinterpret_cast<const unsigned char*>(split_k);
      vs = reinterpret_cast<const unsigned char*>(split_v);
      k_row = kSplitKPitch * 8;
      v_row = kSplitVPitch * 8;
    }
    if (!warp_active) continue;
    const int n_tile = min(kKT, s_end - (s_begin + tile * kKT));

    #pragma unroll 1
    for (int first = 0; first < n_tile; first += kStep) {  // a step of 32 keys
      const int n = min(kStep, n_tile - first);
      float s[kJT][4];
      #pragma unroll
      for (int j = 0; j < kJT; ++j)
        #pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      scores(s, qf, ks + first * k_row, g, t, p.scale_log2);

      // masked keys score exactly -1e9 (base 2); rows beyond Q read whatever the
      // stage holds, which is harmless: their scores stay finite and are not stored
      const unsigned char* mrow_lo = ms + (warp * 16 + g) * kMaskPitch + off_lo + first + 2 * t;
      const unsigned char* mrow_hi =
          ms + (warp * 16 + g + 8) * kMaskPitch + off_hi + first + 2 * t;
      #pragma unroll
      for (int j = 0; j < kJT; ++j) {
        if (mrow_lo[j * 8]) s[j][0] = kMasked;
        if (mrow_lo[j * 8 + 1]) s[j][1] = kMasked;
        if (mrow_hi[j * 8]) s[j][2] = kMasked;
        if (mrow_hi[j * 8 + 1]) s[j][3] = kMasked;
      }
      if (n < kStep) {  // keys beyond the end of S: -inf, weight 0
        #pragma unroll
        for (int j = 0; j < kJT; ++j) {
          const int key = j * 8 + 2 * t;
          if (key >= n) s[j][0] = s[j][2] = -INFINITY;
          if (key + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
        }
      }

      float max_lo = -INFINITY, max_hi = -INFINITY;
      #pragma unroll
      for (int j = 0; j < kJT; ++j) {
        max_lo = fmaxf(max_lo, fmaxf(s[j][0], s[j][1]));
        max_hi = fmaxf(max_hi, fmaxf(s[j][2], s[j][3]));
      }
      max_lo = fmaxf(max_lo, __shfl_xor_sync(kFull, max_lo, 1));
      max_lo = fmaxf(max_lo, __shfl_xor_sync(kFull, max_lo, 2));
      max_hi = fmaxf(max_hi, __shfl_xor_sync(kFull, max_hi, 1));
      max_hi = fmaxf(max_hi, __shfl_xor_sync(kFull, max_hi, 2));
      const float new_lo = fmaxf(m_lo, max_lo), new_hi = fmaxf(m_hi, max_hi);
      const float alpha_lo = ex2(m_lo - new_lo), alpha_hi = ex2(m_hi - new_hi);
      m_lo = new_lo;
      m_hi = new_hi;
      l_lo *= alpha_lo;  // a lane's share of the row sum; the quad is summed at the end
      l_hi *= alpha_hi;
      #pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        o[nt][0] *= alpha_lo;
        o[nt][1] *= alpha_lo;
        o[nt][2] *= alpha_hi;
        o[nt][3] *= alpha_hi;
      }
      #pragma unroll
      for (int j = 0; j < kJT; ++j) {
        s[j][0] = ex2(s[j][0] - new_lo);
        s[j][1] = ex2(s[j][1] - new_lo);
        s[j][2] = ex2(s[j][2] - new_hi);
        s[j][3] = ex2(s[j][3] - new_hi);
        l_lo += s[j][0] + s[j][1];
        l_hi += s[j][2] + s[j][3];
      }
      weighted_values(o, s, qf, vs + first * v_row, g, t);
    }
  }
  cp_async_wait<0>();
  if (!warp_active) return;

  l_lo += __shfl_xor_sync(kFull, l_lo, 1);
  l_lo += __shfl_xor_sync(kFull, l_lo, 2);
  l_hi += __shfl_xor_sync(kFull, l_hi, 1);
  l_hi += __shfl_xor_sync(kFull, l_hi, 2);

  if (p.chunks == 1) {  // every key seen: normalise and write out where it belongs
    T* ob = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;  // a row's largest weight is 1
    #pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (lo_ok) store2(ob + row_lo * p.o_sr + col, o[nt][0] * inv_lo, o[nt][1] * inv_lo);
      if (hi_ok) store2(ob + row_hi * p.o_sr + col, o[nt][2] * inv_hi, o[nt][3] * inv_hi);
      if constexpr (kStats && sizeof(T) == 2) {  // float32 out is its own copy
        float* o32 = p.out32 + b * p.o_sb + h * p.o_sh;
        if (lo_ok) store2(o32 + row_lo * p.o_sr + col, o[nt][0] * inv_lo, o[nt][1] * inv_lo);
        if (hi_ok) store2(o32 + row_hi * p.o_sr + col, o[nt][2] * inv_hi, o[nt][3] * inv_hi);
      }
    }
    if constexpr (kStats) {
      if (t == 0) {
        float2* st = reinterpret_cast<float2*>(p.stats) + (long long)bh * p.Q;
        if (lo_ok) st[row_lo] = make_float2(m_lo, l_lo);
        if (hi_ok) st[row_hi] = make_float2(m_hi, l_hi);
      }
    }
    return;
  }
  const long long rows = (long long)gridDim.y * p.chunks * p.Q;
  const long long base = ((long long)bh * p.chunks + c) * p.Q;
  float* part_m = p.part + rows * kD;
  float* part_l = part_m + rows;
  #pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (lo_ok) store2(p.part + (base + row_lo) * kD + col, o[nt][0], o[nt][1]);
    if (hi_ok) store2(p.part + (base + row_hi) * kD + col, o[nt][2], o[nt][3]);
  }
  if (t == 0) {
    if (lo_ok) { part_m[base + row_lo] = m_lo; part_l[base + row_lo] = l_lo; }
    if (hi_ok) { part_m[base + row_hi] = m_hi; part_l[base + row_hi] = l_hi; }
  }
}

// One warp per (b, h, query) row: merge the chunks' partials.
template <typename T, bool kStats>
__global__ void __launch_bounds__(256)
masked_attn_merge(const Params p, int BH) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= (long long)BH * p.Q) return;
  const long long bh = row / p.Q, qi = row % p.Q;
  const long long rows = (long long)BH * p.chunks * p.Q;
  const float* part_m = p.part + rows * kD;
  const float* part_l = part_m + rows;
  const long long first = bh * p.chunks * p.Q + qi;  // chunk c is at first + c * Q

  // lanes take the chunks side by side: the maximum, then the sum
  float m_all = -INFINITY;
  for (int c = lane; c < p.chunks; c += 32) m_all = fmaxf(m_all, part_m[first + (long long)c * p.Q]);
  #pragma unroll
  for (int d = 16; d > 0; d >>= 1) m_all = fmaxf(m_all, __shfl_xor_sync(kFull, m_all, d));
  float l_all = 0.f;
  for (int c = lane; c < p.chunks; c += 32) {
    const long long r = first + (long long)c * p.Q;
    l_all += part_l[r] * ex2(part_m[r] - m_all);
  }
  #pragma unroll
  for (int d = 16; d > 0; d >>= 1) l_all += __shfl_xor_sync(kFull, l_all, d);
  // a lane a channel; no load depends on another
  float a = 0.f;
  #pragma unroll 4
  for (int c = 0; c < p.chunks; ++c) {
    const long long r = first + (long long)c * p.Q;
    a = fmaf(p.part[r * kD + lane], ex2(part_m[r] - m_all), a);
  }
  if constexpr (kStats) {
    if (lane == 0) reinterpret_cast<float2*>(p.stats)[row] = make_float2(m_all, l_all);
  }
  const int b = (int)(bh / p.H), h = (int)(bh % p.H);
  const long long at = b * p.o_sb + h * p.o_sh + qi * p.o_sr + lane;
  T* dst = static_cast<T*>(p.out) + at;
  if constexpr (sizeof(T) == 4) {
    *dst = a / l_all;
  } else {
    *dst = __float2bfloat16(a / l_all);
    if constexpr (kStats) p.out32[at] = a / l_all;
  }
}

template <typename T, bool kStats>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int qtiles = (p.Q + 15) / 16;
  const int warps = qtiles < kMaxWarps ? qtiles : kMaxWarps;
  const int qblocks = (qtiles + kMaxWarps - 1) / kMaxWarps;
  const int BH = B * p.H;
  if (BH == 0 || p.Q == 0) return cudaSuccess;
  if (BH > 65535 || qblocks > 65535) return cudaErrorInvalidConfiguration;
  constexpr int smem = kStages * Stage<T>::bytes + Split<T>::bytes;
  // more than 48 KB of dynamic shared memory has to be asked for, once a device
  static bool asked[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || !asked[device]) {
    err = cudaFuncSetAttribute(masked_attn_tiles<T, kStats>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) asked[device] = true;
  }
  const dim3 grid(p.chunks, BH, qblocks);
  masked_attn_tiles<T, kStats><<<grid, warps * 32, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.chunks == 1) return err;
  const long long rows = (long long)BH * p.Q;
  masked_attn_merge<T, kStats><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(p, BH);
  return cudaGetLastError();
}

}  // namespace

// The 12 strides are in elements: (batch, head, row) of q, k, v and out. part:
// fp32 scratch of B * H * chunks * Q * (D + 2) floats with chunks = ceil(S /
// chunk), unused when chunks is 1; chunk must be a positive multiple of 64.
// stats: null, or B * H * Q * 2 floats that receive each row's maximum score
// (base 2, as the kernel keeps it) and the sum of its weights relative to that
// maximum, which the backward kernel (masked_attn_bwd.cu) recomputes the
// softmax from. (One log-sum-exp would not do: a row whose keys are all masked
// has maximum -1e9 log2 e, where float32 steps by 128 and log2 of the sum is
// lost.) out32: with stats in bfloat16, float32 memory with out's strides that
// receives out before its rounding, from which the backward takes delta =
// rowsum(dO * O): where the weights spread over many keys, dP - delta cancels,
// and a delta from the rounded out would carry its rounding into every dS of
// the row alike; unused otherwise. dtype: 0 = float32, 1 = bfloat16. Returns
// the first failing launch's cudaError_t (0 = cudaSuccess); the launches are
// asynchronous on `stream`.
extern "C" int masked_attn_fwd(const void* q, const void* k, const void* v, const void* mask,
                               void* part, void* out, void* stats, void* out32, int B, int H,
                               int Q, int S, int D,
                               long long q_sb, long long q_sh, long long q_sr,
                               long long k_sb, long long k_sh, long long k_sr,
                               long long v_sb, long long v_sh, long long v_sr,
                               long long o_sb, long long o_sh, long long o_sr,
                               long long mask_sb, long long mask_sh,
                               int chunk, int dtype, void* stream) {
  if (D != kD || S <= 0 || chunk <= 0 || chunk % kKT != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.stats = static_cast<float*>(stats);
  p.out32 = static_cast<float*>(out32);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sr = q_sr;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sr = k_sr;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sr = v_sr;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sr = o_sr;
  p.mask_sb = mask_sb; p.mask_sh = mask_sh;
  p.H = H; p.Q = Q; p.S = S; p.chunk = chunk;
  p.chunks = (S + chunk - 1) / chunk;
  p.scale_log2 = kLog2e / sqrtf((float)kD);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_stats = stats != nullptr;
  if (with_stats && dtype == 1 && out32 == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)(with_stats ? launch<float, true>(p, B, s) : launch<float, false>(p, B, s));
  if (dtype == 1)
    return (int)(with_stats ? launch<__nv_bfloat16, true>(p, B, s)
                            : launch<__nv_bfloat16, false>(p, B, s));
  return (int)cudaErrorInvalidValue;
}
