// The window-stationary design of K1 backward, measured beside the port's
// (csrc/msda_bwd.cu) and kept so that tools/probe_torch_msda_bwd_bound.py can
// time it and rebuild it with one thing changed. It is right (the probe holds
// it against the plain backward) and on an H100 no faster than the port's: its
// adds into the windows are float adds on shared memory, which sm_90 runs as
// compare-and-swap loops, and they cost about what the port's atomics into the
// L2 cost (PERF.md). Entry point msda_bwd_windows, the arguments of
// msda_bwd; not built into the port. Its block map and window rule are
// repeated on tensors by ms_deform_attn_backward_windowed
// (tools/probe_torch_msda_bwd_windows.py).
//
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
// 5376, 8 heads, 12 points) a launch has 4.1 M points and 16.5 M taps of 32
// channels. The port's design (csrc/msda_bwd.cu) sends every
// tap to grad_value as a 128-byte float32 atomic: 2.1 GB into the L2 a launch,
// which bound it (0.62 ms; 0.22 ms with no adds at all). Those adds repeat
// themselves: a (pixel, head) row of grad_value takes 48 taps on average.
//
// Design: window-stationary accumulation, the adds summed on chip.
// - Block map. Where Q == S (the encoder: every query is a token) a block
//   owns one (batch, head) and one tile of the image: a kTile x kTile tile of
//   the finest level and the tokens of every other level that fall in the
//   same rows and columns of tiles (16x16 + 8x8 + 4x4 = 336 queries at the
//   training levels). Where Q != S a block owns kChunk consecutive queries and
//   has no windows. The grid is persistent: kBlocksPerSm blocks an SM walk the
//   (batch, head, tile) items.
// - Windows. Each of the first kMaxLevels levels gets a window of grad_value
//   rows in shared memory, 32 floats a pixel: the tile's rows and columns on
//   that level plus a margin on each side (the largest margin up to kMaxMargin
//   for which all windows fit kSmemBytes; if none does, the levels with the
//   largest windows get none). Each block places its windows from the mean
//   offset of its own points on that level, each offset clipped to the
//   window's size so that a point far off the map moves it by little, and
//   keeps them on the map. The rule is repeated on tensors by
//   ms_deform_attn_backward_windowed (tools/probe_torch_msda_bwd_windows.py).
// - The first design's lanes: 8 lanes per (query, head), 4 channels a lane,
//   a warp's four groups on four queries of the tile; the points of a query
//   dealt out over its 8 lanes, 8 points a round. The owning lane computes the
//   four taps (pixel row, place in the window or -1, folded weight) and keeps
//   the factors of its point's derivatives; the group reads each tap with one
//   16-byte load a lane and reduces the dot products by shuffles. So a tap's
//   index arithmetic runs once for four queries. (One lane a channel, one query
//   a warp, ran every tap's arithmetic a lane for one query and measured 2.1x
//   slower: PERF.md.)
// - Adds on chip. A tap inside its window adds w * g to the window's pixel
//   row: 4 float adds a lane into shared memory, each group's channels in an
//   order rotated by the group, so that the warp's four groups hit 32 banks.
//   A tap outside its window (far points, a window too small) goes straight to
//   grad_value as before, one 16-byte float32 atomic a lane. Correctness does
//   not depend on the windows.
// - Flush. After the block's queries each window goes to grad_value once:
//   one 16-byte float32 atomic a lane, 8 lanes a pixel row, rows that took no
//   tap skipped. At the training shape that is ~0.1 GB a launch in place of
//   2.1 GB, plus the taps outside the windows.
// - grad_attn and grad_loc are written once each, in the input type, by the
//   owning lane. grad_value is accumulated in float32 whatever the input type;
//   the wrapper casts it. The order of the adds varies from run to run (shared
//   and global atomics; the window placement's sums are exact integers), so
//   grad_value is reproducible to rounding only.
// kStageValue, kBulkFlush and kWindows switch the reads of value inside the
// windows to a copy staged in shared memory, the flush to one bulk
// reduce-add copy (cp.reduce.async.bulk, the copy engine) a window pixel row,
// and the windows off; the probe (tools/probe_torch_msda_bwd_bound.py) times
// each against this setting.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;                   // channels per head
constexpr int kLanes = 8;                // lanes per (query, head)
constexpr int kVec = kD / kLanes;        // channels per lane
constexpr int kThreads = 512;
constexpr int kQueriesPerRound = kThreads / kLanes;
constexpr int kBlocksPerSm = 2;
constexpr bool kWindows = true;          // sum the taps near a tile in shared memory
constexpr bool kStageValue = false;      // read value inside a window from a staged copy
constexpr bool kBulkFlush = false;       // flush a window pixel row by a bulk reduce-add copy
constexpr int kSmemBytes = 110 * 1024;   // per block: the level table and the windows
constexpr int kTile = 16;                // a tile's side on the finest level, pixels
constexpr int kMaxMargin = 4;            // pixels a window reaches beyond its tile, at most
constexpr int kMaxLevels = 4;            // levels that can have a window
constexpr int kChunk = 256;              // queries a block where Q != S
constexpr unsigned kFullMask = 0xffffffffu;

// One level as a block sees it: the map, its window's size, and for the
// current item the tile's rows and columns and the window's place.
struct Level {
  int H, W, start;     // rows, columns, first token
  int wh, ww, woff;    // window rows and columns (0: none), first float in the windows
  int r0, r1, c0, c1;  // the tile's rows [r0, r1) and columns [c0, c1)
  int wr0, wc0;        // the window's first row and column
};

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
// the same from shared memory (a staged window)
__device__ __forceinline__ float4 shared_vec(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 shared_vec(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
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

// component k of v (a select, not an index: v stays in registers)
__device__ __forceinline__ float pick(const float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
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

// *p += x in shared memory (the compiler makes it a compare-and-swap loop:
// sm_90 has no float add on shared memory)
__device__ __forceinline__ void shared_add(float* p, float x) { atomicAdd(p, x); }

// p[0..3] += w * g, one 16-byte atomic (p is 16-byte aligned)
__device__ __forceinline__ void atomic_add_vec(float* p, float w, const float4 g) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
}

__device__ __forceinline__ int floor_div(int a, int n) {  // n > 0
  return a >= 0 ? a / n : -((n - 1 - a) / n);
}

// The four taps of one point: element offsets of their pixel rows (from the
// batch element's first), their first floats in the windows (-1: outside the
// window), and the folded weights (bilinear x validity x attention), in the
// order (y0, x0), (y0, x1), (y1, x0), (y1, x1).
struct Taps {
  int o00, o01, o10, o11;
  int s00, s01, s10, s11;
  float w00, w01, w10, w11;
};

// The block's plan, the same in every block: the level table, the tiling and
// the windows' sizes. Run by one thread. Returns the tiles of one (batch,
// head), or 0 where Q != S.
__device__ int make_plan(Level* lv, const int* levels, int L, int S, int Q, int cap_pixels,
                         int* tiles_x) {
  int f = 0;
  for (int l = 0; l < L; ++l) {
    lv[l].H = levels[3 * l];
    lv[l].W = levels[3 * l + 1];
    lv[l].start = levels[3 * l + 2];
    lv[l].wh = lv[l].ww = lv[l].woff = 0;
    if (lv[l].H * lv[l].W > lv[f].H * lv[f].W) f = l;
  }
  *tiles_x = 0;
  if (Q != S) return 0;
  const int ty = (lv[f].H + kTile - 1) / kTile, tx = (lv[f].W + kTile - 1) / kTile;
  *tiles_x = tx;
  if (!kWindows) return ty * tx;
  const int nl = min(L, kMaxLevels);
  int wh[kMaxLevels], ww[kMaxLevels], total = 0;
  for (int margin = kMaxMargin; margin >= 0; --margin) {
    total = 0;
    for (int l = 0; l < nl; ++l) {
      wh[l] = min((lv[l].H + ty - 1) / ty + 2 * margin, lv[l].H);
      ww[l] = min((lv[l].W + tx - 1) / tx + 2 * margin, lv[l].W);
      total += wh[l] * ww[l];
    }
    if (total <= cap_pixels) break;
  }
  while (total > cap_pixels) {  // drop the largest window (the last of equals)
    int big = 0;
    for (int l = 1; l < nl; ++l)
      if (wh[l] * ww[l] >= wh[big] * ww[big]) big = l;
    total -= wh[big] * ww[big];
    wh[big] = ww[big] = 0;
  }
  int off = 0;
  for (int l = 0; l < nl; ++l) {
    lv[l].wh = wh[l];
    lv[l].ww = ww[l];
    lv[l].woff = off;
    off += wh[l] * ww[l] * kD;
  }
  return ty * tx;
}

// token of the block's k-th query in tile mode: the tile's tokens level by
// level, row by row
__device__ __forceinline__ int tile_token(const Level* lv, int L, int k) {
  for (int l = 0; l < L; ++l) {
    const int cols = lv[l].c1 - lv[l].c0, n = (lv[l].r1 - lv[l].r0) * cols;
    if (k < n) return lv[l].start + (lv[l].r0 + k / cols) * lv[l].W + lv[l].c0 + k % cols;
    k -= n;
  }
  return -1;
}

// T: grad_out and value; U: locations, weights and their gradients (T, or
// float32 for a bfloat16 value)
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
msda_bwd_kernel(const T* __restrict__ grad_out, const T* __restrict__ value,
                const int* __restrict__ levels, const U* __restrict__ loc,
                const U* __restrict__ attn, float* __restrict__ grad_value,
                U* __restrict__ grad_loc, U* __restrict__ grad_attn,
                int B, int S, int Q, int M, int L, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  Level* lv = reinterpret_cast<Level*>(smem);
  const int header = L * (int)sizeof(Level);
  constexpr int kPixelBytes = kD * (4 + (kStageValue ? (int)sizeof(T) : 0));
  float* s_win = reinterpret_cast<float*>(smem + header);
  const int cap_pixels = (kSmemBytes - header) / kPixelBytes;
  T* s_val = reinterpret_cast<T*>(s_win + cap_pixels * kD);
  __shared__ int s_tiles, s_tiles_x, s_nq, s_windows;
  __shared__ int s_sum[kMaxLevels][3];  // per level: sum of row and column offsets, points

  const int tid = threadIdx.x, lane = tid & (kLanes - 1);
  if (tid == 0) {
    s_tiles = make_plan(lv, levels, L, S, Q, cap_pixels, &s_tiles_x);
    int any = 0;
    for (int l = 0; l < min(L, kMaxLevels); ++l) any |= lv[l].wh > 0;
    s_windows = kWindows && s_tiles > 0 && any;
  }
  __syncthreads();
  const bool tiled = s_tiles > 0, windows = s_windows;
  const int per_bm = tiled ? s_tiles : (Q + kChunk - 1) / kChunk;
  const int nl = min(L, kMaxLevels), LP = L * P, pix_stride = M * kD;
  const long long items = (long long)B * M * per_bm;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int bm = (int)(item / per_bm), t = (int)(item % per_bm);
    const int b = bm / M, m = bm % M;
    // the item's tile on every level
    if (tiled && tid < L) {
      const int ty = s_tiles / s_tiles_x, tx = s_tiles_x, i = t / tx, j = t % tx;
      Level& v = lv[tid];
      v.r0 = i * v.H / ty;
      v.r1 = (i + 1) * v.H / ty;
      v.c0 = j * v.W / tx;
      v.c1 = (j + 1) * v.W / tx;
    }
    if (tid < kMaxLevels * 3) s_sum[tid / 3][tid % 3] = 0;
    __syncthreads();
    if (tid == 0) {
      int nq = 0;
      if (tiled)
        for (int l = 0; l < L; ++l) nq += (lv[l].r1 - lv[l].r0) * (lv[l].c1 - lv[l].c0);
      else
        nq = min(kChunk, Q - t * kChunk);
      s_nq = nq;
    }
    __syncthreads();
    const int nq = s_nq;
    const long long value_base = (long long)b * S * pix_stride + m * kD;

    if (windows) {
      // place the windows: each point's offset from the tile's middle on its
      // level, clipped to the window's size, summed as integers
      int sy[kMaxLevels], sx[kMaxLevels], cnt[kMaxLevels];
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) sy[l] = sx[l] = cnt[l] = 0;
      for (int e = tid; e < nq * nl * P; e += kThreads) {
        const int k = e / (nl * P), r = e % (nl * P), l = r / P, p = r % P;
        const Level& v = lv[l];
        if (v.wh == 0) continue;
        const int pair = (b * Q + tile_token(lv, L, k)) * M + m;
        const float2 xy = load_xy(loc + ((long long)pair * LP + l * P + p) * 2);
        const float x = xy.x * v.W - 0.5f, y = xy.y * v.H - 0.5f;
        if (!(isfinite(x) && isfinite(y))) continue;
        const int cy = (v.r0 + v.r1 - 1) >> 1, cx = (v.c0 + v.c1 - 1) >> 1;
        const int dy = (int)fminf(fmaxf(floorf(y) - (float)cy, -(float)v.wh), (float)v.wh);
        const int dx = (int)fminf(fmaxf(floorf(x) - (float)cx, -(float)v.ww), (float)v.ww);
#pragma unroll
        for (int j = 0; j < kMaxLevels; ++j)
          if (j == l) { sy[j] += dy; sx[j] += dx; cnt[j] += 1; }
      }
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        const int a = __reduce_add_sync(kFullMask, sy[l]);
        const int c = __reduce_add_sync(kFullMask, sx[l]);
        const int n = __reduce_add_sync(kFullMask, cnt[l]);
        if ((tid & 31) == 0 && n > 0) {
          atomicAdd(&s_sum[l][0], a);
          atomicAdd(&s_sum[l][1], c);
          atomicAdd(&s_sum[l][2], n);
        }
      }
      __syncthreads();
      if (tid < nl && lv[tid].wh > 0) {
        Level& v = lv[tid];
        const int n = s_sum[tid][2];
        const int my = n > 0 ? floor_div(s_sum[tid][0] + n / 2, n) : 0;
        const int mx = n > 0 ? floor_div(s_sum[tid][1] + n / 2, n) : 0;
        const int cy = (v.r0 + v.r1 - 1) >> 1, cx = (v.c0 + v.c1 - 1) >> 1;
        v.wr0 = min(max(cy + my - (v.wh - 1) / 2, 0), v.H - v.wh);
        v.wc0 = min(max(cx + mx - (v.ww - 1) / 2, 0), v.W - v.ww);
      }
      __syncthreads();
      // zero the windows (and stage value's)
      for (int l = 0; l < nl; ++l) {
        const Level& v = lv[l];
        const int n = v.wh * v.ww * (kD / 4);
        float4* w4 = reinterpret_cast<float4*>(s_win + v.woff);
        for (int i = tid; i < n; i += kThreads) w4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kStageValue) {
          constexpr int kChunks = kD * (int)sizeof(T) / 16;  // 16-byte pieces a pixel row
          for (int i = tid; i < v.wh * v.ww * kChunks; i += kThreads) {
            const int px = i / kChunks, c = i % kChunks;
            const int tok = v.start + (v.wr0 + px / v.ww) * v.W + v.wc0 + px % v.ww;
            const uint4* src = reinterpret_cast<const uint4*>(
                value + value_base + (long long)tok * pix_stride);
            reinterpret_cast<uint4*>(s_val + v.woff + px * kD)[c] = __ldg(src + c);
          }
        }
      }
      __syncthreads();
    }

    // the block's queries, kQueriesPerRound at a time, 8 lanes each
    // the lane's channels in the order it adds them to a window: rotated by its
    // group of the warp, so that the warp's four groups hit other banks
    const int rot = (tid >> 3) & 3;
    for (int k0 = 0; k0 < nq; k0 += kQueriesPerRound) {
      const int k = k0 + tid / kLanes;
      const bool live = k < nq;
      // every lane stays in the shuffles; a group past the last query adds and writes nothing
      const int kk = live ? k : nq - 1;
      const int q = tiled ? tile_token(lv, L, kk) : t * kChunk + kk;
      const int pair = (b * Q + q) * M + m;
      const U* loc_p = loc + (long long)pair * LP * 2;
      const U* attn_p = attn + (long long)pair * LP;
      const T* base = value + value_base + lane * kVec;
      float* gbase = grad_value + value_base + lane * kVec;
      const float4 g = load_vec(grad_out + (long long)pair * kD + lane * kVec);
      const float r0 = pick(g, rot), r1 = pick(g, (rot + 1) & 3), r2 = pick(g, (rot + 2) & 3),
                  r3 = pick(g, (rot + 3) & 3);
      // p[lane's channels] += w * g in shared memory, the channels in rotated order
      auto window_add = [&](int s, float w) {
        float* p = s_win + s + lane * kVec;
        shared_add(p + rot, w * r0);
        shared_add(p + ((rot + 1) & 3), w * r1);
        shared_add(p + ((rot + 2) & 3), w * r2);
        shared_add(p + ((rot + 3) & 3), w * r3);
      };
      auto add = [&](int o, int s, float w) {
        if (w == 0.f) return;
        if (s >= 0)
          window_add(s, w);
        else
          atomic_add_vec(gbase + o, w, g);
      };
      auto read = [&](int o, int s) -> float4 {
        return (kStageValue && s >= 0) ? shared_vec(s_val + s + lane * kVec) : load_vec(base + o);
      };

      for (int first = 0; first < LP; first += kLanes) {
        // this lane's point of the round: its taps, and the factors of its gradients
        Taps mine = {0, 0, 0, 0, -1, -1, -1, -1, 0.f, 0.f, 0.f, 0.f};
        float a = 0.f, bx0 = 0.f, bx1 = 0.f, by0 = 0.f, by1 = 0.f;  // bilinear factors x validity
        float sx0 = 0.f, sx1 = 0.f, sy0 = 0.f, sy1 = 0.f;           // their derivatives
        float Wf = 0.f, Hf = 0.f;
        const int i = first + lane;
        if (i < LP) {
          const int l = i / P;
          const Level& v = lv[l];
          const int H = v.H, W = v.W;
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
            const int ya = max(y0, 0), yb = min(y0 + 1, H - 1);
            mine.o00 = (v.start + ya * W + xa) * pix_stride;
            mine.o01 = (v.start + ya * W + xb) * pix_stride;
            mine.o10 = (v.start + yb * W + xa) * pix_stride;
            mine.o11 = (v.start + yb * W + xb) * pix_stride;
            if (windows && l < nl && v.wh > 0) {
              const int ra = ya - v.wr0, rb = yb - v.wr0, ca = xa - v.wc0, cb = xb - v.wc0;
              const bool ia = (unsigned)ra < (unsigned)v.wh, ib = (unsigned)rb < (unsigned)v.wh;
              const bool ja = (unsigned)ca < (unsigned)v.ww, jb = (unsigned)cb < (unsigned)v.ww;
              mine.s00 = ia && ja ? v.woff + (ra * v.ww + ca) * kD : -1;
              mine.s01 = ia && jb ? v.woff + (ra * v.ww + cb) * kD : -1;
              mine.s10 = ib && ja ? v.woff + (rb * v.ww + ca) * kD : -1;
              mine.s11 = ib && jb ? v.woff + (rb * v.ww + cb) * kD : -1;
            }
            mine.w00 = a * by0 * bx0;
            mine.w01 = a * by0 * bx1;
            mine.w10 = a * by1 * bx0;
            mine.w11 = a * by1 * bx1;
          }
        }
        // <value[tap], g> of this lane's point, kept when its turn comes
        float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
        // the round's points, the same count in every group of the block
        const int n = min(kLanes, LP - first);
        for (int j = 0; j < n; ++j) {
          const int o00 = __shfl_sync(kFullMask, mine.o00, j, kLanes);
          const int o01 = __shfl_sync(kFullMask, mine.o01, j, kLanes);
          const int o10 = __shfl_sync(kFullMask, mine.o10, j, kLanes);
          const int o11 = __shfl_sync(kFullMask, mine.o11, j, kLanes);
          const int s00 = __shfl_sync(kFullMask, mine.s00, j, kLanes);
          const int s01 = __shfl_sync(kFullMask, mine.s01, j, kLanes);
          const int s10 = __shfl_sync(kFullMask, mine.s10, j, kLanes);
          const int s11 = __shfl_sync(kFullMask, mine.s11, j, kLanes);
          const float w00 = __shfl_sync(kFullMask, mine.w00, j, kLanes);
          const float w01 = __shfl_sync(kFullMask, mine.w01, j, kLanes);
          const float w10 = __shfl_sync(kFullMask, mine.w10, j, kLanes);
          const float w11 = __shfl_sync(kFullMask, mine.w11, j, kLanes);
          const float e00 = group_sum(dot_vec(read(o00, s00), g));
          const float e01 = group_sum(dot_vec(read(o01, s01), g));
          const float e10 = group_sum(dot_vec(read(o10, s10), g));
          const float e11 = group_sum(dot_vec(read(o11, s11), g));
          if (lane == j) { d00 = e00; d01 = e01; d10 = e10; d11 = e11; }
          if (live) {
            add(o00, s00, w00);
            add(o01, s01, w01);
            add(o10, s10, w10);
            add(o11, s11, w11);
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

    if constexpr (kBulkFlush) {
      if (windows) {
        // the adds into the windows, seen by the bulk copies' (async) proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        for (int l = 0; l < nl; ++l) {
          const Level& v = lv[l];
          for (int px = tid; px < v.wh * v.ww; px += kThreads) {
            const int tok = v.start + (v.wr0 + px / v.ww) * v.W + v.wc0 + px % v.ww;
            float* dst = grad_value + value_base + (long long)tok * pix_stride;
            const unsigned src = (unsigned)__cvta_generic_to_shared(s_win + v.woff + px * kD);
            asm volatile(
                "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
                :: "l"(dst), "r"(src), "n"(kD * 4) : "memory");
          }
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    } else if (windows) {
      __syncthreads();
      // flush: each window pixel row once, 16 bytes a lane, rows that took no tap skipped
      for (int l = 0; l < nl; ++l) {
        const Level& v = lv[l];
        const int n = v.wh * v.ww * (kD / 4);
        const float4* w4 = reinterpret_cast<const float4*>(s_win + v.woff);
        for (int i = tid; i < n; i += kThreads) {
          const float4 s = w4[i];
          if (s.x == 0.f && s.y == 0.f && s.z == 0.f && s.w == 0.f) continue;
          const int px = i / (kD / 4), c = i % (kD / 4);
          const int tok = v.start + (v.wr0 + px / v.ww) * v.W + v.wc0 + px % v.ww;
          atomicAdd(reinterpret_cast<float4*>(grad_value + value_base +
                                              (long long)tok * pix_stride + 4 * c), s);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, typename U>
cudaError_t launch(const void* grad_out, const void* value, const void* levels, const void* loc,
                   const void* attn, void* grad_value, void* grad_loc, void* grad_attn,
                   int B, int S, int Q, int M, int L, int P, cudaStream_t stream) {
  if ((long long)B * Q * M == 0) return cudaSuccess;
  if (L <= 0 || P <= 0 || S <= 0) return cudaErrorInvalidValue;
  // 32-bit pair indices and 32-bit element offsets inside a batch element; the
  // batch element's base is 64-bit
  if ((long long)B * Q * M > 0x7fffffffLL || (long long)S * M * kD > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // the level table and, where Q == S, the windows
  const int header = L * (int)sizeof(Level);
  if (header > 16 * 1024) return cudaErrorInvalidValue;
  const int smem = (Q == S && kWindows) ? kSmemBytes : header;
  static int sms[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || sms[device] == 0) {
    err = cudaFuncSetAttribute(msda_bwd_kernel<T, U>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    sms[device] = n;
  }
  msda_bwd_kernel<T, U><<<sms[device] * kBlocksPerSm, kThreads, smem, stream>>>(
      static_cast<const T*>(grad_out), static_cast<const T*>(value),
      static_cast<const int*>(levels), static_cast<const U*>(loc), static_cast<const U*>(attn),
      static_cast<float*>(grad_value), static_cast<U*>(grad_loc), static_cast<U*>(grad_attn),
      B, S, Q, M, L, P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = bfloat16 grad_out and value with
// float32 locations, weights and their gradients. Every pointer must be
// 16-byte aligned. grad_value is float32 for both types and must be zero on
// entry. Returns the launch's cudaError_t (0 = cudaSuccess); the launch (one
// kernel) is asynchronous on `stream`.
extern "C" int msda_bwd_windows(const void* grad_out, const void* value, const void* levels,
                        const void* loc, const void* attn, void* grad_value, void* grad_loc,
                        void* grad_attn, int B, int S, int Q, int M, int L, int P, int D,
                        int dtype, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, float>(grad_out, value, levels, loc, attn, grad_value, grad_loc,
                                     grad_attn, B, S, Q, M, L, P, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(grad_out, value, levels, loc, attn,
                                                     grad_value, grad_loc, grad_attn, B, S, Q,
                                                     M, L, P, s);
  if (dtype == 2)
    return (int)launch<__nv_bfloat16, float>(grad_out, value, levels, loc, attn, grad_value,
                                             grad_loc, grad_attn, B, S, Q, M, L, P, s);
  return (int)cudaErrorInvalidValue;
}
