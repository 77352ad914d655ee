// A rejected design of K1 backward, kept so that
// tools/probe_torch_msda_bwd_bound.py can time it beside the port's kernel
// (csrc/msda_bwd.cu): blocks own 8 x 8 tiles of tokens and bin the taps near
// the tile by pixel in shared memory, so that one add a pixel and block goes to
// grad_value. It is right (the probe holds it against the plain backward) and
// slower than the port's design on an H100: the binning's bookkeeping costs about
// as much as the adds it saves. Entry point msda_bwd_binned; not built into the
// port.
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
// and as many bytes of adds into grad_value. The port's design adds every tap
// with one 16-byte float32 atomic a lane (a 128-byte line a tap) into the L2,
// where those adds queued; its 16 consecutive queries a block hit the same
// lines at the same time.
//
// Design. The forward's layout for the reads and the two small gradients:
// - 8 lanes per (batch, query, head), 4 channels a lane; the points of a pair
//   are dealt out over its 8 lanes, 8 points a round. The owning lane computes
//   the four taps and their folded weights, keeps the factors of its point's
//   derivatives, and the group reduces the four dot products by shuffles.
//   After the loop the owning lane writes its point's grad_attn and grad_loc,
//   each exactly once, in the input type.
// - Blocks by 2-D tiles: where the queries are the tokens (Q = S, the
//   encoder), a block owns an 8 x 8 tile of tokens of one level of one
//   (batch, head), so its points sample a few neighbourhoods of each level
//   (block_queries in tools/probe_torch_msda_bwd_bound.py gives the same map);
//   otherwise 64 consecutive queries.
// - Taps binned by pixel: for a tile, the block lays a window over each
//   level (the tile's footprint on that level plus a margin of up to 12
//   pixels, at most 4096 pixels for all levels together). A tap inside its
//   window is not added at once: its owning lane writes a record (window pixel,
//   weight, rank among its pixel's taps); the lanes of a warp that share a
//   pixel count it with one integer shared-memory atomic (__match_any_sync).
//   After the loop the block turns the counts into runs (a prefix sum, which
//   also lists the pixels touched), puts each record at its run's start plus
//   its rank, and a group of 8 lanes sums a touched pixel's run, w * g with g
//   from the block's rows of grad_out in shared memory, and adds the sum to
//   grad_value with one 16-byte atomic a lane: one add a pixel and block where
//   the port makes one a tap. Taps outside their window (points far from their
//   query) go to grad_value at once, as before. (Float atomics in shared memory
//   were tried first: slower than the global ones, tools/probe_torch_msda_bwd_
//   bound.py.)
// - grad_value is accumulated in float32 whatever the input type; the wrapper
//   casts it. The order of the atomic adds varies from run to run, so
//   grad_value is reproducible to rounding only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;                      // channels per head
constexpr int kLanes = 8;                   // lanes per (batch, query, head)
constexpr int kVec = kD / kLanes;           // channels per lane
constexpr int kTile = 8;                    // a block's tile: kTile x kTile tokens
constexpr int kQueries = kTile * kTile;     // queries per block
constexpr int kThreads = kQueries * kLanes;
constexpr int kMaxLevels = 8;
constexpr int kWindowPx = 4096;             // window pixels of a block, all levels together
constexpr int kMargin = 12;                 // pixels around a tile's footprint, at most
constexpr int kMaxPoints = 64;              // L * P with windows: their taps' records must fit
constexpr int kUnroll = 1;                  // points of a group whose taps are loaded together
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

// A level's window in shared memory: pixels [x0, x0 + w) x [y0, y0 + h), the
// first at window pixel `base`; w = 0 for a level without one.
struct Window {
  int x0, y0, w, h, base;
};

// The four taps of one point: element offsets from the lane's base pointer,
// the folded weights (bilinear x validity x attention), in the order (y0, x0),
// (y0, x1), (y1, x0), (y1, x1), and each tap's window pixel (-1: none).
struct Taps {
  int o[4];
  float w[4];
  int s[4];
};

// w * g into the lane's 4 channels of a tap in grad_value: one 16-byte atomic
__device__ __forceinline__ void add_tap(float* gbase, int offset, float w, const float4 g) {
  if (w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(gbase + offset),
              make_float4(w * g.x, w * g.y, w * g.z, w * g.w));
}

// The binning in shared memory: per window pixel its count of taps, then
// where its run starts; the block's rows of grad_out; per tap a record
// (window pixel or -1, folded weight, rank among its pixel's taps); the
// records sorted into runs by pixel; the pixels with any tap.
struct Binned {
  int* cursor;     // kWindowPx
  float* g;        // kQueries x kD, float32
  int* rec_px;     // kQueries x L x P x 4
  float* rec_w;
  short* rec_rank;
  short* order;    // kQueries x L x P x 4
  short* touched;  // kWindowPx
};

__host__ __device__ __forceinline__ int binned_bytes(int records) {
  return (kWindowPx + kQueries * kD) * 4 + records * (4 + 4 + 2 + 2) + kWindowPx * 2;
}

__device__ __forceinline__ Binned binned(float* smem, int records) {
  Binned bn;
  bn.cursor = reinterpret_cast<int*>(smem);
  bn.g = smem + kWindowPx;
  bn.rec_px = reinterpret_cast<int*>(bn.g + kQueries * kD);
  bn.rec_w = reinterpret_cast<float*>(bn.rec_px + records);
  bn.rec_rank = reinterpret_cast<short*>(bn.rec_w + records);
  bn.order = bn.rec_rank + records;
  bn.touched = bn.order + records;
  return bn;
}

// grid B * M * blocks_per_bm, block kThreads. tiled: the queries are the
// tokens (Q = S) and a block owns a kTile x kTile tile of one level; else
// kQueries consecutive queries. stage: bin the taps in the tile's windows (tiled only).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
msda_bwd_kernel(const T* __restrict__ grad_out, const T* __restrict__ value,
                const int* __restrict__ levels, const T* __restrict__ loc,
                const T* __restrict__ attn, float* __restrict__ grad_value,
                T* __restrict__ grad_loc, T* __restrict__ grad_attn,
                int S, int Q, int M, int L, int P, int blocks_per_bm, int tiled, int stage) {
  extern __shared__ __align__(16) float smem[];  // Binned, with windows
  __shared__ int s_levels[3 * kMaxLevels];
  __shared__ Window s_win[kMaxLevels];
  __shared__ int s_tile[4];  // query level, first column, first row, window pixels in use

  const int tid = threadIdx.x;
  const int lane = tid & (kLanes - 1);
  const int slot = tid / kLanes;  // the block's query slot
  const int bm = blockIdx.x / blocks_per_bm, blk = blockIdx.x % blocks_per_bm;
  const int b = bm / M;
  const int m = bm % M;
  if (tid < 3 * L) s_levels[tid] = levels[tid];
  __syncthreads();

  if (tid == 0) {
    int lq = -1, tx = 0, ty = 0, used = 0;
    if (tiled) {  // which level's tile this block is
      int first = 0;
      for (int l = 0; l < L; ++l) {
        const int H = s_levels[3 * l], W = s_levels[3 * l + 1];
        const int tw = (W + kTile - 1) / kTile, n = tw * ((H + kTile - 1) / kTile);
        if (blk < first + n) {
          lq = l;
          tx = (blk - first) % tw;
          ty = (blk - first) / tw;
          break;
        }
        first += n;
      }
    }
    for (int l = 0; l < L; ++l) s_win[l] = Window{0, 0, 0, 0, 0};
    if (lq >= 0 && stage) {
      // each level's window: the tile's reference points on that level, plus a
      // margin; the margin shrinks until all windows fit, then the largest go
      const float Wq = (float)s_levels[3 * lq + 1], Hq = (float)s_levels[3 * lq];
      const int cx0 = tx * kTile, cy0 = ty * kTile;
      const int cx1 = min(cx0 + kTile, s_levels[3 * lq + 1]) - 1;
      const int cy1 = min(cy0 + kTile, s_levels[3 * lq]) - 1;
      Window win[kMaxLevels];
      for (int margin = kMargin; margin >= 0; --margin) {
        used = 0;
        for (int l = 0; l < L; ++l) {
          const int H = s_levels[3 * l], W = s_levels[3 * l + 1];
          const float sx = W / Wq, sy = H / Hq;
          const int x0 = max(0, (int)floorf((cx0 + 0.5f) * sx - 0.5f) - margin);
          const int x1 = min(W - 1, (int)floorf((cx1 + 0.5f) * sx - 0.5f) + 1 + margin);
          const int y0 = max(0, (int)floorf((cy0 + 0.5f) * sy - 0.5f) - margin);
          const int y1 = min(H - 1, (int)floorf((cy1 + 0.5f) * sy - 0.5f) + 1 + margin);
          win[l] = Window{x0, y0, x1 - x0 + 1, y1 - y0 + 1, 0};
          used += win[l].w * win[l].h;
        }
        if (used <= kWindowPx) break;
      }
      while (used > kWindowPx) {  // even without margins: drop the largest window
        int largest = 0;
        for (int l = 1; l < L; ++l)
          if (win[l].w * win[l].h > win[largest].w * win[largest].h) largest = l;
        used -= win[largest].w * win[largest].h;
        win[largest].w = win[largest].h = 0;
      }
      int base = 0;
      for (int l = 0; l < L; ++l) {
        win[l].base = base;
        base += win[l].w * win[l].h;
        s_win[l] = win[l];
      }
    }
    s_tile[0] = lq;
    s_tile[1] = tx * kTile;
    s_tile[2] = ty * kTile;
    s_tile[3] = used;
  }
  __syncthreads();
  const int lq = s_tile[0], used = s_tile[3];
  const int LP = L * P, records = kQueries * LP * 4;
  const Binned bn = binned(smem, records);
  for (int i = tid; i < used; i += kThreads) bn.cursor[i] = 0;

  int q;
  bool live;
  if (lq >= 0) {
    const int x = s_tile[1] + slot % kTile, y = s_tile[2] + slot / kTile;
    live = x < s_levels[3 * lq + 1] && y < s_levels[3 * lq];
    q = s_levels[3 * lq + 2] + y * s_levels[3 * lq + 1] + x;
  } else {
    q = blk * kQueries + slot;
    live = q < Q;
  }
  __syncthreads();  // the counts are zero

  // every lane stays in the shuffles; a group without a query adds and writes nothing
  const int pair = (b * Q + (live ? q : Q - 1)) * M + m;
  const T* loc_p = loc + (long long)pair * LP * 2;
  const T* attn_p = attn + (long long)pair * LP;
  const int pix_stride = M * kD;  // elements between pixels
  const long long lane_base = (long long)b * S * pix_stride + m * kD + lane * kVec;
  const T* base = value + lane_base;
  float* gbase = grad_value + lane_base;
  const float4 g = load_vec(grad_out + (long long)pair * kD + lane * kVec);
  if (used > 0) reinterpret_cast<float4*>(bn.g)[slot * kLanes + lane] = g;

  for (int first = 0; first < LP; first += kLanes) {
    // this lane's point of the round: its taps, and the factors of its gradients
    Taps mine = {{0, 0, 0, 0}, {0.f, 0.f, 0.f, 0.f}, {-1, -1, -1, -1}};
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
        const int ya = max(y0, 0), yb = min(y0 + 1, H - 1);
        const int ra = start + ya * W, rb = start + yb * W;
        mine.o[0] = (ra + xa) * pix_stride;
        mine.o[1] = (ra + xb) * pix_stride;
        mine.o[2] = (rb + xa) * pix_stride;
        mine.o[3] = (rb + xb) * pix_stride;
        mine.w[0] = a * by0 * bx0;
        mine.w[1] = a * by0 * bx1;
        mine.w[2] = a * by1 * bx0;
        mine.w[3] = a * by1 * bx1;
        const Window wn = s_win[l];
        const int cxa = xa - wn.x0, cxb = xb - wn.x0, cya = ya - wn.y0, cyb = yb - wn.y0;
        const bool in_xa = cxa >= 0 && cxa < wn.w, in_xb = cxb >= 0 && cxb < wn.w;
        const bool in_ya = cya >= 0 && cya < wn.h, in_yb = cyb >= 0 && cyb < wn.h;
        mine.s[0] = in_ya && in_xa ? wn.base + cya * wn.w + cxa : -1;
        mine.s[1] = in_ya && in_xb ? wn.base + cya * wn.w + cxb : -1;
        mine.s[2] = in_yb && in_xa ? wn.base + cyb * wn.w + cxa : -1;
        mine.s[3] = in_yb && in_xb ? wn.base + cyb * wn.w + cxb : -1;
      }
    }
    if (used > 0) {
      // the point's four records (a tap in no window, or of weight 0: -1), each
      // with its rank among the taps of its pixel: the lanes of the warp with
      // the same pixel take one count for all of them (__match_any_sync), so a
      // pixel's count is one shared-memory atomic a warp instruction
      const int warp_lane = tid & 31;
      #pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int at = (i < LP && live && mine.w[t] != 0.f) ? mine.s[t] : -1;
        const unsigned peers = __match_any_sync(kFullMask, at);
        const int leader = __ffs(peers) - 1;
        int first_rank = 0;
        if (at >= 0 && warp_lane == leader) first_rank = atomicAdd(bn.cursor + at, __popc(peers));
        first_rank = __shfl_sync(kFullMask, first_rank, leader);
        if (i < LP) {
          const int r = (slot * LP + i) * 4 + t;
          bn.rec_px[r] = at;
          bn.rec_w[r] = mine.w[t];
          bn.rec_rank[r] = (short)(first_rank + __popc(peers & ((1u << warp_lane) - 1)));
        }
      }
    }
    // <value[tap], g> of this lane's point, kept when its turn comes
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    // the round's points, kUnroll at a time so that their loads are in flight
    // together; a lane past the last point holds zero weights and offsets
    const int n = min(kLanes, LP - first);
    for (int k0 = 0; k0 < n; k0 += kUnroll) {
      int o[kUnroll][4], sp[kUnroll][4];
      float w[kUnroll][4];
      float4 x[kUnroll][4];
      #pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        #pragma unroll
        for (int t = 0; t < 4; ++t) {
          o[u][t] = __shfl_sync(kFullMask, mine.o[t], k0 + u, kLanes);
          w[u][t] = __shfl_sync(kFullMask, mine.w[t], k0 + u, kLanes);
          sp[u][t] = __shfl_sync(kFullMask, mine.s[t], k0 + u, kLanes);
          x[u][t] = load_vec(base + o[u][t]);
        }
      #pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        #pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float e = group_sum(dot_vec(x[u][t], g));
          if (lane == k0 + u) d[t] = e;
        }
      // a tap in a window waits for its pixel's sum
      if (live) {
        #pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          #pragma unroll
          for (int t = 0; t < 4; ++t)
            if (sp[u][t] < 0) add_tap(gbase, o[u][t], w[u][t], g);
      }
    }
    if (live && i < LP) {
      const float top = bx0 * d[0] + bx1 * d[1], bottom = bx0 * d[2] + bx1 * d[3];
      const float ga = by0 * top + by1 * bottom;
      const float gx =
          a * Wf * (by0 * (sx0 * d[0] + sx1 * d[1]) + by1 * (sx0 * d[2] + sx1 * d[3]));
      const float gy = a * Hf * (sy0 * top + sy1 * bottom);
      store_scalar(grad_attn + (long long)pair * LP + i, ga);
      store_xy(grad_loc + ((long long)pair * LP + i) * 2, gx, gy);
    }
  }
  if (used == 0) return;
  __syncthreads();  // every record and count written

  // the counts -> where each pixel's run starts (exclusive prefix sum), and the
  // list of pixels with any tap: a thread takes 8 consecutive pixels, the
  // warps and then the block scan the two sums
  __shared__ int s_warp_sum[2][kThreads / 32];
  __shared__ int s_touched, s_total;
  constexpr int kPer = kWindowPx / kThreads;
  int count[kPer], taps = 0, hit = 0;
  #pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int px = tid * kPer + j;
    count[j] = px < used ? bn.cursor[px] : 0;
    taps += count[j];
    hit += count[j] > 0;
  }
  int taps_in = taps, hit_in = hit;  // inclusive within the warp
  #pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFullMask, taps_in, d);
    const int y = __shfl_up_sync(kFullMask, hit_in, d);
    if ((tid & 31) >= d) { taps_in += x; hit_in += y; }
  }
  if ((tid & 31) == 31) { s_warp_sum[0][tid >> 5] = taps_in; s_warp_sum[1][tid >> 5] = hit_in; }
  __syncthreads();
  int taps_before = taps_in - taps, hit_before = hit_in - hit;
  for (int w = 0; w < (tid >> 5); ++w) {
    taps_before += s_warp_sum[0][w];
    hit_before += s_warp_sum[1][w];
  }
  if (tid == kThreads - 1) {
    s_touched = hit_before + hit;
    s_total = taps_before + taps;
  }
  #pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int px = tid * kPer + j;
    if (px < used) bn.cursor[px] = taps_before;
    if (count[j] > 0) bn.touched[hit_before++] = (short)px;
    taps_before += count[j];
  }
  __syncthreads();
  // each record to its place in its pixel's run: no atomics, the rank is known
  for (int r = tid; r < records; r += kThreads) {
    const int px = bn.rec_px[r];
    if (px >= 0) bn.order[bn.cursor[px] + bn.rec_rank[r]] = (short)r;
  }
  __syncthreads();

  // a group a touched pixel: the sum of its taps' w * g, then one 16-byte atomic a lane
  const int touched = s_touched, total = s_total;
  float* gb = grad_value + (long long)b * S * pix_stride + m * kD + lane * kVec;
  for (int k = slot; k < touched; k += kQueries) {
    const int px = bn.touched[k];
    const int begin = bn.cursor[px];
    const int end = px + 1 < used ? bn.cursor[px + 1] : total;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = begin; j < end; ++j) {
      const int r = bn.order[j];
      const float w = bn.rec_w[r];
      const float4 x = reinterpret_cast<const float4*>(bn.g)[(r / (LP * 4)) * kLanes + lane];
      acc.x = fmaf(w, x.x, acc.x);
      acc.y = fmaf(w, x.y, acc.y);
      acc.z = fmaf(w, x.z, acc.z);
      acc.w = fmaf(w, x.w, acc.w);
    }
    int l = 0;  // the level whose window holds px (windows lie in level order)
    while (px >= s_win[l].base + s_win[l].w * s_win[l].h) ++l;
    const Window wn = s_win[l];
    const int rel = px - wn.base;
    const int token = s_levels[3 * l + 2] + (wn.y0 + rel / wn.w) * s_levels[3 * l + 1] +
                      wn.x0 + rel % wn.w;
    atomicAdd(reinterpret_cast<float4*>(gb + (long long)token * pix_stride), acc);
  }
}

template <typename T>
cudaError_t launch(const void* grad_out, const void* value, const void* levels, const void* loc,
                   const void* attn, void* grad_value, void* grad_loc, void* grad_attn,
                   int B, int S, int Q, int M, int L, int P, int blocks_per_bm, int tiled,
                   int stage, cudaStream_t stream) {
  if ((long long)B * Q * M == 0) return cudaSuccess;
  if (L <= 0 || L > kMaxLevels || P <= 0 || S <= 0 || blocks_per_bm <= 0)
    return cudaErrorInvalidValue;
  // 32-bit pair indices and 32-bit element offsets inside a batch element; the
  // batch element's base is 64-bit
  if ((long long)B * Q * M > 0x7fffffffLL || (long long)S * M * kD > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)B * M * blocks_per_bm;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // windows for tiles of tokens only, and only where the records fit
  const bool windows = tiled && stage && L * P <= kMaxPoints;
  const int smem = windows ? binned_bytes(kQueries * L * P * 4) : 0;
  const int kMaxSmem = binned_bytes(kQueries * kMaxPoints * 4);
  static bool asked[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64 || !asked[device]) {
    err = cudaFuncSetAttribute(msda_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    if (device >= 0 && device < 64) asked[device] = true;
  }
  msda_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(grad_out), static_cast<const T*>(value),
      static_cast<const int*>(levels), static_cast<const T*>(loc), static_cast<const T*>(attn),
      static_cast<float*>(grad_value), static_cast<T*>(grad_loc), static_cast<T*>(grad_attn),
      S, Q, M, L, P, blocks_per_bm, tiled, windows);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer must be 16-byte aligned.
// grad_value is float32 for both types and must be zero on entry.
// blocks_per_bm: blocks per (batch, head); tiled = 1 (the queries are the
// tokens, Q = S): the sum over levels of ceil(H / 8) * ceil(W / 8), else
// ceil(Q / 64). stage = 1 bins the taps near a tile by pixel (tiled, L * P <=
// 64); 0 adds every tap to grad_value at once. Returns
// the launch's cudaError_t (0 = cudaSuccess); the launch is asynchronous on
// `stream`.
extern "C" int msda_bwd_binned(const void* grad_out, const void* value, const void* levels,
                        const void* loc, const void* attn, void* grad_value, void* grad_loc,
                        void* grad_attn, int B, int S, int Q, int M, int L, int P, int D,
                        int blocks_per_bm, int tiled, int stage, int dtype, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(grad_out, value, levels, loc, attn, grad_value, grad_loc,
                              grad_attn, B, S, Q, M, L, P, blocks_per_bm, tiled, stage, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(grad_out, value, levels, loc, attn, grad_value, grad_loc,
                                      grad_attn, B, S, Q, M, L, P, blocks_per_bm, tiled, stage,
                                      s);
  return (int)cudaErrorInvalidValue;
}
