// The tensor-core form of K1 backward, measured beside the port's
// (csrc/msda_bwd.cu) by tools/probe_torch_msda_bwd_bound.py and not built into
// the port. Entry point msda_bwd_mma, the arguments of msda_bwd; only Q == S
// (every query a token, as in the encoder), P = 4, D = 32 and at most
// kMaxLevels levels (cudaErrorInvalidValue otherwise).
//
// The function is csrc/msda_bwd.cu's (see its note): per point, with bilinear
// weights b_t of its four taps t, attention weight a, g = grad_out[b, q, m, :]
// and d_t = <value[tap t], g>,
//
//   grad_value[tap t] += a b_t g,   grad_attn = sum_t b_t d_t,
//   grad_loc = a (W, H) sum_t (d b_t / d (x, y)) d_t.
//
// The block map and the windows are those of the window-stationary design
// (tools/probe_torch_msda_bwd_windows.cu): a block owns one (batch, head)
// and a kTile x kTile tile of the finest level with the tokens of every level
// under it (336 queries at the training levels), and each level gets a window
// of pixels around the tile, kMargin pixels wider on each side and moved by the
// mean offset of the block's points on that level. What differs is how the
// taps inside a window are summed: no float add on shared memory (which sm_90
// runs as a compare-and-swap loop). Per level, kChunk window pixels a pass:
// - A (pixels x the block's queries) in shared memory: each query's thread
//   writes its own column, a scalar a tap (a b_t), so no two threads add to
//   one word; the 16 x 8 tiles of A that took a tap on the map are flagged.
// - grad_window = A G on the tensor cores (mma.sync m16n8k8, 3xTF32; 2xTF32
//   where g is bfloat16 and so exact in TF32), the flagged k tiles only, each
//   warp a 16-pixel x 8-channel tile; its rows go to grad_value once, by
//   8-byte float32 atomics.
// - D = V Gᵀ (the window's value rows against every query's g), only on the
//   flagged tiles, written over A; a query reads d_t of its taps there.
// A tap on the map outside its window (a point far off, or a level without a
// window) is done by its query's thread alone: d_t from value in the L2 and
// the add by 16-byte float32 atomics. grad_attn and grad_loc are written once
// by the query's thread, in the input type; grad_value is float32 and
// reproducible to rounding only (atomics in no fixed order).
// kSplit = false computes the products with one TF32 term each (not the
// function to float32 accuracy; the probe uses it to bound the split's cost).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kD = 32;                    // channels per head
constexpr int kP = 4;                     // points per level
constexpr int kTaps = 4 * kP;             // a query's taps on one level
constexpr int kThreads = 512;
constexpr int kTile = 16;                 // a tile's side on the finest level, pixels
constexpr int kMargin = 4;                // pixels a window reaches beyond its tile
constexpr int kMaxLevels = 4;
constexpr int kMaxQueries = 512;          // a block's queries, at most (64 k tiles of 8)
constexpr int kChunk = 64;                // window pixels a pass: 4 m tiles of 16
constexpr int kMT = kChunk / 16;
constexpr int kGPitch = kD + 4;           // floats a row of G and of the value rows
constexpr int kAPitchMax = kMaxQueries + 4;
constexpr bool kSplit = true;             // 3xTF32 (2xTF32 for bfloat16 g)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSmemBytes = (kMaxQueries * kGPitch + kChunk * kAPitchMax + kChunk * kGPitch) * 4;

struct Level {
  int H, W, start;     // rows, columns, first token
  int wh, ww;          // window rows and columns (0: none)
  int r0, r1, c0, c1;  // the tile's rows [r0, r1) and columns [c0, c1)
  int wr0, wc0;        // the window's first row and column
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_scalar(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// four channels of one pixel row
__device__ __forceinline__ float4 load_vec(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_vec(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
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

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// c (16x8) += a (16x8: rows g, g+8, columns t, t+4) b (8x8: rows t, t+4, column g)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with a and b float32 split into (big, small) TF32 pairs; the term
// of a small part known to be 0 (an operand that is bfloat16) is left out
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_split(float (&c)[4], const float (&a)[4], float b0, float b1) {
  uint32_t ab[4], as[4], bb0, bs0, bb1, bs1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  if (kSplit) {
    if (!kAExact) mma_tf32(c, as, bb0, bb1);
    if (!kBExact) mma_tf32(c, ab, bs0, bs1);
  }
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ int floor_div(int a, int n) {  // n > 0
  return a >= 0 ? a / n : -((n - 1 - a) / n);
}

// token of the block's k-th query: the tile's tokens level by level, row by row
__device__ __forceinline__ int tile_token(const Level* lv, int L, int k) {
  for (int l = 0; l < L; ++l) {
    const int cols = lv[l].c1 - lv[l].c0, n = (lv[l].r1 - lv[l].r0) * cols;
    if (k < n) return lv[l].start + (lv[l].r0 + k / cols) * lv[l].W + lv[l].c0 + k % cols;
    k -= n;
  }
  return -1;
}

// T: grad_out and value; U: locations, weights and their gradients
template <typename T, typename U>
__global__ void __launch_bounds__(kThreads, 1)
msda_bwd_mma_kernel(const T* __restrict__ grad_out, const T* __restrict__ value,
                    const int* __restrict__ levels, const U* __restrict__ loc,
                    const U* __restrict__ attn, float* __restrict__ grad_value,
                    U* __restrict__ grad_loc, U* __restrict__ grad_attn,
                    int B, int S, int M, int L) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;  // g and value exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* sG = smem;                                  // (queries, kGPitch): g of each query
  float* sA = sG + kMaxQueries * kGPitch;            // (kChunk, pitch): A, then D
  float* sV = sA + kChunk * kAPitchMax;              // (kChunk, kGPitch): value's window rows
  __shared__ Level lv[kMaxLevels];
  __shared__ int s_sum[kMaxLevels][3];
  __shared__ int s_tiles_y, s_tiles_x, s_nq;
  __shared__ unsigned char s_flag[kMT][kMaxQueries / 8];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = S, LP = L * kP, pix_stride = M * kD;
  if (tid == 0) {
    int f = 0;
    for (int l = 0; l < L; ++l) {
      lv[l].H = levels[3 * l];
      lv[l].W = levels[3 * l + 1];
      lv[l].start = levels[3 * l + 2];
      if (lv[l].H * lv[l].W > lv[f].H * lv[f].W) f = l;
    }
    s_tiles_y = (lv[f].H + kTile - 1) / kTile;
    s_tiles_x = (lv[f].W + kTile - 1) / kTile;
    for (int l = 0; l < L; ++l) {
      lv[l].wh = min((lv[l].H + s_tiles_y - 1) / s_tiles_y + 2 * kMargin, lv[l].H);
      lv[l].ww = min((lv[l].W + s_tiles_x - 1) / s_tiles_x + 2 * kMargin, lv[l].W);
    }
  }
  __syncthreads();
  const int tiles = s_tiles_y * s_tiles_x;
  const long long items = (long long)B * M * tiles;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const int bm = (int)(item / tiles), t = (int)(item % tiles);
    const int b = bm / M, m = bm % M;
    if (tid < L) {
      const int i = t / s_tiles_x, j = t % s_tiles_x;
      Level& v = lv[tid];
      v.r0 = i * v.H / s_tiles_y;
      v.r1 = (i + 1) * v.H / s_tiles_y;
      v.c0 = j * v.W / s_tiles_x;
      v.c1 = (j + 1) * v.W / s_tiles_x;
    }
    if (tid < kMaxLevels * 3) s_sum[tid / 3][tid % 3] = 0;
    __syncthreads();
    if (tid == 0) {
      int nq = 0;
      for (int l = 0; l < L; ++l) nq += (lv[l].r1 - lv[l].r0) * (lv[l].c1 - lv[l].c0);
      s_nq = min(nq, kMaxQueries);
    }
    __syncthreads();
    const int nq = s_nq, nkt = (nq + 7) / 8, pitch = (nq + 31) / 32 * 32 + 4;
    const long long value_base = (long long)b * S * pix_stride + m * kD;

    // place the windows (the window-stationary design's rule): each point's
    // offset from the tile's middle on its level, clipped to the window's size,
    // summed as integers; the mean, rounded, centres the window
    {
      int sy[kMaxLevels], sx[kMaxLevels], cnt[kMaxLevels];
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) sy[l] = sx[l] = cnt[l] = 0;
      for (int e = tid; e < nq * LP; e += kThreads) {
        const int k = e / LP, r = e % LP, l = r / kP, p = r % kP;
        const Level& v = lv[l];
        const int pair = (b * Q + tile_token(lv, L, k)) * M + m;
        const float2 xy = load_xy(loc + ((long long)pair * LP + l * kP + p) * 2);
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
        if (lane == 0 && n > 0) {
          atomicAdd(&s_sum[l][0], a);
          atomicAdd(&s_sum[l][1], c);
          atomicAdd(&s_sum[l][2], n);
        }
      }
    }
    // g of every query of the block, rows past the last zero
    for (int e = tid; e < nkt * 8 * (kD / 4); e += kThreads) {
      const int k = e / (kD / 4), c = e % (kD / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < nq)
        x = load_vec(grad_out + ((long long)(b * Q + tile_token(lv, L, k)) * M + m) * kD + 4 * c);
      *reinterpret_cast<float4*>(sG + k * kGPitch + 4 * c) = x;
    }
    __syncthreads();
    if (tid < L) {
      Level& v = lv[tid];
      const int n = s_sum[tid][2];
      const int my = n > 0 ? floor_div(s_sum[tid][0] + n / 2, n) : 0;
      const int mx = n > 0 ? floor_div(s_sum[tid][1] + n / 2, n) : 0;
      const int cy = (v.r0 + v.r1 - 1) >> 1, cx = (v.c0 + v.c1 - 1) >> 1;
      v.wr0 = min(max(cy + my - (v.wh - 1) / 2, 0), v.H - v.wh);
      v.wc0 = min(max(cx + mx - (v.ww - 1) / 2, 0), v.W - v.ww);
    }
    __syncthreads();

    // this thread's query (none past the block's last)
    const int k = tid;
    const bool live = k < nq;
    const int pair = live ? (b * Q + tile_token(lv, L, k)) * M + m : 0;
    const float* gk = sG + (live ? k : 0) * kGPitch;

    for (int l = 0; l < L; ++l) {
      const Level& v = lv[l];
      const int H = v.H, W = v.W;
      // the query's taps on this level: place in the window (-1: outside,
      // -2: off the map or a point that does not count), a b_t, and d_t
      int ptap[kTaps];
      float wtap[kTaps], dtap[kTaps];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ptap[4 * p + c] = -2;
          wtap[4 * p + c] = 0.f;
          dtap[4 * p + c] = 0.f;
        }
        if (!live) continue;
        const float2 xy = load_xy(loc + ((long long)pair * LP + l * kP + p) * 2);
        const float x = xy.x * W - 0.5f, y = xy.y * H - 0.5f;
        const float x0f = floorf(x), y0f = floorf(y);
        if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)))
          continue;
        const float tx = x - x0f, ty = y - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const float a = to_float(attn[(long long)pair * LP + l * kP + p]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
          if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
          const float w = a * ((c >> 1) ? ty : 1.f - ty) * ((c & 1) ? tx : 1.f - tx);
          const int ry = yy - v.wr0, rx = xx - v.wc0;
          if ((unsigned)ry < (unsigned)v.wh && (unsigned)rx < (unsigned)v.ww) {
            ptap[4 * p + c] = ry * v.ww + rx;
            wtap[4 * p + c] = w;
            continue;
          }
          // outside the window: this thread alone, through the L2
          ptap[4 * p + c] = -1;
          const long long o = value_base + (long long)(v.start + yy * W + xx) * pix_stride;
          float d = 0.f;
#pragma unroll
          for (int q4 = 0; q4 < kD / 4; ++q4) {
            const float4 val = load_vec(value + o + 4 * q4);
            const float4 gg = *reinterpret_cast<const float4*>(gk + 4 * q4);
            d = fmaf(val.x, gg.x, fmaf(val.y, gg.y, fmaf(val.z, gg.z, fmaf(val.w, gg.w, d))));
            if (w != 0.f)
              atomicAdd(reinterpret_cast<float4*>(grad_value + o + 4 * q4),
                        make_float4(w * gg.x, w * gg.y, w * gg.z, w * gg.w));
          }
          dtap[4 * p + c] = d;
        }
      }

      const int npx = v.wh * v.ww;
      for (int c0 = 0; c0 < npx; c0 += kChunk) {
        __syncthreads();  // the last pass's reads of D are done
        // zero A and the flags; stage value's window rows c0 .. c0 + kChunk
        for (int i = tid; i < kChunk * pitch / 4; i += kThreads)
          reinterpret_cast<float4*>(sA)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = tid; i < kMT * (kMaxQueries / 8); i += kThreads) (&s_flag[0][0])[i] = 0;
        for (int i = tid; i < kChunk * (kD / 4); i += kThreads) {
          const int px = c0 + i / (kD / 4), c = i % (kD / 4);
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (px < npx) {
            const int tok = v.start + (v.wr0 + px / v.ww) * W + v.wc0 + px % v.ww;
            x = load_vec(value + value_base + (long long)tok * pix_stride + 4 * c);
          }
          *reinterpret_cast<float4*>(sV + (i / (kD / 4)) * kGPitch + 4 * c) = x;
        }
        __syncthreads();
        // A: this query's column, a b_t a tap; flag its 16 x 8 tiles
#pragma unroll
        for (int i = 0; i < kTaps; ++i) {
          const int r = ptap[i] - c0;
          if (r >= 0 && r < kChunk) {
            sA[r * pitch + k] += wtap[i];
            s_flag[r >> 4][k >> 3] = 1;
          }
        }
        __syncthreads();
        const int g = lane >> 2, tq = lane & 3;
        const int mt = warp >> 2, part = warp & 3;  // 16 warps: 4 m tiles x 4 parts
        {
          // grad_window's 16 pixels x 8 channels (part) = A G over the flagged k tiles
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          const float* a_lo = sA + (mt * 16 + g) * pitch + tq;
          const float* a_hi = a_lo + 8 * pitch;
          for (int kt = 0; kt < nkt; ++kt) {
            if (!s_flag[mt][kt]) continue;
            const float a[4] = {a_lo[kt * 8], a_hi[kt * 8], a_lo[kt * 8 + 4], a_hi[kt * 8 + 4]};
            const float* gb = sG + (kt * 8 + tq) * kGPitch + part * 8 + g;
            mma_split<false, kExact>(acc, a, gb[0], gb[4 * kGPitch]);
          }
          // flush: each window pixel row once, pixels that took nothing skipped
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int px = c0 + mt * 16 + g + 8 * h;
            const float x = acc[2 * h], y = acc[2 * h + 1];
            if (px < npx && (x != 0.f || y != 0.f)) {
              const int tok = v.start + (v.wr0 + px / v.ww) * W + v.wc0 + px % v.ww;
              atomicAdd(reinterpret_cast<float2*>(grad_value + value_base +
                                                  (long long)tok * pix_stride + part * 8 + 2 * tq),
                        make_float2(x, y));
            }
          }
        }
        __syncthreads();
        {
          // D = V Gᵀ on the flagged tiles, over A; a warp takes every 4th of its m tile's
          float va[kD / 8][4];
#pragma unroll
          for (int kk = 0; kk < kD / 8; ++kk) {
            const float* vr = sV + (mt * 16 + g) * kGPitch + kk * 8 + tq;
            va[kk][0] = vr[0];
            va[kk][1] = vr[8 * kGPitch];
            va[kk][2] = vr[4];
            va[kk][3] = vr[8 * kGPitch + 4];
          }
          int seen = 0;
          for (int kt = 0; kt < nkt; ++kt) {
            if (!s_flag[mt][kt]) continue;
            if ((seen++ & 3) != part) continue;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            const float* gr = sG + (kt * 8 + g) * kGPitch + tq;
#pragma unroll
            for (int kk = 0; kk < kD / 8; ++kk)
              mma_split<kExact, kExact>(acc, va[kk], gr[kk * 8], gr[kk * 8 + 4]);
            float* dr = sA + (mt * 16 + g) * pitch + kt * 8 + 2 * tq;
            *reinterpret_cast<float2*>(dr) = make_float2(acc[0], acc[1]);
            *reinterpret_cast<float2*>(dr + 8 * pitch) = make_float2(acc[2], acc[3]);
          }
        }
        __syncthreads();
        // d_t of this query's taps in the pass
#pragma unroll
        for (int i = 0; i < kTaps; ++i) {
          const int r = ptap[i] - c0;
          if (r >= 0 && r < kChunk) dtap[i] = sA[r * pitch + k];
        }
      }

      // grad_attn and grad_loc of the query's points on this level
      if (live) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const long long e = (long long)pair * LP + l * kP + p;
          const float2 xy = load_xy(loc + 2 * e);
          const float x = xy.x * W - 0.5f, y = xy.y * H - 0.5f;
          const float x0f = floorf(x), y0f = floorf(y);
          float ga = 0.f, gx = 0.f, gy = 0.f;
          if (x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f && y0f <= (float)(H - 1)) {
            const float tx = x - x0f, ty = y - y0f;
            const int x0 = (int)x0f, y0 = (int)y0f;
            const float a = to_float(attn[e]);
            const float bx0 = x0 >= 0 ? 1.f - tx : 0.f, bx1 = x0 + 1 < W ? tx : 0.f;
            const float by0 = y0 >= 0 ? 1.f - ty : 0.f, by1 = y0 + 1 < H ? ty : 0.f;
            const float sx0 = x0 >= 0 ? -1.f : 0.f, sx1 = x0 + 1 < W ? 1.f : 0.f;
            const float sy0 = y0 >= 0 ? -1.f : 0.f, sy1 = y0 + 1 < H ? 1.f : 0.f;
            const float d00 = dtap[4 * p], d01 = dtap[4 * p + 1];
            const float d10 = dtap[4 * p + 2], d11 = dtap[4 * p + 3];
            const float top = bx0 * d00 + bx1 * d01, bottom = bx0 * d10 + bx1 * d11;
            ga = by0 * top + by1 * bottom;
            gx = a * (float)W * (by0 * (sx0 * d00 + sx1 * d01) + by1 * (sx0 * d10 + sx1 * d11));
            gy = a * (float)H * (sy0 * top + sy1 * bottom);
          }
          store_scalar(grad_attn + e, ga);
          store_xy(grad_loc + 2 * e, gx, gy);
        }
      }
    }
    __syncthreads();  // the item's level table and G are done with
  }
}

template <typename T, typename U>
cudaError_t launch(const void* grad_out, const void* value, const void* levels, const void* loc,
                   const void* attn, void* grad_value, void* grad_loc, void* grad_attn,
                   int B, int S, int Q, int M, int L, int P, cudaStream_t stream) {
  if ((long long)B * Q * M == 0) return cudaSuccess;
  if (Q != S || P != kP || L <= 0 || L > kMaxLevels) return cudaErrorInvalidValue;
  if ((long long)B * Q * M > 0x7fffffffLL || (long long)S * M * kD > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  static int sms[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(msda_bwd_mma_kernel<T, U>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms[device] = n;
  }
  msda_bwd_mma_kernel<T, U><<<sms[device], kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(grad_out), static_cast<const T*>(value),
      static_cast<const int*>(levels), static_cast<const U*>(loc), static_cast<const U*>(attn),
      static_cast<float*>(grad_value), static_cast<U*>(grad_loc), static_cast<U*>(grad_attn),
      B, S, M, L);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = bfloat16 grad_out and value with
// float32 locations, weights and their gradients. Every pointer must be
// 16-byte aligned; grad_value is float32 and must be zero on entry. Returns
// the launch's cudaError_t; the launch (one kernel) is asynchronous on `stream`.
extern "C" int msda_bwd_mma(const void* grad_out, const void* value, const void* levels,
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
