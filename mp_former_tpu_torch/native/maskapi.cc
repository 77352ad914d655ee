// COCO mask API, C++ implementation (pycocotools-equivalent semantics).
//
// The reference depends on pycocotools' C maskApi for polygon->RLE
// rasterization, RLE encode/decode/merge/area and mask IoU
// (convert_coco_poly_to_mask, coco_instance_new_baseline_dataset_mapper.py:20-34,
// and COCOeval). pycocotools is absent from this image, so this file provides
// the native equivalent: column-major RLE runs, polygon rasterization via the
// same 5x-upsampled boundary + parity fill scheme, and RLE-based IoU.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Polygon rasterization: polygon (xy float pairs) -> column-major byte mask.
// Follows the COCO scheme: scale coordinates by 5, draw the boundary with
// integer line stepping, then fill by column-parity of downsampled crossings.
// ---------------------------------------------------------------------------
void poly_to_mask(const double* xy, int n_vertices, int h, int w,
                  uint8_t* out /* h*w, column-major */) {
  const double scale = 5.0;
  int n = n_vertices;
  if (n < 3) return;
  std::vector<long> x(n + 1), y(n + 1);
  for (int j = 0; j < n; j++) {
    x[j] = (long)(scale * xy[2 * j + 0] + 0.5);
    y[j] = (long)(scale * xy[2 * j + 1] + 0.5);
  }
  x[n] = x[0];
  y[n] = y[0];

  // upsampled boundary points
  std::vector<int> u, v;
  for (int j = 0; j < n; j++) {
    long xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    long dx = std::labs(xe - xs), dy = std::labs(ye - ys);
    bool flip;
    double s;
    long m = std::max(dx, dy);
    if (dx >= dy) {
      flip = (dx == 0) ? false : (xe < xs);
      if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
      s = dx == 0 ? 0 : (double)(ye - ys) / dx;
      for (long d = 0; d <= dx; d++) {
        long t = flip ? dx - d : d;
        u.push_back((int)(t + xs));
        v.push_back((int)(ys + (long)std::lround(s * t)));
      }
    } else {
      flip = (ye < ys);
      if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
      s = dy == 0 ? 0 : (double)(xe - xs) / dy;
      for (long d = 0; d <= dy; d++) {
        long t = flip ? dy - d : d;
        v.push_back((int)(t + ys));
        u.push_back((int)(xs + (long)std::lround(s * t)));
      }
    }
    (void)m;
  }

  // downsample boundary to pixel grid crossings (COCO: k pixels entered
  // when moving down a column)
  int mlen = (int)u.size();
  std::vector<int> px, py;
  px.reserve(mlen);
  py.reserve(mlen);
  for (int j = 0; j < mlen; j++) {
    double xd = (double)u[j] / scale;
    double yd = (double)v[j] / scale;
    if (j > 0) {
      if (u[j] < u[j - 1]) xd = std::floor(xd) + 1 - 1e-9;  // moving left
    }
    int xi = (int)std::floor(xd);
    int yi = (int)std::floor(yd + 0.5 / scale);
    if (xi < 0) xi = 0;
    if (xi > w - 1) continue;
    if (yi < 0) yi = 0;
    if (yi > h) yi = h;
    if (px.empty() || px.back() != xi || py.back() != yi) {
      px.push_back(xi);
      py.push_back(yi);
    }
  }

  // parity fill per column: toggle at each boundary crossing (xi, yi)
  // crossing = where the boundary moves horizontally between columns
  std::vector<uint8_t> toggles(h * w, 0);
  int np = (int)px.size();
  for (int j = 1; j <= np; j++) {
    int j0 = j - 1, j1 = j % np;
    if (px[j0] != px[j1]) {
      int xi = std::min(px[j0], px[j1]);
      int yi = std::min(py[j0], py[j1]);
      if (xi >= 0 && xi < w && yi >= 0 && yi < h) toggles[xi * h + yi] ^= 1;
      else if (xi >= 0 && xi < w && yi >= h) { /* below image: no toggle */ }
    }
  }
  for (int c = 0; c < w; c++) {
    uint8_t inside = 0;
    for (int r = 0; r < h; r++) {
      inside ^= toggles[c * h + r];
      out[c * h + r] ^= inside;  // XOR so multi-polygon parts merge like COCO
    }
  }
}

// multiple polygons of one object: XOR-merge (COCO merges parts by union;
// parts don't overlap in practice, XOR == union then)
void polys_to_mask(const double* xy, const int* sizes, int n_polys, int h,
                   int w, uint8_t* out) {
  std::memset(out, 0, (size_t)h * w);
  const double* p = xy;
  for (int i = 0; i < n_polys; i++) {
    poly_to_mask(p, sizes[i], h, w, out);
    p += 2 * sizes[i];
  }
}

// ---------------------------------------------------------------------------
// RLE codec (column-major, alternating 0/1 run lengths starting with 0s)
// ---------------------------------------------------------------------------
int mask_to_rle(const uint8_t* mask /* column-major h*w */, int h, int w,
                uint32_t* counts /* caller-allocated h*w+1 */) {
  int n = h * w, k = 0;
  uint32_t run = 0;
  uint8_t cur = 0;
  for (int i = 0; i < n; i++) {
    if (mask[i] != cur) {
      counts[k++] = run;
      run = 0;
      cur = mask[i];
    }
    run++;
  }
  counts[k++] = run;
  return k;
}

void rle_to_mask(const uint32_t* counts, int n_counts, int h, int w,
                 uint8_t* out) {
  int pos = 0;
  uint8_t val = 0;
  for (int i = 0; i < n_counts; i++) {
    for (uint32_t j = 0; j < counts[i] && pos < h * w; j++) out[pos++] = val;
    val = !val;
  }
}

double rle_area(const uint32_t* counts, int n_counts) {
  double a = 0;
  for (int i = 1; i < n_counts; i += 2) a += counts[i];
  return a;
}

// IoU between two RLEs (no decode; walk runs)
double rle_iou(const uint32_t* a, int na, const uint32_t* b, int nb,
               int iscrowd) {
  double inter = 0, area_a = rle_area(a, na), area_b = rle_area(b, nb);
  // walk both run lists
  long pa = 0, pb = 0;
  int ia = 0, ib = 0;
  long ca = (na > 0) ? (long)a[0] : 0, cb = (nb > 0) ? (long)b[0] : 0;
  uint8_t va = 0, vb = 0;
  while (ia < na && ib < nb) {
    long step = std::min(ca, cb);
    if (va && vb) inter += step;
    ca -= step;
    cb -= step;
    if (ca == 0 && ++ia < na) { ca = a[ia]; va = !va; }
    if (cb == 0 && ++ib < nb) { cb = b[ib]; vb = !vb; }
  }
  double denom = iscrowd ? area_a : (area_a + area_b - inter);
  return denom > 0 ? inter / denom : 0.0;
}

}  // extern "C"
