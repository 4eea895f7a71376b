// Host-side evaluation and post-process for mx_rcnn_tpu_torch: the greedy
// per-class NMS and the box IoU matrix of the host post-process, COCO RLE
// intersection and IoU, the RLE encoder of the device paste's bit-packed
// masks, and the fused paste + RLE of one mask probability map into its
// image frame.
//
// The same arithmetic as the JAX package's native library, so the two give
// equal kept lists and bitwise equal overlaps, counts and IoUs.  A plain C
// interface over raw pointers, loaded with ctypes by
// mx_rcnn_tpu_torch/native.py; built on first use with the host C++
// compiler into mx_rcnn_tpu_torch/_build/ (kernels/_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// (N,4) x (K,4) -> (N,K) IoU matrix, legacy +1 areas (bbox_overlaps).
void mxr_bbox_overlaps(const float* boxes, int64_t n, const float* query,
                       int64_t k, float* out) {
  for (int64_t j = 0; j < k; ++j) {
    const float qx1 = query[j * 4], qy1 = query[j * 4 + 1];
    const float qx2 = query[j * 4 + 2], qy2 = query[j * 4 + 3];
    const float qarea = (qx2 - qx1 + 1.f) * (qy2 - qy1 + 1.f);
    for (int64_t i = 0; i < n; ++i) {
      const float bx1 = boxes[i * 4], by1 = boxes[i * 4 + 1];
      const float bx2 = boxes[i * 4 + 2], by2 = boxes[i * 4 + 3];
      const float iw = std::min(bx2, qx2) - std::max(bx1, qx1) + 1.f;
      if (iw <= 0.f) { out[i * k + j] = 0.f; continue; }
      const float ih = std::min(by2, qy2) - std::max(by1, qy1) + 1.f;
      if (ih <= 0.f) { out[i * k + j] = 0.f; continue; }
      const float barea = (bx2 - bx1 + 1.f) * (by2 - by1 + 1.f);
      const float inter = iw * ih;
      out[i * k + j] = inter / (barea + qarea - inter);
    }
  }
}

// Greedy NMS over (N,5) [x1,y1,x2,y2,score], legacy +1 areas: rows in
// descending score, equal scores in row order (a stable sort); a row is
// dropped when its IoU with a kept row exceeds thresh.  Writes the kept
// row indices to keep_out (the caller allocates N) and returns their count.
int64_t mxr_nms(const float* dets, int64_t n, float thresh,
                int64_t* keep_out) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<char> removed(n, 0);
  std::vector<float> area(n);
  for (int64_t i = 0; i < n; ++i)
    area[i] = (dets[i * 5 + 2] - dets[i * 5] + 1.f) *
              (dets[i * 5 + 3] - dets[i * 5 + 1] + 1.f);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (removed[i]) continue;
    keep_out[kept++] = i;
    const float ix1 = dets[i * 5], iy1 = dets[i * 5 + 1];
    const float ix2 = dets[i * 5 + 2], iy2 = dets[i * 5 + 3];
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (removed[j]) continue;
      const float iw =
          std::min(ix2, dets[j * 5 + 2]) - std::max(ix1, dets[j * 5]) + 1.f;
      if (iw <= 0.f) continue;
      const float ih = std::min(iy2, dets[j * 5 + 3]) -
                       std::max(iy1, dets[j * 5 + 1]) + 1.f;
      if (ih <= 0.f) continue;
      const float inter = iw * ih;
      if (inter / (area[i] + area[j] - inter) > thresh) removed[j] = 1;
    }
  }
  return kept;
}

// Advance to the next run, skipping zero-length runs (each skipped run
// still toggles the value — an RLE starting with count 0 means the mask
// begins with foreground).
static inline void rle_advance(const uint32_t* c, int64_t nc, int64_t* i,
                               int64_t* cur, int* v, int64_t n) {
  do {
    ++*i;
    *cur = (*i < nc) ? (int64_t)c[*i] : n;
    *v ^= 1;
  } while (*cur == 0 && *i < nc);
}

// |A n B| for two column-major RLEs (counts arrays) over n pixels.
int64_t mxr_rle_intersect(const uint32_t* a, int64_t na, const uint32_t* b,
                          int64_t nb, int64_t n) {
  int64_t ia = 0, ib = 0, pos = 0, inter = 0;
  int64_t ca = na > 0 ? (int64_t)a[0] : n;
  int64_t cb = nb > 0 ? (int64_t)b[0] : n;
  int va = 0, vb = 0;
  if (ca == 0) rle_advance(a, na, &ia, &ca, &va, n);
  if (cb == 0) rle_advance(b, nb, &ib, &cb, &vb, n);
  while (pos < n) {
    const int64_t step = std::min(ca, cb);
    if (step <= 0) break;  // both exhausted (padding beyond counts)
    if (va && vb) inter += step;
    ca -= step; cb -= step; pos += step;
    if (ca == 0) rle_advance(a, na, &ia, &ca, &va, n);
    if (cb == 0) rle_advance(b, nb, &ib, &cb, &vb, n);
  }
  return inter;
}

// (D x G) RLE IoU with crowd semantics. Counts are flattened with offsets
// (CSR-style): d_counts/d_off (D+1), g_counts/g_off (G+1).
void mxr_rle_iou(const uint32_t* d_counts, const int64_t* d_off, int64_t D,
                 const uint32_t* g_counts, const int64_t* g_off, int64_t G,
                 const int64_t* d_area, const int64_t* g_area,
                 const uint8_t* g_crowd, int64_t n, double* out) {
  for (int64_t i = 0; i < D; ++i) {
    for (int64_t j = 0; j < G; ++j) {
      const int64_t inter =
          mxr_rle_intersect(d_counts + d_off[i], d_off[i + 1] - d_off[i],
                            g_counts + g_off[j], g_off[j + 1] - g_off[j], n);
      const double uni = g_crowd[j]
                             ? (double)d_area[i]
                             : (double)d_area[i] + g_area[j] - inter;
      out[i * G + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

}  // extern "C"

// Streaming column-major RLE cursor: counts alternate 0-run/1-run starting
// with the leading-zero count (possibly 0) — the maskApi.c rleEncode
// contract.  Feed bits/constant spans in scan order; finish() closes the
// final run.
namespace {
struct RleCursor {
  uint32_t* out;
  int64_t nc = 0;
  uint64_t run = 0;
  int cur = 0;
  void flip() {
    out[nc++] = (uint32_t)run;
    run = 0;
    cur ^= 1;
  }
  void flat(int64_t n, int val) {  // n pixels of constant `val`
    if (n <= 0) return;
    if (cur != val) flip();
    run += (uint64_t)n;
  }
  void bits(uint64_t v, int nbits) {  // nbits LSB-first bits of v
    int off = 0;
    while (off < nbits) {
      const uint64_t t = (cur ? ~v : v) >> off;
      int step = t ? __builtin_ctzll(t) : 64;
      if (step > nbits - off) step = nbits - off;
      if (step == 0) {  // bit differs from cur: close the current run
        flip();
        continue;
      }
      run += (uint64_t)step;
      off += step;
    }
  }
  int64_t finish() {
    out[nc++] = (uint32_t)run;
    return nc;
  }
};

// Bilinear source row/column for cv2-style resize of an m-bin axis to
// `extent` pixels: pixel j samples src=(j+.5)*m/extent-.5 between bins
// i0/i0+1 (border-replicate clamp), weight f on the upper bin.
inline void lerp_coeff(int64_t j, float scale, int64_t m, int* a0, int* a1,
                       float* f) {
  const float src = ((float)j + 0.5f) * scale - 0.5f;
  const float fl = std::floor(src);
  *f = src - fl;
  int i0 = (int)fl;
  *a0 = i0 < 0 ? 0 : (i0 > m - 1 ? (int)m - 1 : i0);
  ++i0;
  *a1 = i0 < 0 ? 0 : (i0 > m - 1 ? (int)m - 1 : i0);
}
}  // namespace

extern "C" {

// Column-major COCO RLE encode of one bit-packed transposed mask
// (ops/mask_paste.py layout: w columns of Hp/8 bytes, bit y&7 of byte
// [x*Hp/8 + (y>>3)] = pixel (y, x), LSB-first; Hp % 64 == 0 so columns
// stream as little-endian u64 words).  Scans exactly h bits of the first
// w columns (padding pixels beyond h/w are never read).  Returns the
// count length; caller provides counts_out of at least h*w + 1.
int64_t mxr_rle_encode(const uint8_t* packed, int64_t hp, int64_t h,
                       int64_t w, uint32_t* counts_out) {
  RleCursor rc{counts_out};
  const int64_t col_bytes = hp / 8;
  for (int64_t x = 0; x < w; ++x) {
    const uint8_t* col = packed + x * col_bytes;
    int64_t rem = h;
    for (int64_t k = 0; rem > 0; ++k, rem -= 64) {
      uint64_t v;
      std::memcpy(&v, col + 8 * k, 8);
      rc.bits(v, rem < 64 ? (int)rem : 64);
    }
  }
  return rc.finish();
}

// Fused paste + RLE of ONE (m, m) mask probability map into the (h, w)
// full frame at box [x1,y1,x2,y2] — the tester.paste_mask contract
// (integer window [floor,ceil], cv2 bilinear, threshold >= 0.5) without
// ever materializing the frame: separable resize streams column by
// column, and everything outside the box is emitted as bulk zero spans.
// Per-column upper/lower interpolation bounds skip all-background /
// all-foreground columns without per-pixel work.  Returns the count
// length; counts_out needs h*w + 1 (worst case).
int64_t mxr_paste_rle(const float* prob, int64_t m, float x1, float y1,
                      float x2, float y2, int64_t h, int64_t w,
                      uint32_t* counts_out) {
  const int64_t xa = (int64_t)std::floor(x1), xb = (int64_t)std::ceil(x2);
  const int64_t ya = (int64_t)std::floor(y1), yb = (int64_t)std::ceil(y2);
  const int64_t bw = std::max(xb - xa + 1, (int64_t)1);
  const int64_t bh = std::max(yb - ya + 1, (int64_t)1);
  const int64_t gx0 = std::max(xa, (int64_t)0), gx1 = std::min(xb, w - 1);
  const int64_t gy0 = std::max(ya, (int64_t)0), gy1 = std::min(yb, h - 1);
  RleCursor rc{counts_out};
  if (gx1 < gx0 || gy1 < gy0) {  // box entirely outside the frame
    rc.flat(h * w, 0);
    return rc.finish();
  }
  const int64_t nvis = gy1 - gy0 + 1;
  // G^T: (m, nvis) vertically-resized probabilities for the visible rows,
  // column-contiguous so the per-x lerp streams; plus per-bin min/max for
  // the column skip test.
  std::vector<float> gt((size_t)m * nvis), vbuf((size_t)nvis);
  std::vector<float> cmax(m, -1.f), cmin(m, 2.f);
  const float yscale = (float)m / (float)bh;
  for (int64_t jv = 0; jv < nvis; ++jv) {
    int a0, a1;
    float f;
    lerp_coeff(gy0 - ya + jv, yscale, m, &a0, &a1, &f);
    const float* r0 = prob + a0 * m;
    const float* r1 = prob + a1 * m;
    for (int64_t n = 0; n < m; ++n) {
      const float v = (1.0f - f) * r0[n] + f * r1[n];
      gt[(size_t)n * nvis + jv] = v;
      cmax[n] = std::max(cmax[n], v);
      cmin[n] = std::min(cmin[n], v);
    }
  }
  rc.flat(gx0 * h, 0);  // whole columns left of the box
  const float xscale = (float)m / (float)bw;
  for (int64_t x = gx0; x <= gx1; ++x) {
    int b0, b1;
    float fx;
    lerp_coeff(x - xa, xscale, m, &b0, &b1, &fx);
    rc.flat(gy0, 0);  // rows above the box in this column
    // v is a convex combination of bins b0/b1, so bin-wise extrema bound
    // every pixel in the column
    const float ub = std::max(cmax[b0], cmax[b1]);
    const float lb = std::min(cmin[b0], cmin[b1]);
    if (ub < 0.5f) {
      rc.flat(nvis, 0);
    } else if (lb >= 0.5f) {
      rc.flat(nvis, 1);
    } else {
      const float* ca = gt.data() + (size_t)b0 * nvis;
      const float* cb = gt.data() + (size_t)b1 * nvis;
      const float wa = 1.0f - fx;
      for (int64_t j = 0; j < nvis; ++j) vbuf[j] = wa * ca[j] + fx * cb[j];
      int64_t j = 0;
      while (j < nvis) {  // pack 64 threshold bits, then run-walk them
        const int nb = (int)std::min(nvis - j, (int64_t)64);
        uint64_t v = 0;
        for (int k = 0; k < nb; ++k)
          v |= (uint64_t)(vbuf[j + k] >= 0.5f) << k;
        rc.bits(v, nb);
        j += nb;
      }
    }
    rc.flat(h - 1 - gy1, 0);  // rows below the box
  }
  rc.flat((w - 1 - gx1) * h, 0);  // whole columns right of the box
  return rc.finish();
}

}  // extern "C"
