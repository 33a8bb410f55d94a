// Host library of the port (C ABI, loaded with ctypes by utils/native.py).
//
// A copy of the JAX package's host library: greedy NMS, the IoU matrix, the
// fused uint8 -> mean-subtracted resized float32 blob, and the COCO greedy
// matcher. These serve the host side of evaluation (per-class NMS, COCO
// matching) and image preparation, as the reference's Cython extensions did.
//
// Built at first use by utils/native.py with the host C++ compiler:
//   c++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared -pthread
// (no -march=native: with FMA enabled the compiler may contract the bilinear
// blend of az_prep_blob into a fused multiply-add and round differently from
// the NumPy resize).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Greedy NMS over dets[n][5] = {x1,y1,x2,y2,score}, Caffe "+offset" areas,
// suppression at IoU > thresh. keep_out must hold n ints. Returns the number
// kept; indices are in score-descending order (ties: lower index first).
int az_nms(const float* dets, int n, float thresh, float offset,
           int* keep_out) {
  if (n <= 0) return 0;
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + offset) * (d[3] - d[1] + offset);
  }
  std::vector<char> suppressed(n, 0);
  int count = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[count++] = i;
    const float* di = dets + i * 5;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      const float iw =
          std::min(di[2], dj[2]) - std::max(di[0], dj[0]) + offset;
      if (iw <= 0) continue;
      const float ih =
          std::min(di[3], dj[3]) - std::max(di[1], dj[1]) + offset;
      if (ih <= 0) continue;
      const float inter = iw * ih;
      const float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return count;
}

// IoU matrix out[n][k] between boxes[n][4] and query[k][4].
void az_bbox_overlaps(const float* boxes, int n, const float* query, int k,
                      float offset, float* out) {
  std::vector<float> qarea(k);
  for (int j = 0; j < k; ++j) {
    const float* q = query + j * 4;
    qarea[j] = (q[2] - q[0] + offset) * (q[3] - q[1] + offset);
  }
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + i * 4;
    const float barea = (b[2] - b[0] + offset) * (b[3] - b[1] + offset);
    for (int j = 0; j < k; ++j) {
      const float* q = query + j * 4;
      const float iw = std::min(b[2], q[2]) - std::max(b[0], q[0]) + offset;
      const float ih = std::min(b[3], q[3]) - std::max(b[1], q[1]) + offset;
      float v = 0.f;
      if (iw > 0 && ih > 0) {
        const float inter = iw * ih;
        v = inter / (barea + qarea[j] - inter);
      }
      out[i * k + j] = v;
    }
  }
}

// Fused minibatch image prep: uint8 HWC (BGR) -> float32 canvas [oh][ow][3]:
// subtract per-channel means, bilinear resize by `scale` (half-pixel
// centers, cv2 convention), zero-pad beyond round(h*scale) x round(w*scale).
// Multithreaded over output rows.
void az_prep_blob(const uint8_t* src, int h, int w, float* dst, int oh,
                  int ow, float scale, const float* means) {
  const int vh = std::min(oh, (int)std::lround((double)h * scale));
  const int vw = std::min(ow, (int)std::lround((double)w * scale));
  std::memset(dst, 0, sizeof(float) * (size_t)oh * ow * 3);

  auto rows = [&](int y0, int y1) {
    for (int oy = y0; oy < y1; ++oy) {
      float sy = (oy + 0.5f) / scale - 0.5f;
      sy = std::min(std::max(sy, 0.f), (float)(h - 1));
      const int iy0 = (int)sy;
      const int iy1 = std::min(iy0 + 1, h - 1);
      const float fy = sy - iy0;
      float* out_row = dst + (size_t)oy * ow * 3;
      for (int ox = 0; ox < vw; ++ox) {
        float sx = (ox + 0.5f) / scale - 0.5f;
        sx = std::min(std::max(sx, 0.f), (float)(w - 1));
        const int ix0 = (int)sx;
        const int ix1 = std::min(ix0 + 1, w - 1);
        const float fx = sx - ix0;
        const uint8_t* p00 = src + ((size_t)iy0 * w + ix0) * 3;
        const uint8_t* p01 = src + ((size_t)iy0 * w + ix1) * 3;
        const uint8_t* p10 = src + ((size_t)iy1 * w + ix0) * 3;
        const uint8_t* p11 = src + ((size_t)iy1 * w + ix1) * 3;
        for (int c = 0; c < 3; ++c) {
          const float top = p00[c] + (p01[c] - p00[c]) * fx;
          const float bot = p10[c] + (p11[c] - p10[c]) * fx;
          out_row[ox * 3 + c] = top + (bot - top) * fy - means[c];
        }
      }
    }
  };

  const int nt = std::min((int)std::thread::hardware_concurrency(),
                          std::max(1, vh / 64));
  if (nt <= 1) {
    rows(0, vh);
  } else {
    std::vector<std::thread> pool;
    const int chunk = (vh + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      const int y0 = t * chunk;
      const int y1 = std::min(vh, y0 + chunk);
      if (y0 < y1) pool.emplace_back(rows, y0, y1);
    }
    for (auto& th : pool) th.join();
  }
}

// COCO-protocol greedy per-image matching (pycocotools evaluateImg inner
// loop; see eval/coco_eval.py::_match_image for the contract).
// ious[n_d][n_g] (detections score-desc, gts ignored-last), gt_ignore /
// crowd are n_g flags, thrs[n_t] IoU thresholds (already clamped by the
// caller). Outputs dtm/dtig are [n_t][n_d] 0/1 flags.
//
// Semantics: a taken non-crowd gt is skipped (crowds stay matchable); a
// detection takes the best-IoU available non-ignored gt >= thr, falling
// back to ignored gts only when no non-ignored one qualifies; ties keep
// the LAST qualifying gt in scan order (pycocotools updates on >=).
void az_coco_match(const double* ious, int n_d, int n_g,
                   const uint8_t* gt_ignore, const uint8_t* crowd,
                   const double* thrs, int n_t, uint8_t* dtm,
                   uint8_t* dtig) {
  std::memset(dtm, 0, (size_t)n_t * n_d);
  std::memset(dtig, 0, (size_t)n_t * n_d);
  if (n_d <= 0 || n_g <= 0) return;
  std::vector<char> gtaken(n_g);
  for (int t = 0; t < n_t; ++t) {
    const double thr = thrs[t];
    std::fill(gtaken.begin(), gtaken.end(), 0);
    for (int d = 0; d < n_d; ++d) {
      const double* row = ious + (size_t)d * n_g;
      int m = -1;
      double best = thr;
      // Stage 1: non-ignored gts (>= keeps the last tied gt).
      for (int g = 0; g < n_g; ++g) {
        if (gt_ignore[g] || (gtaken[g] && !crowd[g])) continue;
        if (row[g] >= best) { best = row[g]; m = g; }
      }
      if (m < 0) {  // Stage 2: ignored fallback.
        best = thr;
        for (int g = 0; g < n_g; ++g) {
          if (!gt_ignore[g] || (gtaken[g] && !crowd[g])) continue;
          if (row[g] >= best) { best = row[g]; m = g; }
        }
      }
      if (m >= 0) {
        gtaken[m] = 1;
        dtm[(size_t)t * n_d + d] = 1;
        dtig[(size_t)t * n_d + d] = gt_ignore[m];
      }
    }
  }
}

}  // extern "C"
