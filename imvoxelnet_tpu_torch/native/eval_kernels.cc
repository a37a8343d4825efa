// The KITTI protocol's greedy matcher, and the rotated-rect areas and the
// greedy rotated NMS that serve as host oracles, behind a plain C ABI.
//
// The reference runs the matcher under numba JIT (mmdet3d/core/evaluation/
// kitti_utils/eval.py:160); here it is plain C++ for the host, built with
// g++ at first use and loaded through ctypes
// (imvoxelnet_tpu_torch/native/__init__.py).  Its plain version is
// eval/kitti_eval.py:compute_statistics, which the tests hold it to.  Taken
// from imvoxelnet_tpu/native/eval_kernels.cc.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// Corners of an (x, y, w, h, r) rect — same row-vector rotation convention
// as ops/boxes.py::bev_corners.
void rect_corners(const double* b, Pt* out) {
  const double c = std::cos(b[4]), s = std::sin(b[4]);
  const double tx[4] = {b[2] / 2, -b[2] / 2, -b[2] / 2, b[2] / 2};
  const double ty[4] = {b[3] / 2, b[3] / 2, -b[3] / 2, -b[3] / 2};
  for (int i = 0; i < 4; ++i) {
    out[i].x = tx[i] * c + ty[i] * s + b[0];
    out[i].y = -tx[i] * s + ty[i] * c + b[1];
  }
}

double polygon_area(const Pt* pts, int n) {
  double a = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    a += p.x * q.y - p.y * q.x;
  }
  return std::abs(a) / 2;
}

// Sutherland–Hodgman clip of convex polygon `subject` by convex `clip`.
int clip_polygon(const Pt* subject, int n_subj, const Pt* clip, int n_clip,
                 Pt* out) {
  Pt buf_a[16], buf_b[16];
  int n = n_subj;
  std::memcpy(buf_a, subject, n * sizeof(Pt));
  Pt* cur = buf_a;
  Pt* nxt = buf_b;
  // determine clip orientation
  double orient = 0;
  for (int i = 0; i < n_clip; ++i) {
    const Pt& a = clip[i];
    const Pt& b = clip[(i + 1) % n_clip];
    orient += (b.x - a.x) * (b.y + a.y);
  }
  const double sign = orient < 0 ? 1.0 : -1.0;
  for (int e = 0; e < n_clip && n > 0; ++e) {
    const Pt& a = clip[e];
    const Pt& b = clip[(e + 1) % n_clip];
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const Pt& p = cur[i];
      const Pt& q = cur[(i + 1) % n];
      const double dp = sign * ((b.x - a.x) * (p.y - a.y) -
                                (b.y - a.y) * (p.x - a.x));
      const double dq = sign * ((b.x - a.x) * (q.y - a.y) -
                                (b.y - a.y) * (q.x - a.x));
      if (dp >= 0) {
        nxt[m++] = p;
      }
      if ((dp >= 0) != (dq >= 0)) {
        const double t = dp / (dp - dq);
        nxt[m].x = p.x + t * (q.x - p.x);
        nxt[m].y = p.y + t * (q.y - p.y);
        ++m;
      }
    }
    std::swap(cur, nxt);
    n = m;
  }
  std::memcpy(out, cur, n * sizeof(Pt));
  return n;
}

}  // namespace

extern "C" {

// Pairwise rotated-rect intersection areas: boxes (n, 5) xywhr, out (n, k).
void rect_intersection_areas(const double* boxes1, int64_t n,
                             const double* boxes2, int64_t k, double* out) {
  std::vector<Pt> c2(k * 4);
  for (int64_t j = 0; j < k; ++j) rect_corners(boxes2 + j * 5, &c2[j * 4]);
  Pt c1[4], poly[16];
  for (int64_t i = 0; i < n; ++i) {
    rect_corners(boxes1 + i * 5, c1);
    for (int64_t j = 0; j < k; ++j) {
      const int m = clip_polygon(c1, 4, &c2[j * 4], 4, poly);
      out[i * k + j] = m >= 3 ? polygon_area(poly, m) : 0.0;
    }
  }
}


// The greedy TP/FP/FN matcher of compute_statistics_jit (eval.py:160-278),
// evaluated for `n_thresh` score thresholds in one call (compute_fp mode).
// overlaps: (n_dt, n_gt) row-major.  dc_overlaps: (n_dt, n_dc) image-IoF
// against DontCare boxes (pass n_dc = 0 when metric != 0).
// out_pr: (n_thresh, 4) accumulated in place (tp, fp, fn, similarity).
void compute_statistics_thresholds(
    const double* overlaps, int64_t n_dt, int64_t n_gt,
    const double* dt_scores, const double* dt_alphas, const double* gt_alphas,
    const int64_t* ignored_gt, const int64_t* ignored_det,
    const double* dc_overlaps, int64_t n_dc, double min_overlap,
    const double* thresholds, int64_t n_thresh, int compute_aos,
    double* out_pr) {
  std::vector<char> assigned(n_dt);
  std::vector<char> ignored_thresh(n_dt);
  std::vector<double> deltas;
  for (int64_t t = 0; t < n_thresh; ++t) {
    const double thresh = thresholds[t];
    std::fill(assigned.begin(), assigned.end(), 0);
    for (int64_t j = 0; j < n_dt; ++j)
      ignored_thresh[j] = dt_scores[j] < thresh;
    int64_t tp = 0, fp = 0, fn = 0;
    deltas.clear();
    for (int64_t i = 0; i < n_gt; ++i) {
      if (ignored_gt[i] == -1) continue;
      int64_t det_idx = -1;
      bool found = false;
      double max_overlap = 0;
      bool assigned_ignored = false;
      for (int64_t j = 0; j < n_dt; ++j) {
        if (ignored_det[j] == -1 || assigned[j] || ignored_thresh[j]) continue;
        const double ov = overlaps[j * n_gt + i];
        if (ov > min_overlap && (ov > max_overlap || assigned_ignored) &&
            ignored_det[j] == 0) {
          max_overlap = ov;
          det_idx = j;
          found = true;
          assigned_ignored = false;
        } else if (ov > min_overlap && !found && ignored_det[j] == 1) {
          det_idx = j;
          found = true;
          assigned_ignored = true;
        }
      }
      if (!found && ignored_gt[i] == 0) {
        ++fn;
      } else if (found && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
        assigned[det_idx] = 1;
      } else if (found) {
        ++tp;
        if (compute_aos) deltas.push_back(gt_alphas[i] - dt_alphas[det_idx]);
        assigned[det_idx] = 1;
      }
    }
    for (int64_t j = 0; j < n_dt; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_thresh[j]))
        ++fp;
    }
    int64_t nstuff = 0;
    if (n_dc > 0) {
      for (int64_t i = 0; i < n_dc; ++i) {
        for (int64_t j = 0; j < n_dt; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ignored_thresh[j])
            continue;
          if (dc_overlaps[j * n_dc + i] > min_overlap) {
            assigned[j] = 1;
            ++nstuff;
          }
        }
      }
    }
    fp -= nstuff;
    double similarity = 0;
    if (compute_aos) {
      for (double d : deltas) similarity += (1.0 + std::cos(d)) / 2.0;
      if (tp == 0 && fp == 0) similarity = -1;
    }
    out_pr[t * 4 + 0] += tp;
    out_pr[t * 4 + 1] += fp;
    out_pr[t * 4 + 2] += fn;
    if (!compute_aos || similarity != -1) out_pr[t * 4 + 3] += similarity;
  }
}

// Greedy rotated-BEV NMS on the host (a host oracle; the NMS on the card is
// ops/nms.py's mask and scan kernels).
// boxes: (n, 5) xywhr, scores (n,); keep flags out (n,).
void rotated_nms_host(const double* boxes, const double* scores, int64_t n,
                      double iou_thr, uint8_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });
  std::vector<char> suppressed(n, 0);
  std::vector<double> areas(n);
  for (int64_t i = 0; i < n; ++i)
    areas[i] = boxes[i * 5 + 2] * boxes[i * 5 + 3];
  Pt ci[4], cj[4], poly[16];
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) {
      keep[i] = 0;
      continue;
    }
    keep[i] = 1;
    rect_corners(boxes + i * 5, ci);
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      rect_corners(boxes + j * 5, cj);
      const int m = clip_polygon(ci, 4, cj, 4, poly);
      const double inter = m >= 3 ? polygon_area(poly, m) : 0.0;
      const double iou = inter / std::max(areas[i] + areas[j] - inter, 1e-12);
      if (iou > iou_thr) suppressed[j] = 1;
    }
  }
}

}  // extern "C"
