// The KITTI protocol's greedy matcher, on the host, behind a plain C ABI.
//
// The reference runs it under numba JIT (mmdet3d/core/evaluation/
// kitti_utils/eval.py:160); here it is plain C++ for the host, built with
// g++ at first use and loaded through ctypes
// (imvoxelnet_tpu_torch/native/__init__.py).  Its plain version is
// eval/kitti_eval.py:compute_statistics, which the tests hold it to.  Taken
// from imvoxelnet_tpu/native/eval_kernels.cc; the rotated-rect areas and the
// host NMS stay there until a path of the port calls them.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

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

}  // extern "C"
