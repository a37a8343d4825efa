"""KITTI evaluation protocol on the host (numpy and native C++).

Counterpart of ``imvoxelnet_tpu/eval/kitti_eval.py``: the same functions and
the same numbers.  The overlaps stay numpy in double (the protocol's
thresholds sit at 0.5 / 0.7); the greedy matcher over every score threshold
runs in ``native/eval_kernels.cc``, which raises where it cannot be built
(the JAX package falls back to numpy there).  ``compute_statistics`` and
``_rect_intersection_np`` are the plain versions of the native functions.

Reference: ``mmdet3d/core/evaluation/kitti_utils/eval.py`` —
``get_thresholds`` (:8-25), ``clean_data`` (:28-81), overlap kernels
(:83-158, with the numba-CUDA ``rotate_iou.py`` replaced by a vectorised
numpy rotated-rect clipper), ``compute_statistics_jit`` (:160-278),
``eval_class`` (:450-570), ``get_mAP`` 11-point sampling (:573-577), and
``kitti_eval`` (:643-775).

Also provides ``convert_to_kitti_annos``: the lidar-prediction -> KITTI
camera-frame anno conversion of ``KittiDataset.convert_valid_bboxes`` /
``bbox2result_kitti`` (``kitti_dataset.py:360-474, 587-671``), including the
yaw -pi hack (:616-617).
"""

from __future__ import annotations

import numpy as np

from .. import native


CLASS_NAMES = ['car', 'pedestrian', 'cyclist']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


# ---------------------------------------------------------------------------
# Overlap kernels
# ---------------------------------------------------------------------------

def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D IoU / IoF on (x1, y1, x2, y2) boxes; (N, K)."""
    n, k = len(boxes), len(query_boxes)
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    if criterion == -1:
        ua = area_b[:, None] + area_q[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b[:, None], inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q[None, :], inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / np.maximum(ua, 1e-12), 0.0)


def _rect_corners(boxes):
    """(N, 5) xywhr -> (N, 4, 2) corners (same convention as ops/boxes.py)."""
    x, y, w, h, r = (boxes[:, i] for i in range(5))
    tx = np.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    ty = np.stack([h / 2, h / 2, -h / 2, -h / 2], -1)
    c, s = np.cos(r)[:, None], np.sin(r)[:, None]
    rx = tx * c + ty * s
    ry = -tx * s + ty * c
    return np.stack([rx + x[:, None], ry + y[:, None]], -1)


def _rect_intersection_np(c1, c2):
    """Pairwise rotated-rect intersection areas from corners.

    c1 (N, 4, 2), c2 (K, 4, 2) -> (N, K).  Vectorised numpy twin of
    ``ops/iou.py:rect_intersection_area``.
    """
    n, k = len(c1), len(c2)
    if n == 0 or k == 0:
        return np.zeros((n, k))
    a1 = c1[:, None]                          # (N, 1, 4, 2)
    a2 = c2[None, :]                          # (1, K, 4, 2)
    p1, q1 = a1, np.roll(a1, -1, axis=-2)
    p2, q2 = a2, np.roll(a2, -1, axis=-2)
    p1b, q1b = p1[..., :, None, :], q1[..., :, None, :]
    p2b, q2b = p2[..., None, :, :], q2[..., None, :, :]
    d1 = q1b - p1b
    d2 = q2b - p2b
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    safe = np.abs(denom) > 1e-10
    denom = np.where(safe, denom, 1.0)
    w = p2b - p1b
    t = (w[..., 0] * d2[..., 1] - w[..., 1] * d2[..., 0]) / denom
    u = (w[..., 0] * d1[..., 1] - w[..., 1] * d1[..., 0]) / denom
    inter_mask = safe & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    inter_pts = np.where(inter_mask[..., None], p1b + t[..., None] * d1, 0.0)
    inter_pts = inter_pts.reshape(n, k, 16, 2)
    inter_mask = inter_mask.reshape(n, k, 16)

    def in_rect(points, rect):
        a = rect
        b = np.roll(rect, -1, axis=-2)
        ab = (b - a)[..., None, :, :]
        ap = points[..., :, None, :] - a[..., None, :, :]
        cross = ab[..., 0] * ap[..., 1] - ab[..., 1] * ap[..., 0]
        return (np.all(cross >= -1e-9, -1) | np.all(cross <= 1e-9, -1))

    in2 = in_rect(np.broadcast_to(a1, (n, k, 4, 2)),
                  np.broadcast_to(a2, (n, k, 4, 2)))
    in1 = in_rect(np.broadcast_to(a2, (n, k, 4, 2)),
                  np.broadcast_to(a1, (n, k, 4, 2)))
    pts = np.concatenate([inter_pts,
                          np.broadcast_to(a1, (n, k, 4, 2)),
                          np.broadcast_to(a2, (n, k, 4, 2))], axis=2)
    mask = np.concatenate([inter_mask, in2, in1], axis=2)   # (N, K, 24)

    num = np.maximum(mask.sum(-1, keepdims=True), 1)
    center = (pts * mask[..., None]).sum(2, keepdims=True) / num[..., None]
    rel = pts - center
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(mask, ang, 1e6)
    order = np.argsort(ang, axis=-1)
    pts_s = np.take_along_axis(pts, order[..., None], axis=2)
    mask_s = np.take_along_axis(mask, order, axis=2)
    first = pts_s[:, :, :1]
    pts_c = np.where(mask_s[..., None], pts_s, first)
    nxt = np.roll(pts_c, -1, axis=2)
    cross = pts_c[..., 0] * nxt[..., 1] - pts_c[..., 1] * nxt[..., 0]
    area = 0.5 * np.abs(cross.sum(-1))
    return np.where(num[..., 0] > 2, area, 0.0)


def rotate_iou_eval(boxes, qboxes, criterion=-1):
    """Rotated-rect overlap, criterion -1: IoU, 2: intersection area.

    Twin of ``rotate_iou_gpu_eval`` (``kitti_utils/rotate_iou.py``).
    """
    inter = _rect_intersection_np(_rect_corners(boxes), _rect_corners(qboxes))
    if criterion == 2:
        return inter
    a1 = boxes[:, 2] * boxes[:, 3]
    a2 = qboxes[:, 2] * qboxes[:, 3]
    if criterion == -1:
        ua = a1[:, None] + a2[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(a1[:, None], inter.shape)
    else:
        ua = np.broadcast_to(a2[None, :], inter.shape)
    return inter / np.maximum(ua, 1e-12)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D IoU (``eval.py:119-158``): rotated (x, z) area x
    y-interval (y is the box *bottom*, height extends to -y)."""
    rinc = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]],
                           qboxes[:, [0, 2, 3, 5, 6]], 2)
    n, k = rinc.shape
    y1 = boxes[:, 1][:, None]
    y2 = qboxes[:, 1][None, :]
    h1 = boxes[:, 4][:, None]
    h2 = qboxes[:, 4][None, :]
    iw = np.minimum(y1, y2) - np.maximum(y1 - h1, y2 - h2)
    area1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    area2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.clip(iw, 0, None) * rinc
    if criterion == -1:
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(area1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area2, inc.shape)
    else:
        ua = inc
    out = np.where((iw > 0) & (rinc > 0), inc / np.maximum(ua, 1e-12), 0.0)
    return out


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall))
                and (i < len(scores) - 1)):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    cls_name = CLASS_NAMES[current_class]
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno['name'])):
        bbox = gt_anno['bbox'][i]
        gt_name = str(gt_anno['name'][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno['name'][i]) == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(len(dt_anno['name'])):
        valid_class = 1 if str(dt_anno['name'][i]).lower() == cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = (np.stack(dc_bboxes).astype(np.float64) if dc_bboxes
          else np.zeros((0, 4)))
    return num_valid_gt, np.array(ignored_gt), np.array(ignored_dt), dc


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy matching (``eval.py:160-278``); overlaps is (n_dt, n_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp else np.zeros(
        det_size, bool)
    NO_DET = -1e7
    tp = fp = fn = 0
    similarity = 0.0
    thresholds, deltas = [], []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DET
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DET and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DET
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned[det_idx] = True
        elif valid_detection != NO_DET:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc_bboxes, 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in deltas]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def _per_image_overlaps(gt_annos, dt_annos, metric):
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            ov = image_box_overlap(np.asarray(dt['bbox'], np.float64),
                                   np.asarray(gt['bbox'], np.float64))
        elif metric == 1:
            def bev(a):
                return np.concatenate(
                    [a['location'][:, [0, 2]], a['dimensions'][:, [0, 2]],
                     a['rotation_y'][:, None]], 1).astype(np.float64)
            ov = bev_box_overlap(bev(dt), bev(gt))
        else:
            def full(a):
                return np.concatenate(
                    [a['location'], a['dimensions'],
                     a['rotation_y'][:, None]], 1).astype(np.float64)
            ov = d3_box_overlap(full(dt), full(gt))
        overlaps.append(ov)
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """(``eval.py:450-570``) returns precision/recall/aos arrays
    ``[n_class, n_difficulty, n_minoverlap, 41]``.  The counts at every
    threshold come from ``native.compute_statistics_thresholds``, whose
    plain version is :func:`compute_statistics`."""
    overlaps = _per_image_overlaps(gt_annos, dt_annos, metric)
    num_minoverlap = min_overlaps.shape[0]
    precision = np.zeros([len(current_classes), len(difficultys),
                          num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for d_idx, difficulty in enumerate(difficultys):
            prep = [clean_data(gt_annos[i], dt_annos[i], current_class,
                               difficulty) for i in range(len(gt_annos))]
            total_num_valid_gt = sum(p[0] for p in prep)
            gt_datas = [np.concatenate(
                [gt_annos[i]['bbox'],
                 np.asarray(gt_annos[i]['alpha'])[:, None]], 1)
                for i in range(len(gt_annos))]
            dt_datas = [np.concatenate(
                [dt_annos[i]['bbox'],
                 np.asarray(dt_annos[i]['alpha'])[:, None],
                 np.asarray(dt_annos[i]['score'])[:, None]], 1)
                for i in range(len(dt_annos))]
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                all_thresholds = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = compute_statistics(
                        overlaps[i], gt_datas[i], dt_datas[i], prep[i][1],
                        prep[i][2], prep[i][3], metric, min_overlap,
                        compute_fp=False)
                    all_thresholds += th.tolist()
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(np.array(all_thresholds),
                                            total_num_valid_gt)
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    dc = prep[i][3]
                    if metric == 0 and len(dc):
                        dc_overlaps = image_box_overlap(
                            dt_datas[i][:, :4], dc, 0)
                    else:
                        dc_overlaps = np.zeros((len(dt_datas[i]), 0))
                    native.compute_statistics_thresholds(
                        overlaps[i], dt_datas[i][:, -1],
                        dt_datas[i][:, 4], gt_datas[i][:, 4],
                        prep[i][1].astype(np.int64),
                        prep[i][2].astype(np.int64), dc_overlaps,
                        min_overlap, thresholds, int(compute_aos), pr)
                for i in range(len(thresholds)):
                    recall[m, d_idx, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, d_idx, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, d_idx, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, d_idx, k, i] = np.max(
                        precision[m, d_idx, k, i:])
                    recall[m, d_idx, k, i] = np.max(recall[m, d_idx, k, i:])
                    if compute_aos:
                        aos[m, d_idx, k, i] = np.max(aos[m, d_idx, k, i:])
    return dict(recall=recall, precision=precision, orientation=aos)


def get_mAP(prec):
    """11-point AP over the 41 samples (``eval.py:573-577``)."""
    return prec[..., ::4].sum(-1) / 11 * 100


def get_mAP_R40(prec):
    """40-recall-position AP (the official KITTI protocol since 2019; the
    reference pins the older 11-point variant — both are reported here)."""
    return prec[..., 1:].sum(-1) / 40 * 100


def kitti_eval(gt_annos, dt_annos, current_classes,
               eval_types=('bbox', 'bev', '3d')):
    """Full protocol (``eval.py:643-775``); returns the reference's flat
    metric dict (``KITTI/{cls}_{type}_{difficulty}``)."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5]])
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], 0)  # [2, 3, 5]
    name_to_class = {'Car': 0, 'Pedestrian': 1, 'Cyclist': 2}
    class_ints = [name_to_class[c] if isinstance(c, str) else c
                  for c in current_classes]
    min_overlaps = min_overlaps[:, :, class_ints]
    difficultys = [0, 1, 2]
    diff_names = ['easy', 'moderate', 'hard']

    results = {}
    compute_aos = 'aos' in eval_types
    ret = {}
    if 'bbox' in eval_types:
        ret['bbox'] = eval_class(gt_annos, dt_annos, class_ints, difficultys,
                                 0, min_overlaps, compute_aos)
    if 'bev' in eval_types:
        ret['bev'] = eval_class(gt_annos, dt_annos, class_ints, difficultys,
                                1, min_overlaps)
    if '3d' in eval_types:
        ret['3d'] = eval_class(gt_annos, dt_annos, class_ints, difficultys,
                               2, min_overlaps)

    for metric_name, r in ret.items():
        mAP = get_mAP(r['precision'])  # [cls, diff, minoverlap]
        mAP40 = get_mAP_R40(r['precision'])
        for m, cls in enumerate(current_classes):
            cls_name = cls if isinstance(cls, str) else CLASS_NAMES[cls]
            for d, dn in enumerate(diff_names):
                for k, strictness in enumerate(('strict', 'loose')):
                    key = f'KITTI/{cls_name}_{metric_name.upper()}_{dn}'
                    if strictness == 'strict':
                        results[key] = float(mAP[m, d, k])
                        results[key + '_R40'] = float(mAP40[m, d, k])
                    else:
                        results[key + '_loose'] = float(mAP[m, d, k])
        if metric_name == 'bbox' and compute_aos:
            mAOS = get_mAP(r['orientation'])
            for m, cls in enumerate(current_classes):
                cls_name = cls if isinstance(cls, str) else CLASS_NAMES[cls]
                for d, dn in enumerate(diff_names):
                    results[f'KITTI/{cls_name}_AOS_{dn}'] = float(mAOS[m, d, 0])
    return results


# ---------------------------------------------------------------------------
# Prediction -> KITTI anno conversion
# ---------------------------------------------------------------------------

PCD_LIMIT_RANGE = np.array([0, -40, -3, 70.4, 40, 0.0], np.float32)


def _camera_corners(boxes_cam):
    """Corners of camera-frame boxes (x, y, z, l, h, w, ry); origin
    (0.5, 1.0, 0.5), yaw about y (``cam_box3d.py``)."""
    n = len(boxes_cam)
    dims = boxes_cam[:, 3:6]
    # reference corners_norm: unravel over [2,2,2] gives (x, y, z) bits
    template = np.stack(np.unravel_index(np.arange(8), (2, 2, 2)), 1).astype(
        np.float64)
    corners_norm = template - np.array([0.5, 1.0, 0.5])
    pts = corners_norm[None] * dims[:, None, :]
    ry = boxes_cam[:, 6]
    c, s = np.cos(ry), np.sin(ry)
    # rotation about y axis, row-vector convention (utils.py:40-45)
    rot = np.zeros((n, 3, 3))
    rot[:, 0, 0] = c
    rot[:, 0, 2] = s
    rot[:, 1, 1] = 1
    rot[:, 2, 0] = -s
    rot[:, 2, 2] = c
    pts = np.einsum('nmj,njk->nmk', pts, rot)
    return pts + boxes_cam[:, None, :3]


def convert_to_kitti_annos(predictions, infos, class_names):
    """Per-image predictions (lidar boxes) -> KITTI camera annos.

    Args:
      predictions: list of dict(boxes (N, 7) lidar bottom-center, scores,
        labels) — already masked to valid detections.
      infos: the kitti info dicts (for calib + image shape).
    """
    det_annos = []
    for pred, info in zip(predictions, infos):
        boxes = np.asarray(pred['boxes'], np.float32).reshape(-1, 7).copy()
        scores = np.asarray(pred['scores'], np.float32).reshape(-1)
        labels = np.asarray(pred['labels'], np.int64).reshape(-1)

        anno = dict(name=[], truncated=[], occluded=[], alpha=[], bbox=[],
                    dimensions=[], location=[], rotation_y=[], score=[])
        if len(boxes):
            # yaw hack + limit (kitti_dataset.py:616-618)
            boxes[:, 6] -= np.pi
            boxes[:, 6] -= np.floor(boxes[:, 6] / (2 * np.pi) + 0.5) * 2 * np.pi

            rect = info['calib']['R0_rect'].astype(np.float32)
            trv2c = info['calib']['Tr_velo_to_cam'].astype(np.float32)
            p2 = info['calib']['P2'].astype(np.float32)
            img_shape = info['image']['image_shape']

            rt = rect @ trv2c
            xyz1 = np.concatenate([boxes[:, :3], np.ones((len(boxes), 1))], 1)
            xyz_cam = (xyz1 @ rt.T)[:, :3]
            # lidar sizes (w, l, h) -> cam (l, h, w) (box_3d_mode.py:105-107)
            sizes_cam = boxes[:, [4, 5, 3]]
            boxes_cam = np.concatenate(
                [xyz_cam, sizes_cam, boxes[:, 6:7]], 1)

            corners = _camera_corners(boxes_cam)
            uvw = corners @ p2[:3, :3].T + p2[:3, 3]
            uv = uvw[..., :2] / np.maximum(uvw[..., 2:3], 1e-6)
            minxy = uv.min(1)
            maxxy = uv.max(1)
            bbox2d = np.concatenate([minxy, maxxy], 1)

            valid_cam = ((bbox2d[:, 0] < img_shape[1])
                         & (bbox2d[:, 1] < img_shape[0])
                         & (bbox2d[:, 2] > 0) & (bbox2d[:, 3] > 0))
            valid_pcd = np.all(
                (boxes[:, :3] > PCD_LIMIT_RANGE[:3])
                & (boxes[:, :3] < PCD_LIMIT_RANGE[3:]), axis=1)
            valid = valid_cam & valid_pcd

            for i in np.where(valid)[0]:
                bb = bbox2d[i].copy()
                bb[2:] = np.minimum(bb[2:], [img_shape[1], img_shape[0]])
                bb[:2] = np.maximum(bb[:2], [0, 0])
                anno['name'].append(class_names[int(labels[i])])
                anno['truncated'].append(0.0)
                anno['occluded'].append(0)
                anno['alpha'].append(
                    float(-np.arctan2(-boxes[i, 1], boxes[i, 0])
                          + boxes_cam[i, 6]))
                anno['bbox'].append(bb)
                anno['dimensions'].append(boxes_cam[i, 3:6])
                anno['location'].append(boxes_cam[i, :3])
                anno['rotation_y'].append(float(boxes_cam[i, 6]))
                anno['score'].append(float(scores[i]))
        if anno['name']:
            det_annos.append({
                'name': np.array(anno['name']),
                'truncated': np.array(anno['truncated']),
                'occluded': np.array(anno['occluded']),
                'alpha': np.array(anno['alpha']),
                'bbox': np.stack(anno['bbox']),
                'dimensions': np.stack(anno['dimensions']),
                'location': np.stack(anno['location']),
                'rotation_y': np.array(anno['rotation_y']),
                'score': np.array(anno['score']),
            })
        else:
            det_annos.append({
                'name': np.array([]), 'truncated': np.array([]),
                'occluded': np.array([]), 'alpha': np.array([]),
                'bbox': np.zeros([0, 4]), 'dimensions': np.zeros([0, 3]),
                'location': np.zeros([0, 3]), 'rotation_y': np.array([]),
                'score': np.array([]),
            })
    return det_annos
