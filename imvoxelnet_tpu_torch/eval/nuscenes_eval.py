"""nuScenes car-AP evaluation (numpy, on the host).

Counterpart of ``imvoxelnet_tpu/eval/nuscenes_eval.py``, the same functions
and numbers.

The reference routes results through the official nuscenes-devkit after
padding zero velocities (``nuscenes_monocular_dataset.py:43-59``).  When the
devkit is importable we do the same; otherwise ``simple_nuscenes_ap``
implements the protocol's core in numpy: greedy matching by gravity-center
BEV distance at thresholds {0.5, 1, 2, 4} m, AP as the normalised area of the
(recall, precision) curve above 10%/10% (the official ``scale`` clipping),
averaged over thresholds.
"""

from __future__ import annotations

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)


def _ap_from_pr(recall, precision, min_recall=0.1, min_precision=0.1):
    """Official nuScenes AP: 101-point interpolation, clipped at 10%/10%."""
    rec_interp = np.linspace(0, 1, 101)
    prec = np.interp(rec_interp, recall, precision, right=0)
    prec = prec[rec_interp > min_recall]
    prec = prec - min_precision
    prec = np.clip(prec, 0, None)
    return float(np.mean(prec)) / (1.0 - min_precision)


def simple_nuscenes_ap(gt_annos, dt_annos, dist_thresholds=DIST_THRESHOLDS):
    """Center-distance AP for one class.

    Args:
      gt_annos: per-sample dict(boxes (G, 7) bottom-center).
      dt_annos: per-sample dict(boxes (N, 7), scores (N,)).
    Returns:
      dict with per-threshold APs and their mean (the headline 'car AP').
    """
    n_gt = sum(len(g['boxes']) for g in gt_annos)
    results = {}
    aps = []
    for thr in dist_thresholds:
        tp_flags, scores_all = [], []
        for gt, dt in zip(gt_annos, dt_annos):
            gt_boxes = np.asarray(gt['boxes'], np.float32).reshape(-1, 7)
            boxes = np.asarray(dt['boxes'], np.float32).reshape(-1, 7)
            scores = np.asarray(dt.get('scores', np.ones(len(boxes))))
            gt_centers = gt_boxes[:, :2]
            taken = np.zeros(len(gt_boxes), bool)
            order = np.argsort(-scores)
            for i in order:
                scores_all.append(float(scores[i]))
                if len(gt_boxes) == 0:
                    tp_flags.append(False)
                    continue
                d = np.linalg.norm(gt_centers - boxes[i, :2], axis=1)
                d = np.where(taken, np.inf, d)
                j = int(np.argmin(d))
                if d[j] < thr:
                    taken[j] = True
                    tp_flags.append(True)
                else:
                    tp_flags.append(False)
        if not scores_all or n_gt == 0:
            results[f'AP_dist_{thr}'] = 0.0
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores_all))
        tp = np.asarray(tp_flags)[order]
        ctp = np.cumsum(tp)
        cfp = np.cumsum(~tp)
        recall = ctp / n_gt
        precision = ctp / np.maximum(ctp + cfp, 1)
        ap = _ap_from_pr(recall, precision)
        results[f'AP_dist_{thr}'] = ap
        aps.append(ap)
    results['car_AP'] = float(np.mean(aps))
    return results


def _angle_diff(a, b, period):
    """Smallest absolute angle difference under the given period (devkit
    ``eval/common/utils.py`` ``angle_diff``)."""
    diff = (a - b + period / 2) % period - period / 2
    return np.abs(diff)


def _scale_err(size_a, size_b):
    """1 - IoU of the two boxes after aligning centers and yaw (devkit
    ``scale_iou``): intersection = prod(min(whl)), union inclusion-exclusion."""
    mins = np.minimum(size_a, size_b)
    inter = np.prod(mins, axis=-1)
    union = np.prod(size_a, axis=-1) + np.prod(size_b, axis=-1) - inter
    return 1.0 - inter / np.maximum(union, 1e-12)


def _accumulate(gt_annos, dt_annos, cls, dist_th, yaw_period, n_interp=101):
    """Devkit ``eval/detection/algo.py:accumulate`` in plain numpy.

    Greedy center-distance matching in global confidence order; returns the
    101-point interpolated precision plus TP-error curves on the same grid.
    """
    npos = sum(int(np.sum(np.asarray(g['labels']) == cls)) for g in gt_annos)

    # flatten predictions of this class across samples
    preds = []           # (score, sample_idx, box, velocity)
    for s, dt in enumerate(dt_annos):
        boxes = np.asarray(dt['boxes'], np.float32).reshape(-1, 7)
        labels = np.asarray(dt.get('labels', np.zeros(len(boxes), np.int64)))
        scores = np.asarray(dt.get('scores', np.ones(len(boxes))))
        vel = np.asarray(dt.get('velocities', np.zeros((len(boxes), 2))))
        for i in np.nonzero(labels == cls)[0]:
            preds.append((float(scores[i]), s, boxes[i], vel[i]))
    preds.sort(key=lambda t: -t[0])

    taken = [np.zeros(int(np.sum(np.asarray(g['labels']) == cls)), bool)
             for g in gt_annos]
    gt_cls = []
    gt_vel_cls = []
    for g in gt_annos:
        boxes = np.asarray(g['boxes'], np.float32).reshape(-1, 7)
        labels = np.asarray(g['labels']).reshape(-1)
        sel = labels == cls
        gt_cls.append(boxes[sel])
        gv = np.asarray(g.get('velocities', np.zeros((len(boxes), 2))))
        gt_vel_cls.append(gv.reshape(-1, 2)[sel])

    tp, fp, conf = [], [], []
    match = dict(trans_err=[], scale_err=[], orient_err=[], vel_err=[],
                 conf=[])
    for score, s, box, vel in preds:
        g = gt_cls[s]
        if len(g):
            d = np.linalg.norm(g[:, :2] - box[:2], axis=1)
            d = np.where(taken[s], np.inf, d)
            j = int(np.argmin(d))
            is_tp = d[j] < dist_th
        else:
            is_tp = False
        conf.append(score)
        if is_tp:
            taken[s][j] = True
            tp.append(1); fp.append(0)
            match['trans_err'].append(float(d[j]))
            match['scale_err'].append(float(_scale_err(box[3:6], g[j, 3:6])))
            match['orient_err'].append(
                float(_angle_diff(box[6], g[j, 6], yaw_period)))
            match['vel_err'].append(
                float(np.linalg.norm(vel - gt_vel_cls[s][j])))
            match['conf'].append(score)
        else:
            tp.append(0); fp.append(1)

    rec_interp = np.linspace(0, 1, n_interp)
    if npos == 0 or not tp or not any(tp):
        zeros = np.zeros(n_interp)
        return dict(npos=npos, precision=zeros, confidence=zeros,
                    trans_err=np.ones(n_interp), scale_err=np.ones(n_interp),
                    orient_err=np.ones(n_interp), vel_err=np.ones(n_interp))

    tp_c = np.cumsum(tp).astype(np.float64)
    fp_c = np.cumsum(fp).astype(np.float64)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / npos

    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)

    out = dict(npos=npos, precision=prec_i, confidence=conf_i)
    for key in ('trans_err', 'scale_err', 'orient_err', 'vel_err'):
        vals = np.asarray(match[key], np.float64)
        cum = np.cumsum(vals) / (np.arange(len(vals)) + 1)   # cummean
        # map TP-order curve onto the recall grid through confidence
        # (devkit accumulate: interp over *descending* confidence)
        out[key] = np.interp(conf_i[::-1], np.asarray(match['conf'])[::-1],
                             cum[::-1])[::-1]
    return out


def _calc_ap(md, min_recall=0.1, min_precision=0.1):
    """Devkit ``calc_ap``: slice indices round(100*min_recall)+1 .. 100."""
    prec = np.copy(md['precision'])[int(round(100 * min_recall)) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def _calc_tp(md, metric, min_recall=0.1):
    """Devkit ``calc_tp``: mean of the error curve between min_recall and the
    max achieved recall; 1.0 when no recall beyond min_recall."""
    first = int(round(100 * min_recall)) + 1
    nz = np.nonzero(md['confidence'])[0]
    last = int(nz[-1]) if len(nz) else 0
    if last < first:
        return 1.0
    return float(np.mean(md[metric][first:last + 1]))


TP_DIST_TH = 2.0
YAW_PERIODS = {'barrier': np.pi}    # all other classes: full period

# detection_cvpr_2019 class_range (devkit
# ``eval/detection/configs/detection_cvpr_2019.json``): max ego-frame BEV
# radius; boxes (GT and detections) beyond it are dropped before matching
# (reference ``nuscenes_dataset.py:590-594`` for detections,
# devkit ``filter_eval_boxes`` for GT).
CLASS_RANGE = {
    'car': 50.0, 'truck': 50.0, 'bus': 50.0, 'trailer': 50.0,
    'construction_vehicle': 50.0, 'pedestrian': 40.0, 'motorcycle': 40.0,
    'bicycle': 40.0, 'traffic_cone': 30.0, 'barrier': 30.0,
}
# devkit TP-metric exclusions (``evaluate.py``: the excluded errors are set
# NaN and skipped by the nanmean): traffic cones have no orientation or
# velocity; barriers have no velocity.
TP_EXCLUDE = {
    'traffic_cone': {'AOE', 'AVE'},
    'barrier': {'AVE'},
}


def _range_filter(annos, classes, class_range):
    """Drop boxes whose BEV center radius exceeds their class range.

    The devkit measures the radius in the EGO frame
    (``nuscenes_dataset.py:587-594`` rotates/translates lidar->ego first);
    here boxes are in the lidar frame, whose origin differs from ego by the
    fixed ~1 m sensor offset — pass ``ego_offset`` through ``annos`` if that
    matters for a study; the protocol intent (cap matching at 30-50 m) is
    preserved either way.
    """
    out = []
    for a in annos:
        boxes = np.asarray(a['boxes'], np.float32).reshape(-1, 7)
        labels = np.asarray(a.get('labels',
                                  np.zeros(len(boxes), np.int64))).reshape(-1)
        radius = np.linalg.norm(boxes[:, :2], axis=1)
        limits = np.asarray([class_range.get(classes[int(l)], 50.0)
                             if 0 <= int(l) < len(classes) else 50.0
                             for l in labels])
        keep = radius <= limits
        filtered = {k: (np.asarray(v)[keep] if np.ndim(v) and
                        len(np.asarray(v)) == len(keep) else v)
                    for k, v in a.items()}
        filtered['boxes'] = boxes[keep]
        filtered['labels'] = labels[keep]
        out.append(filtered)
    return out


def nuscenes_nds(gt_annos, dt_annos, classes=('car',),
                 dist_thresholds=DIST_THRESHOLDS, with_velocity=False,
                 class_range=None):
    """Devkit-free nuScenes detection metrics: per-class AP at the four
    center-distance thresholds, ATE/ASE/AOE (+ATE at velocity when
    ``with_velocity``), mAP and NDS.

    Parity: ``nuscenes-devkit eval/detection/{algo,evaluate}.py`` as invoked
    by the reference's ``NuScenesDataset.evaluate``
    (``mmdet3d/datasets/nuscenes_dataset.py``) after the zero-velocity pad of
    ``nuscenes_monocular_dataset.py:43-59``, including the per-class
    ``class_range`` radius filter applied to both GT and detections
    (``detection_cvpr_2019`` defaults; pass ``class_range={}`` to disable)
    and the devkit's per-class TP-error exclusions (traffic_cone: no
    AOE/AVE; barrier: no AVE).  TP errors are computed at the 2 m threshold.
    Attribute error is not modeled (the monocular shim fixes attributes),
    and velocity error is opt-in; NDS renormalizes over the metrics present:
    ``NDS = (5*mAP + Σ (1 - min(1, err))) / (5 + n_tp)``.  The radius filter
    uses the lidar-frame BEV radius where the devkit uses the ego frame
    (~1 m sensor offset) — see ``_range_filter``.

    Args:
      gt_annos / dt_annos: per-sample dicts with ``boxes (N, 7)``
        (bottom-center; only x, y, sizes, yaw are used), ``labels (N,)``
        int class ids into ``classes``; dt also ``scores``; optionally both
        carry ``velocities (N, 2)``.
    Returns a flat metric dict (``{cls}_AP_dist_{thr}``, ``{cls}_ATE`` …,
    ``mAP``, ``NDS``).
    """
    if class_range is None:
        class_range = CLASS_RANGE
    if class_range:
        gt_annos = _range_filter(gt_annos, classes, class_range)
        dt_annos = _range_filter(dt_annos, classes, class_range)
    results = {}
    all_aps = []
    tp_errs = {k: [] for k in ('ATE', 'ASE', 'AOE', 'AVE')}
    tp_key = dict(ATE='trans_err', ASE='scale_err', AOE='orient_err',
                  AVE='vel_err')
    for ci, cls_name in enumerate(classes):
        period = YAW_PERIODS.get(cls_name, 2 * np.pi)
        excluded = TP_EXCLUDE.get(cls_name, set())
        aps = []
        for thr in dist_thresholds:
            md = _accumulate(gt_annos, dt_annos, ci, thr, period)
            ap = _calc_ap(md)
            results[f'{cls_name}_AP_dist_{thr}'] = ap
            aps.append(ap)
            if thr == TP_DIST_TH:
                names = ['ATE', 'ASE', 'AOE'] + (
                    ['AVE'] if with_velocity else [])
                for name in names:
                    if name in excluded:
                        continue
                    results[f'{cls_name}_{name}'] = _calc_tp(
                        md, tp_key[name])
                    tp_errs[name].append(results[f'{cls_name}_{name}'])
        results[f'{cls_name}_AP'] = float(np.mean(aps))
        all_aps.extend(aps)

    mean_ap = float(np.mean(all_aps))
    results['mAP'] = mean_ap
    tp_names = ['ATE', 'ASE', 'AOE'] + (['AVE'] if with_velocity else [])
    tp_scores = []
    for name in tp_names:
        # nanmean analog: classes with this metric excluded don't contribute
        err = float(np.mean(tp_errs[name])) if tp_errs[name] else 1.0
        results[f'm{name}'] = err
        tp_scores.append(max(0.0, 1.0 - min(1.0, err)))
    results['NDS'] = float(
        (5.0 * mean_ap + np.sum(tp_scores)) / (5.0 + len(tp_names)))
    return results


def official_nuscenes_eval(results, data_root, version='v1.0-trainval'):
    """Zero-velocity pad + official devkit eval
    (``nuscenes_monocular_dataset.py:43-59``).  Requires nuscenes-devkit;
    ``nuscenes_nds`` implements the same detection metrics devkit-free and is
    the supported path in the port."""
    try:
        from nuscenes.nuscenes import NuScenes  # noqa: F401
    except ImportError as e:
        raise ImportError(
            'nuscenes-devkit is not installed; use nuscenes_nds (devkit-free '
            'NDS/AP with identical calc_ap/calc_tp semantics)') from e
    raise NotImplementedError(
        'official devkit eval wiring requires the dataset json; '
        'use nuscenes_nds for offline development')
