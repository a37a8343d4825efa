"""Indoor detection evaluation (SUN RGB-D / ScanNet mAP).

Counterpart of ``imvoxelnet_tpu/eval/indoor_eval.py``, the same protocol
and numbers: ``indoor_eval`` (``mmdet3d/core/evaluation/indoor_eval.py:
203-309``) with ``eval_det_cls`` / ``average_precision`` (:7-160),
VOC-style greedy matching per class at several IoU thresholds, area-mode
AP, on the host in numpy.

The rotated 3D IoUs come from ``ops/iou.py:bbox_overlaps_3d`` on ``device``
(the card unless the caller passes the CPU), where the BEV areas are the
clip kernel's pairwise entry.  Where the JAX protocol makes one IoU call
per (class, image), this one makes one per image, over all its detections
and all its GT (:func:`image_ious`), and slices each class's rows and
columns out of it: each pair is computed alone, so the slices equal the
per-class matrices bit for bit (``tests/test_torch_port_eval.py``,
``tests/test_torch_port_cuda.py``).

Inputs are plain arrays: per-image dicts with bottom-center ``(N, 7)`` boxes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import iou as iou_ops


def _box_iou_3d(pred_boxes, gt_boxes, device='cuda'):
    """``(N, G)`` float32 IoU matrix of ``(N, 7)`` and ``(G, 7)`` boxes,
    computed on ``device``."""
    with torch.no_grad():
        iou = iou_ops.bbox_overlaps_3d(
            torch.as_tensor(np.asarray(pred_boxes, np.float32)).to(device),
            torch.as_tensor(np.asarray(gt_boxes, np.float32)).to(device))
    return iou.cpu().numpy()


def image_ious(gt_annos, dt_annos, device='cuda'):
    """Per image, the IoU of every detection with every GT box: ``(N_i,
    G_i)`` float32, or ``None`` where the image has no detection or no GT
    (one IoU call per image with both)."""
    out = []
    for gt, det in zip(gt_annos, dt_annos):
        boxes = np.asarray(det['boxes'], np.float32).reshape(-1, 7)
        gt_boxes = np.asarray(gt['boxes'], np.float32).reshape(-1, 7)
        out.append(_box_iou_3d(boxes, gt_boxes, device)
                   if len(boxes) and len(gt_boxes) else None)
    return out


def average_precision(recalls, precisions):
    """Area-mode AP (``indoor_eval.py:7-52``)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred, gt, iou_thrs, device='cuda'):
    """Single-class PR (``indoor_eval.py:55-160``).

    Args:
      pred: {img_id: (boxes (N, 7), scores (N,))}, or
        {img_id: (boxes, scores, iou (N, G))} with the IoUs against the
        image's GT of this class computed already.
      gt: {img_id: boxes (G, 7)}
      device: where the IoUs not given are computed.
    Returns:
      list of (recall_curve, precision_curve, ap) per threshold.
    """
    class_recs = {}
    npos = 0
    for img_id, boxes in gt.items():
        npos += len(boxes)
        class_recs[img_id] = {
            'bbox': np.asarray(boxes, np.float32).reshape(-1, 7),
            'det': [np.zeros(len(boxes), bool) for _ in iou_thrs]}

    image_ids, confidence, ious = [], [], []
    for img_id, (boxes, scores, *given) in pred.items():
        boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
        if len(boxes) == 0:
            continue
        gt_cur = class_recs.get(img_id, {'bbox': np.zeros((0, 7))})['bbox']
        if len(gt_cur):
            iou_mat = given[0] if given else _box_iou_3d(boxes, gt_cur,
                                                         device)
        else:
            iou_mat = np.zeros((len(boxes), 1))
        for i in range(len(boxes)):
            image_ids.append(img_id)
            confidence.append(float(scores[i]))
            ious.append(iou_mat[i])

    order = np.argsort(-np.asarray(confidence)) if confidence else []
    nd = len(image_ids)
    tp = [np.zeros(nd) for _ in iou_thrs]
    fp = [np.zeros(nd) for _ in iou_thrs]
    for rank, d in enumerate(order):
        img_id = image_ids[d]
        rec = class_recs.get(img_id)
        cur_iou = ious[d]
        iou_max, jmax = -np.inf, -1
        if rec is not None and len(rec['bbox']):
            jmax = int(np.argmax(cur_iou))
            iou_max = float(cur_iou[jmax])
        for t, thr in enumerate(iou_thrs):
            if iou_max > thr:
                if not rec['det'][t][jmax]:
                    tp[t][rank] = 1.0
                    rec['det'][t][jmax] = True
                else:
                    fp[t][rank] = 1.0
            else:
                fp[t][rank] = 1.0

    results = []
    for t in range(len(iou_thrs)):
        cfp = np.cumsum(fp[t])
        ctp = np.cumsum(tp[t])
        recall = ctp / max(float(npos), 1e-8)
        precision = ctp / np.maximum(ctp + cfp, np.finfo(np.float64).eps)
        results.append((recall, precision, average_precision(recall, precision)))
    return results


def indoor_eval(gt_annos, dt_annos, classes, iou_thrs=(0.25, 0.5),
                device='cuda'):
    """Full protocol (``indoor_eval.py:203-309``).

    Args:
      gt_annos: list per image of dict(boxes (G, 7), labels (G,)).
      dt_annos: list per image of dict(boxes (N, 7), scores (N,), labels (N,)).
      classes: tuple of class names.
      device: where the IoUs are computed (:func:`image_ious`).

    Returns:
      flat metric dict with the reference's key names
      (``{cls}_AP_{thr}``, ``mAP_{thr}``, ``{cls}_rec_{thr}``, ``mAR_{thr}``).
    """
    pred = {}   # {label: {img_id: (boxes, scores, ious with its GT)}}
    gt = {}     # {label: {img_id: boxes}}
    for img_id, anno in enumerate(gt_annos):
        labels = np.asarray(anno['labels'])
        boxes = np.asarray(anno['boxes'], np.float32).reshape(-1, 7)
        for label in range(len(classes)):
            gt.setdefault(label, {})[img_id] = boxes[labels == label]
    ious = image_ious(gt_annos, dt_annos, device)
    for img_id, det in enumerate(dt_annos):
        labels = np.asarray(det['labels'])
        boxes = np.asarray(det['boxes'], np.float32).reshape(-1, 7)
        scores = np.asarray(det['scores'])
        gt_labels = np.asarray(gt_annos[img_id]['labels']).reshape(-1)
        for label in np.unique(labels):
            m = labels == label
            entry = (boxes[m], scores[m])
            if ious[img_id] is not None:
                entry += (ious[img_id][m][:, gt_labels == label],)
            pred.setdefault(int(label), {})[img_id] = entry
    # every gt class needs every pred image id present (match reference)
    for label in pred:
        for img_id in range(len(gt_annos)):
            pred[label].setdefault(
                img_id, (np.zeros((0, 7), np.float32), np.zeros((0,))))

    # reference semantics (``indoor_eval.py:163-199``) with one deliberate
    # divergence: the mean runs over classes with >= 1 GT box in the dataset
    # (a GT class with no predictions contributes AP = 0 / recall = 0), and
    # predicted-only classes (no GT anywhere — degenerate input) are
    # excluded entirely, where the reference iterates gt.keys() and its
    # 0-GT recall becomes 0/0 -> NaN that propagates into the mAP mean
    gt_classes = sorted(
        label for label, per_img in gt.items()
        if any(len(b) for b in per_img.values()))

    metrics = {}
    aps = {t: [] for t in iou_thrs}
    recalls = {t: [] for t in iou_thrs}
    for label in gt_classes:
        name = classes[label]
        if label in pred:
            results = eval_det_cls(pred[label], gt[label], iou_thrs, device)
        else:
            results = [(np.zeros(1), np.zeros(1), 0.0) for _ in iou_thrs]
        for t, thr in enumerate(iou_thrs):
            recall, precision, ap = results[t]
            metrics[f'{name}_AP_{thr:.2f}'] = float(ap)
            aps[thr].append(ap)
            rec = float(recall[-1]) if len(recall) else 0.0
            metrics[f'{name}_rec_{thr:.2f}'] = rec
            recalls[thr].append(rec)
    for thr in iou_thrs:
        metrics[f'mAP_{thr:.2f}'] = float(np.mean(aps[thr])) if aps[thr] else 0.0
        metrics[f'mAR_{thr:.2f}'] = (float(np.mean(recalls[thr]))
                                     if recalls[thr] else 0.0)
    return metrics
