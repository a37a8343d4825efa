"""Fixed-shape per-class rotated BEV NMS: over each class's ``pre_nms_k``
best candidates (KITTI, where that is all of them) or exact over every
candidate (SUN RGB-D).

Counterpart of ``imvoxelnet_tpu/ops/nms.py`` (``greedy_nms_from_iou``,
``multiclass_nms_3d``, ``multiclass_nms_3d_exact``).  Candidate ranking
breaks exact score ties lowest-index-first, as ``lax.top_k`` does:
``top_k`` below takes the head of a stable descending sort (``torch.topk``
promises no tie order on the card).  Ranking by score for a greedy pass over an
IoU matrix (``greedy_nms_from_iou``) puts equal scores highest index first,
as the JAX package's reversed stable ``argsort`` does.

Every suppression is the fixpoint loop of :func:`greedy_nms_in_rank_order`
over the pairwise IoU.
"""

from __future__ import annotations

import torch

from . import iou as iou_ops

_NEG = -1e10


def top_k(x, k: int):
    """``lax.top_k`` over the last dim: values and indices, ties broken
    lowest-index-first."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def greedy_nms_in_rank_order(iou_sorted, valid_sorted, iou_thr: float):
    """Greedy NMS of candidates already in rank order, as a fixpoint
    iteration: IoU matrices ``(..., N, N)`` and bool ``valid_sorted (...,
    N)`` -> keep ``(..., N)`` in rank order.

    ``keep[j] = valid[j] & no kept higher-ranked i with iou[i, j] > thr``;
    the iteration stops when the mask stops changing, after at most ``N``
    steps, and its fixpoint is the greedy solution.  Leading dims (a class
    axis) share the loop.  Suppression is the strict ``iou > thr``.
    """
    n = valid_sorted.shape[-1]
    idx = torch.arange(n, device=valid_sorted.device)
    dominates = (iou_sorted > iou_thr) & (idx[:, None] < idx[None, :])
    keep, prev = valid_sorted, ~valid_sorted
    it = 0
    while it < n and bool((keep != prev).any()):
        suppressed = (keep[..., :, None] & dominates).any(dim=-2)
        keep, prev = valid_sorted & ~suppressed, keep
        it += 1
    return keep


def greedy_nms_from_iou(iou, scores, valid, iou_thr: float):
    """Greedy NMS from pairwise IoU matrices ``(..., N, N)`` (leading dims
    broadcast against those of ``scores`` and ``valid (..., N)``), ranked
    by descending score with equal scores highest index first (the JAX
    package's reversed stable ``argsort``); returns keep ``(..., N)`` bool
    in the input order."""
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
    iou_sorted = torch.take_along_dim(
        torch.take_along_dim(iou, order[..., :, None], dim=-2),
        order[..., None, :], dim=-1)
    keep = greedy_nms_in_rank_order(
        iou_sorted, torch.take_along_dim(valid, order, dim=-1), iou_thr)
    return torch.empty_like(keep).scatter_(-1, order, keep)


def take_per_sample(x, idx):
    """``x (B, N, ...)`` at ``idx (B, ...)`` along dim 1, per sample."""
    b = torch.arange(x.shape[0], device=x.device)
    return x[b.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def multiclass_nms_3d(mlvl_bboxes, mlvl_bboxes_for_nms, mlvl_scores,
                      mlvl_valid, *, score_thr: float, max_num: int,
                      iou_thr: float, pre_nms_k: int = 256,
                      mlvl_dir_scores=None):
    """Per-class rotated NMS with fixed output size
    (``box3d_nms.py:8-88``) over each class's ``pre_nms_k`` best
    candidates.

    All samples and classes at once: one ranking over ``(B, C, N)``, one
    rotated IoU over all ``B*C*k*k`` pairs, one greedy pass.  The arguments may carry a
    leading batch dim (what ``jax.vmap`` of the JAX function takes); the
    outputs then carry it too.

    Args:
      mlvl_bboxes: ``([B,] N, D)`` decoded boxes.
      mlvl_bboxes_for_nms: ``([B,] N, 5)`` BEV xywhr boxes used for
        suppression.
      mlvl_scores: ``([B,] N, C)`` foreground class scores.
      mlvl_valid: ``([B,] N)`` bool.
      mlvl_dir_scores: optional ``([B,] N)``.

    Returns:
      dict of ``boxes ([B,] max_num, D)``, ``scores``, ``labels``,
      ``dir_scores`` and ``valid`` (all ``([B,] max_num)``).
    """
    if mlvl_scores.dim() == 2:
        dirs = None if mlvl_dir_scores is None else mlvl_dir_scores[None]
        out = multiclass_nms_3d(
            mlvl_bboxes[None], mlvl_bboxes_for_nms[None], mlvl_scores[None],
            mlvl_valid[None], score_thr=score_thr, max_num=max_num,
            iou_thr=iou_thr, pre_nms_k=pre_nms_k, mlvl_dir_scores=dirs)
        return {key: v[0] for key, v in out.items()}
    b, n, n_classes = mlvl_scores.shape
    k = min(pre_nms_k, n)
    dev = mlvl_scores.device
    if mlvl_dir_scores is None:
        mlvl_dir_scores = torch.zeros((b, n), dtype=mlvl_scores.dtype,
                                      device=dev)

    scores_t = mlvl_scores.transpose(1, 2)
    masked = torch.where(mlvl_valid[:, None, :] & (scores_t > score_thr),
                         scores_t, torch.full_like(scores_t, _NEG))
    top_scores, top_idx = top_k(masked, k)                       # (B, C, k)
    top_valid = top_scores > _NEG / 2
    nms_boxes = take_per_sample(mlvl_bboxes_for_nms, top_idx)   # (B, C, k, 5)
    nms_boxes = nms_boxes.reshape(b * n_classes, k, 5)
    keeps = greedy_nms_in_rank_order(
        iou_ops.rotated_iou_bev(nms_boxes, nms_boxes),
        top_valid.reshape(b * n_classes, k), iou_thr)
    boxes = take_per_sample(mlvl_bboxes, top_idx).reshape(
        b, n_classes * k, -1)
    labels = torch.arange(n_classes, dtype=torch.int32, device=dev)[
        None, :, None].expand(b, n_classes, k).reshape(b, -1)
    dirs = take_per_sample(mlvl_dir_scores, top_idx).reshape(b, -1)
    scores = top_scores.reshape(b, -1)
    keeps = keeps.reshape(b, -1)

    final_scores = torch.where(keeps, scores, torch.full_like(scores, _NEG))
    k_out = min(max_num, n_classes * k)
    top_scores, top_idx = top_k(final_scores, k_out)             # (B, k_out)
    out = dict(
        boxes=take_per_sample(boxes, top_idx),
        scores=top_scores.clamp(min=0.0),
        labels=take_per_sample(labels, top_idx),
        dir_scores=take_per_sample(dirs, top_idx),
        valid=top_scores > _NEG / 2,
    )
    pad = max_num - k_out
    if pad:
        out = {key: torch.cat(
            [v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
            for key, v in out.items()}
    return out


def multiclass_nms_3d_exact(mlvl_bboxes, mlvl_bboxes_for_nms, mlvl_scores,
                            mlvl_valid, *, score_thr: float, max_num: int,
                            iou_thr: float, mlvl_dir_scores=None):
    """Exact (untruncated) per-class rotated NMS over all candidates, fixed
    output size: ``box3d_multiclass_nms`` (``box3d_nms.py:8-88``) with no
    candidate cap (JAX ``ops/nms.py:118-177``, the ``pre_nms_k <= 0``
    path).

    The candidates' boxes are the same for every class, so one rotated
    ``(N, N)`` IoU a sample serves every class: each class ranks its valid candidates above
    ``score_thr`` (equal scores highest index first) and runs the greedy
    pass over it (:func:`greedy_nms_from_iou`); the ``max_num`` best kept
    (class, candidate) pairs over all classes (ties lowest flat index
    ``class * N + candidate`` first) are the output.  Arguments and outputs
    as :func:`multiclass_nms_3d`'s, with an optional leading batch dim.
    """
    if mlvl_scores.dim() == 2:
        dirs = None if mlvl_dir_scores is None else mlvl_dir_scores[None]
        out = multiclass_nms_3d_exact(
            mlvl_bboxes[None], mlvl_bboxes_for_nms[None], mlvl_scores[None],
            mlvl_valid[None], score_thr=score_thr, max_num=max_num,
            iou_thr=iou_thr, mlvl_dir_scores=dirs)
        return {key: v[0] for key, v in out.items()}
    b, n, n_classes = mlvl_scores.shape
    if mlvl_dir_scores is None:
        mlvl_dir_scores = mlvl_scores.new_zeros((b, n))
    iou = iou_ops.rotated_iou_bev(mlvl_bboxes_for_nms, mlvl_bboxes_for_nms)
    scores_t = mlvl_scores.transpose(1, 2)                       # (B, C, N)
    cls_valid = mlvl_valid[:, None, :] & (scores_t > score_thr)
    keeps = greedy_nms_from_iou(iou[:, None], scores_t, cls_valid, iou_thr)
    kept = torch.where(keeps, scores_t, torch.full_like(scores_t, _NEG))
    k_out = min(max_num, n_classes * n)
    top_scores, top_flat = top_k(kept.reshape(b, -1), k_out)
    top_idx = top_flat % n
    out = dict(
        boxes=take_per_sample(mlvl_bboxes, top_idx),
        scores=top_scores.clamp(min=0.0),
        labels=(top_flat // n).to(torch.int32),
        dir_scores=take_per_sample(mlvl_dir_scores, top_idx),
        valid=top_scores > _NEG / 2,
    )
    pad = max_num - k_out
    if pad:
        out = {key: torch.cat(
            [v, v.new_zeros((b, pad) + v.shape[2:])], dim=1)
            for key, v in out.items()}
    return out
