"""Fixed-shape rotated 3D NMS.

Counterpart of ``imvoxelnet_tpu/ops/nms.py`` (``greedy_nms_from_iou_batched``,
``multiclass_nms_3d``).  Candidate ranking breaks exact score ties
lowest-index-first, as ``lax.top_k`` does: ``top_k`` below takes the head of
a stable descending sort (``torch.topk`` promises no tie order on CUDA).
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


def greedy_nms_from_iou_batched(iou_matrix, scores, valid, iou_thr: float,
                                *, presorted: bool = False):
    """Greedy NMS from pairwise IoU matrices, as a fixpoint iteration.

    ``keep[j] = valid[j] & no kept higher-ranked i with iou[i, j] > thr``;
    the iteration stops when the mask stops changing, after at most ``n``
    steps, and its fixpoint is the greedy solution.  Leading dims (a class
    axis) share the loop.  Suppression is the strict ``iou > thr``.

    Args:
      iou_matrix: ``(..., N, N)``.
      scores: ``(..., N)``; suppression follows descending score order.
      valid: ``(..., N)`` bool.
      presorted: rows are already in descending-score order; the mask is
        then returned in that order.

    Returns:
      keep: ``(..., N)`` bool over the input order.
    """
    n = scores.shape[-1]
    if presorted:
        iou_sorted, valid_sorted = iou_matrix, valid
    else:
        masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
        # jnp.argsort (stable, ascending) reversed
        order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
        iou_sorted = torch.take_along_dim(
            torch.take_along_dim(iou_matrix, order[..., :, None], dim=-2),
            order[..., None, :], dim=-1)
        valid_sorted = torch.take_along_dim(valid, order, dim=-1)

    idx = torch.arange(n, device=scores.device)
    dominates = (iou_sorted > iou_thr) & (idx[:, None] < idx[None, :])
    keep, prev = valid_sorted, ~valid_sorted
    it = 0
    while it < n and bool((keep != prev).any()):
        suppressed = (keep[..., :, None] & dominates).any(dim=-2)
        keep, prev = valid_sorted & ~suppressed, keep
        it += 1
    if presorted:
        return keep
    inv_order = torch.argsort(order, dim=-1)
    return torch.take_along_dim(keep, inv_order, dim=-1)


def multiclass_nms_3d(mlvl_bboxes, mlvl_bboxes_for_nms, mlvl_scores,
                      mlvl_valid, *, score_thr: float, max_num: int,
                      iou_thr: float, pre_nms_k: int = 256,
                      mlvl_dir_scores=None):
    """Per-class rotated NMS with fixed output size (``box3d_nms.py:8-88``).

    All classes at once: one ranking over ``(C, N)``, one clip over all
    ``C*k*k`` pairs, one shared fixpoint loop.

    Args:
      mlvl_bboxes: ``(N, D)`` decoded boxes.
      mlvl_bboxes_for_nms: ``(N, 5)`` BEV xywhr boxes used for suppression.
      mlvl_scores: ``(N, C)`` foreground class scores.
      mlvl_valid: ``(N,)`` bool.
      mlvl_dir_scores: optional ``(N,)``.

    Returns:
      dict of ``boxes (max_num, D)``, ``scores``, ``labels``,
      ``dir_scores`` and ``valid`` (all ``(max_num,)``).
    """
    n, n_classes = mlvl_scores.shape
    k = min(pre_nms_k, n)
    dev = mlvl_scores.device
    if mlvl_dir_scores is None:
        mlvl_dir_scores = torch.zeros((n,), dtype=mlvl_scores.dtype,
                                      device=dev)

    scores_t = mlvl_scores.T
    masked = torch.where(mlvl_valid[None, :] & (scores_t > score_thr),
                         scores_t, torch.full_like(scores_t, _NEG))
    top_scores, top_idx = top_k(masked, k)                       # (C, k)
    top_valid = top_scores > _NEG / 2
    nms_boxes = mlvl_bboxes_for_nms[top_idx]                     # (C, k, 5)
    iou = iou_ops.rotated_iou_bev(nms_boxes, nms_boxes)          # (C, k, k)
    keeps = greedy_nms_from_iou_batched(iou, top_scores, top_valid, iou_thr,
                                        presorted=True)
    boxes = mlvl_bboxes[top_idx].reshape(n_classes * k, -1)
    labels = torch.arange(n_classes, dtype=torch.int32, device=dev)[
        :, None].expand(n_classes, k).reshape(-1)
    dirs = mlvl_dir_scores[top_idx].reshape(-1)
    scores = top_scores.reshape(-1)
    keeps = keeps.reshape(-1)

    final_scores = torch.where(keeps, scores, torch.full_like(scores, _NEG))
    k_out = min(max_num, n_classes * k)
    top_scores, top_idx = top_k(final_scores, k_out)
    out = dict(
        boxes=boxes[top_idx],
        scores=top_scores.clamp(min=0.0),
        labels=labels[top_idx],
        dir_scores=dirs[top_idx],
        valid=top_scores > _NEG / 2,
    )
    pad = max_num - k_out
    if pad:
        out = {key: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
               for key, v in out.items()}
    return out
