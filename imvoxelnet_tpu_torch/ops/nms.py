"""Fixed-shape 3D NMS: per-class rotated (SUN RGB-D, KITTI) or axis-aligned
BEV, truncated to a per-class candidate cap or exact over all candidates,
and class-aware axis-aligned (ScanNet).

Counterpart of ``imvoxelnet_tpu/ops/nms.py`` (``greedy_nms_from_iou_batched``,
``greedy_nms_from_iou``, ``rotated_nms_bev``, ``normal_nms_bev``,
``multiclass_nms_3d`` with both ``use_rotate_nms``,
``multiclass_nms_3d_exact``, ``aligned_3d_nms``).  Candidate ranking breaks
exact score ties lowest-index-first, as ``lax.top_k`` does: ``top_k`` below
takes the head of a stable descending sort (``torch.topk`` promises no tie
order on CUDA).
Ranking by score for a greedy pass over an IoU matrix
(``greedy_nms_from_iou``) puts equal scores highest index first, as the JAX
package's reversed stable ``argsort`` does.

On CUDA tensors the suppression of ``multiclass_nms_3d`` is two kernel
launches for all samples and classes (``kernels/rect_clip.py``, as the
operators ``torch.ops.imvx.nms_mask`` and ``nms_scan``: the dominance mask,
then the greedy scan over it; without rotation a plain
axis-aligned mask and the scan), that of ``aligned_3d_nms`` a plain-PyTorch
dominance mask and one scan launch for all samples, and that of
``multiclass_nms_3d_exact``, ``rotated_nms_bev`` and ``normal_nms_bev`` the
pairwise IoU (one launch of the clip's pairwise entry for all samples, or
the plain axis-aligned IoU), its bits gathered into each class's rank order
and packed, and one scan launch for all samples and classes; nothing in any
of them reads a value back to the host.  ``greedy_nms_from_iou_batched``,
whose fixpoint loop asks the device every iteration whether it is done, is
their plain version.
"""

from __future__ import annotations

import torch

from ..kernels import rect_clip as clip_kernel
from . import boxes as box_ops
from . import iou as iou_ops

_NEG = -1e10
# bool entries of the gathered dominance bits that ``ranked_dominance_mask``
# holds at once (a chunk of groups, 256 MB of bools): the exact NMS of
# 8 samples x 10 classes x 3,000 candidates gathers 720 M
_RANK_CHUNK = 1 << 28


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
    steps (under ``torch.export`` after ``n``), and its fixpoint is the
    greedy solution.  Leading dims (a class
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
    # traced by torch.export, the loop cannot ask the device whether it is
    # done: it takes all n steps (past the fixpoint a step changes nothing)
    traced = torch.compiler.is_compiling()
    while it < n and (traced or bool((keep != prev).any())):
        suppressed = (keep[..., :, None] & dominates).any(dim=-2)
        keep, prev = valid_sorted & ~suppressed, keep
        it += 1
    if presorted:
        return keep
    inv_order = torch.argsort(order, dim=-1)
    return torch.take_along_dim(keep, inv_order, dim=-1)


def nms_in_rank_order_plain(iou, order, valid_sorted, iou_thr: float):
    """Plain version of :func:`nms_in_rank_order`: the IoU gathered into
    rank order and the fixpoint loop over it."""
    iou_sorted = torch.take_along_dim(
        torch.take_along_dim(iou, order[..., :, None], dim=-2),
        order[..., None, :], dim=-1)
    return greedy_nms_from_iou_batched(
        iou_sorted, torch.zeros_like(valid_sorted, dtype=iou.dtype),
        valid_sorted, iou_thr, presorted=True)


def ranked_dominance_mask(iou, order, iou_thr: float):
    """Which candidate would suppress which, in each group's rank order,
    one bit per pair: IoU matrices ``(..., N, N)`` in the candidates' own
    order (leading dims broadcast against those of ``order (..., N)``: one
    matrix serves every class) -> ``(G, N, ceil(N / 32))`` int32 over the
    ``G`` broadcast groups, bit ``j % 32`` of word ``[g, i, j // 32]`` set
    iff ``i < j`` and ``iou[order[i], order[j]] > iou_thr``.  The bits are
    gathered into rank order and packed in chunks of groups
    (``_RANK_CHUNK`` bools at a time)."""
    n = order.shape[-1]
    lead = torch.broadcast_shapes(iou.shape[:-2], order.shape[:-1])
    over = (iou > iou_thr).reshape(-1, n, n)
    # the matrix of each group
    src = torch.arange(over.shape[0], device=iou.device).reshape(
        iou.shape[:-2]).expand(lead).reshape(-1)
    order = order.expand(lead + (n,)).reshape(-1, n)
    idx = torch.arange(n, device=iou.device)
    upper = idx[:, None] < idx[None, :]
    step = max(1, _RANK_CHUNK // (n * n))
    masks = []
    for g0 in range(0, order.shape[0], step):
        o = order[g0:g0 + step]
        rows = torch.take_along_dim(over.index_select(0, src[g0:g0 + step]),
                                    o[:, :, None], dim=1)
        dominates = torch.take_along_dim(rows, o[:, None, :], dim=2)
        masks.append(iou_ops.pack_mask(dominates & upper))
    return torch.cat(masks)


def nms_in_rank_order(iou, order, valid_sorted, iou_thr: float):
    """Greedy NMS of candidates ranked by ``order (..., N)`` over IoU
    matrices ``(..., N, N)`` in the candidates' own order (leading dims
    broadcast against ``order``'s); a candidate that is valid
    (``valid_sorted``, in rank order) and not suppressed is kept and
    suppresses those ranked below it with ``iou > iou_thr``.  Returns keep
    in rank order, with the broadcast leading dims.

    On CUDA tensors: :func:`ranked_dominance_mask`, then one scan launch
    over every group; nothing is read back to the host."""
    if not iou.is_cuda:
        return nms_in_rank_order_plain(iou, order, valid_sorted, iou_thr)
    n = order.shape[-1]
    lead = torch.broadcast_shapes(iou.shape[:-2], order.shape[:-1])
    keep = clip_kernel.nms_scan_op(
        ranked_dominance_mask(iou, order, iou_thr),
        valid_sorted.expand(lead + (n,)).reshape(-1, n).contiguous())
    return keep.reshape(lead + (n,))


def greedy_nms_from_iou(iou, scores, valid, iou_thr: float):
    """Greedy NMS from pairwise IoU matrices ``(..., N, N)`` (leading dims
    broadcast against those of ``scores`` and ``valid (..., N)``), ranked
    by descending score with equal scores highest index first (the JAX
    package's reversed stable ``argsort``); returns keep ``(..., N)`` bool
    in the input order.  Suppression is the strict ``iou > iou_thr``."""
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
    keep = nms_in_rank_order(iou, order,
                             torch.take_along_dim(valid, order, dim=-1),
                             iou_thr)
    return torch.empty_like(keep).scatter_(-1, order, keep)


def rotated_nms_bev(boxes_xywhr, scores, valid, iou_thr: float):
    """Rotated BEV NMS (``nms_gpu``) of ``(..., N, 5)`` boxes with ``(...,
    N)`` scores and bool ``valid`` -> keep ``(..., N)``: the pairwise IoU
    (on CUDA one launch of the clip's pairwise entry), then
    :func:`greedy_nms_from_iou`."""
    iou = iou_ops.rotated_iou_bev(boxes_xywhr, boxes_xywhr)
    return greedy_nms_from_iou(iou, scores, valid, iou_thr)


def xywhr_to_xyxy(boxes_xywhr):
    """The axis-aligned ``(x1, y1, x2, y2)`` of rotated BEV boxes, their
    rotation ignored (``nms_normal_gpu``'s box)."""
    xy, wh = boxes_xywhr[..., :2], boxes_xywhr[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def normal_nms_bev(boxes_xywhr, scores, valid, iou_thr: float):
    """Axis-aligned BEV NMS ignoring rotation (``nms_normal_gpu``): the
    plain pairwise IoU of :func:`xywhr_to_xyxy`, then
    :func:`greedy_nms_from_iou`."""
    xyxy = xywhr_to_xyxy(boxes_xywhr)
    return greedy_nms_from_iou(iou_ops.bbox_overlaps_2d(xyxy, xyxy), scores,
                               valid, iou_thr)


def nms_scan_plain(mask, valid):
    """Plain version of the scan kernel (``kernels/rect_clip.py:nms_scan``):
    walk the rows of a packed dominance mask ``(G, N, ceil(N / 32))`` in rank
    order; a row that is valid and not yet removed is kept and removes the
    rows its bits name.  Returns ``keep (G, N)`` bool."""
    n = valid.shape[-1]
    dominates = iou_ops.unpack_mask(mask, n)
    removed = ~valid
    for i in range(n):
        removed = removed | (~removed[..., i, None] & dominates[..., i, :])
    return ~removed


def rotated_nms_presorted_plain(boxes_xywhr, valid, iou_thr: float):
    """Plain version of :func:`rotated_nms_presorted`: the pairwise IoU and
    the fixpoint loop over it."""
    iou = iou_ops.rotated_iou_bev(boxes_xywhr, boxes_xywhr)
    return greedy_nms_from_iou_batched(
        iou, iou.new_zeros(valid.shape), valid, iou_thr, presorted=True)


def rotated_nms_presorted(boxes_xywhr, valid, iou_thr: float):
    """Rotated BEV NMS of ``G`` groups of ``N`` boxes whose rows are already
    in descending-score order: ``(G, N, 5)``, ``(G, N)`` bool -> keep
    ``(G, N)`` bool.  On CUDA tensors: the mask kernel, then the scan kernel,
    with no read back to the host."""
    if not boxes_xywhr.is_cuda:
        return rotated_nms_presorted_plain(boxes_xywhr, valid, iou_thr)
    boxes_xywhr = boxes_xywhr.float()
    mask = clip_kernel.nms_mask_op(
        box_ops.bev_corners(boxes_xywhr).contiguous(),
        (boxes_xywhr[..., 2] * boxes_xywhr[..., 3]).contiguous(), iou_thr)
    return clip_kernel.nms_scan_op(mask, valid.contiguous())


def normal_nms_presorted_plain(boxes_xywhr, valid, iou_thr: float):
    """Plain version of :func:`normal_nms_presorted`: the fixpoint loop
    over the axis-aligned IoU."""
    xyxy = xywhr_to_xyxy(boxes_xywhr)
    iou = iou_ops.bbox_overlaps_2d(xyxy, xyxy)
    return greedy_nms_from_iou_batched(
        iou, iou.new_zeros(valid.shape), valid, iou_thr, presorted=True)


def normal_nms_presorted(boxes_xywhr, valid, iou_thr: float):
    """Axis-aligned BEV NMS (rotation ignored) of ``G`` groups of ``N``
    boxes already in descending-score order: ``(G, N, 5)``, ``(G, N)`` bool
    -> keep ``(G, N)`` bool.  On CUDA tensors: the plain IoU's bits above
    the diagonal, packed, then the scan kernel over all groups in one
    launch, with no read back to the host."""
    if not boxes_xywhr.is_cuda:
        return normal_nms_presorted_plain(boxes_xywhr, valid, iou_thr)
    xyxy = xywhr_to_xyxy(boxes_xywhr.float())
    iou = iou_ops.bbox_overlaps_2d(xyxy, xyxy)
    idx = torch.arange(boxes_xywhr.shape[-2], device=boxes_xywhr.device)
    mask = iou_ops.pack_mask((iou > iou_thr) & (idx[:, None] < idx[None, :]))
    return clip_kernel.nms_scan_op(mask, valid.contiguous())


def aligned_dominance_mask(boxes_corner, classes, iou_thr: float):
    """Which candidate would suppress which in the class-aware axis-aligned
    NMS, one bit per pair: ``(G, N, 6)`` corner-form boxes in rank order
    and their ``(G, N)`` classes -> ``(G, N, ceil(N / 32))`` int32, bit
    ``j % 32`` of word ``[g, i, j // 32]`` set iff ``i < j`` and the IoU,
    zeroed between different classes, exceeds ``iou_thr``.  Plain PyTorch:
    the JAX package computes this IoU in XLA, not in a Pallas kernel."""
    iou = iou_ops.axis_aligned_bbox_overlaps_3d(boxes_corner, boxes_corner)
    same_class = classes[..., :, None] == classes[..., None, :]
    iou = torch.where(same_class, iou, torch.zeros((), device=iou.device))
    idx = torch.arange(boxes_corner.shape[-2], device=boxes_corner.device)
    return iou_ops.pack_mask((iou > iou_thr) & (idx[:, None] < idx[None, :]))


def aligned_nms_presorted_plain(boxes_corner, classes, valid, iou_thr: float):
    """Plain version of :func:`aligned_nms_presorted`: the fixpoint loop
    over the class-masked IoU matrices."""
    iou = iou_ops.axis_aligned_bbox_overlaps_3d(boxes_corner, boxes_corner)
    iou = torch.where(classes[..., :, None] == classes[..., None, :], iou,
                      torch.zeros((), device=iou.device))
    return greedy_nms_from_iou_batched(
        iou, iou.new_zeros(valid.shape), valid, iou_thr, presorted=True)


def aligned_nms_presorted(boxes_corner, classes, valid, iou_thr: float):
    """Class-aware axis-aligned NMS of ``G`` groups of ``N`` candidates
    whose rows are already in rank order: ``(G, N, 6)`` corner boxes,
    ``(G, N)`` classes and ``(G, N)`` bool -> keep ``(G, N)`` bool.  On CUDA
    tensors: the plain dominance mask (:func:`aligned_dominance_mask`),
    then the scan kernel over all groups in one launch, with no read back
    to the host."""
    if not boxes_corner.is_cuda:
        return aligned_nms_presorted_plain(boxes_corner, classes, valid,
                                           iou_thr)
    mask = aligned_dominance_mask(boxes_corner.float(), classes, iou_thr)
    return clip_kernel.nms_scan_op(mask, valid.contiguous())


def aligned_3d_nms(boxes_corner, scores, classes, valid, iou_thr: float):
    """Class-aware axis-aligned 3D NMS (``box3d_nms.py:91-138``, the ScanNet
    head's test-time NMS) of ``([B,] N, 6)`` corner-form boxes with
    ``([B,] N)`` scores, classes and bool ``valid`` -> keep ``([B,] N)``
    bool in the input order.

    The rank is the JAX package's: a stable ascending sort of the scores
    (invalid rows at ``_NEG``) reversed, so that equal scores go highest
    index first.  IoU between different classes counts as 0; suppression
    is the strict ``iou > iou_thr``.
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    boxes_corner, scores, classes, valid = (
        boxes_corner.reshape(-1, n, 6), scores.reshape(-1, n),
        classes.reshape(-1, n), valid.reshape(-1, n))
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG))
    order = torch.argsort(masked, dim=-1, stable=True).flip(-1)
    keep = aligned_nms_presorted(
        torch.take_along_dim(boxes_corner, order[..., None], dim=-2),
        torch.take_along_dim(classes, order, dim=-1),
        torch.take_along_dim(valid, order, dim=-1), iou_thr)
    return torch.empty_like(keep).scatter_(-1, order, keep).reshape(
        lead + (n,))


def take_per_sample(x, idx):
    """``x (B, N, ...)`` at ``idx (B, ...)`` along dim 1, per sample."""
    b = torch.arange(x.shape[0], device=x.device)
    return x[b.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def multiclass_nms_3d(mlvl_bboxes, mlvl_bboxes_for_nms, mlvl_scores,
                      mlvl_valid, *, score_thr: float, max_num: int,
                      iou_thr: float, use_rotate_nms: bool = True,
                      pre_nms_k: int = 256, mlvl_dir_scores=None):
    """Per-class rotated (or, ``use_rotate_nms=False``, axis-aligned BEV)
    NMS with fixed output size (``box3d_nms.py:8-88``).

    All samples and classes at once: one ranking over ``(B, C, N)``, one clip
    over all ``B*C*k*k`` pairs (or the plain axis-aligned IoU), one greedy
    pass.  The arguments may carry a
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
            iou_thr=iou_thr, use_rotate_nms=use_rotate_nms,
            pre_nms_k=pre_nms_k, mlvl_dir_scores=dirs)
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
    nms_presorted = (rotated_nms_presorted if use_rotate_nms
                     else normal_nms_presorted)
    keeps = nms_presorted(nms_boxes.reshape(b * n_classes, k, 5),
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
                            iou_thr: float, use_rotate_nms: bool = True,
                            mlvl_dir_scores=None):
    """Exact (untruncated) per-class NMS over all candidates, fixed output
    size: ``box3d_multiclass_nms`` (``box3d_nms.py:8-88``) with no
    candidate cap (JAX ``ops/nms.py:118-177``, the ``pre_nms_k <= 0``
    path).

    The candidates' boxes are the same for every class, so one ``(N, N)``
    IoU a sample (rotated, or axis-aligned with ``use_rotate_nms=False``)
    serves every class: each class ranks its valid candidates above
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
            iou_thr=iou_thr, use_rotate_nms=use_rotate_nms,
            mlvl_dir_scores=dirs)
        return {key: v[0] for key, v in out.items()}
    b, n, n_classes = mlvl_scores.shape
    if mlvl_dir_scores is None:
        mlvl_dir_scores = mlvl_scores.new_zeros((b, n))
    if use_rotate_nms:
        iou = iou_ops.rotated_iou_bev(mlvl_bboxes_for_nms, mlvl_bboxes_for_nms)
    else:
        xyxy = xywhr_to_xyxy(mlvl_bboxes_for_nms)
        iou = iou_ops.bbox_overlaps_2d(xyxy, xyxy)
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
