"""Losses of the KITTI anchor head, the indoor heads (SUN RGB-D, ScanNet)
and the Total3D layout head, masked rather than index-gathered.

Counterpart of ``imvoxelnet_tpu/ops/losses.py`` (``_reduce``,
``sigmoid_focal_loss``, ``smooth_l1_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy``, ``axis_aligned_iou_loss``, ``iou_3d_loss``,
``_smallest_enclosing_area``, ``giou_3d_loss``):
callers pass dense per-element weights and an ``avg_factor``, so no shape
depends on the data and nothing waits for the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import boxes as box_ops
from . import iou as iou_ops


def _reduce(loss, weight, avg_factor):
    """``sum(loss * weight) / max(avg_factor, 1e-6)``.  A ``(B,)`` tensor
    ``avg_factor`` reduces each sample (the leading dim) by its own factor
    and returns ``(B,)``: the JAX package's ``vmap`` over samples."""
    if weight is not None:
        loss = loss * weight
    if not torch.is_tensor(avg_factor):
        return loss.sum() / max(avg_factor, 1e-6)
    if avg_factor.dim():
        loss = loss.reshape(avg_factor.shape[0], -1).sum(1)
    else:
        loss = loss.sum()
    return loss / avg_factor.clamp(min=1e-6)


def sigmoid_focal_loss(logits, labels, weight=None, *, gamma: float = 2.0,
                       alpha: float = 0.25, avg_factor=1.0,
                       loss_weight: float = 1.0):
    """Sigmoid focal loss of ``logits (..., N, C)`` for ``labels (..., N)``
    in ``[0, C]``, where ``C`` is background (no positive column)."""
    num_classes = logits.shape[-1]
    classes = torch.arange(num_classes, device=logits.device)
    one_hot = (labels[..., None] == classes).to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = torch.logaddexp(torch.zeros_like(logits), logits) - logits * one_hot
    p_t = p * one_hot + (1 - p) * (1 - one_hot)
    alpha_t = alpha * one_hot + (1 - alpha) * (1 - one_hot)
    loss = (alpha_t * (1 - p_t) ** gamma * ce).sum(dim=-1)
    return loss_weight * _reduce(loss, weight, avg_factor)


def smooth_l1_loss(pred, target, weight=None, *, beta: float = 1.0,
                   avg_factor=1.0, loss_weight: float = 1.0):
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return loss_weight * _reduce(loss, weight, avg_factor)


def softmax_cross_entropy(logits, labels, weight=None, *, avg_factor=1.0,
                          loss_weight: float = 1.0):
    log_p = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_p, -1, labels[..., None].long())[..., 0]
    return loss_weight * _reduce(nll, weight, avg_factor)


def binary_cross_entropy(logits, targets, weight=None, *, avg_factor=1.0,
                         loss_weight: float = 1.0):
    """Sigmoid BCE with logits, ``logaddexp(0, x) - x * t`` (the indoor
    head's centerness loss)."""
    loss = torch.logaddexp(torch.zeros_like(logits), logits) - logits * targets
    return loss_weight * _reduce(loss, weight, avg_factor)


def axis_aligned_iou_loss(pred_corner, target_corner, weight=None, *,
                          avg_factor=1.0, loss_weight: float = 1.0):
    """``1 - IoU`` of aligned axis-aligned corner-form boxes ``(..., 6)``
    (``AxisAlignedIoULoss``, the ScanNet head's box loss)."""
    ious = iou_ops.axis_aligned_bbox_overlaps_3d(pred_corner, target_corner,
                                                 is_aligned=True)
    return loss_weight * _reduce(1.0 - ious, weight, avg_factor)


def iou_3d_loss(pred_gc, target_gc, weight=None, *, avg_factor=1.0,
                loss_weight: float = 1.0):
    """``1 - IoU`` of aligned rotated 3D gravity-center boxes ``(..., 7)``
    (``IoU3DLoss``); the intersection goes through the differentiable clip
    (``ops/iou.py:iou_3d_aligned``)."""
    ious = iou_ops.iou_3d_aligned(pred_gc, target_gc)
    return loss_weight * _reduce(1.0 - ious, weight, avg_factor)


def _smallest_enclosing_area(corners):
    """Least-area enclosing rectangle of ``(..., 8, 2)`` corner sets
    (``smallest_bounding_box``, ``min_enclosing_box.py:142-172``): each of
    the 28 corner pairs is a candidate edge direction, whose rectangle has
    the extents of the projections along it and across it; the least area
    wins (a pair closer than 1e-6 is no candidate).  Plain PyTorch, as the
    JAX version is plain jnp; the projections are written out as sums of
    products (no TF32 on the card)."""
    n = corners.shape[-2]
    ii, jj = torch.triu_indices(n, n, offset=1, device=corners.device)
    d = corners[..., jj, :] - corners[..., ii, :]                # (..., P, 2)
    length = torch.linalg.norm(d, dim=-1)
    u = d / length.clamp(min=1e-8)[..., None]
    cx, cy = corners[..., None, :, 0], corners[..., None, :, 1]  # (..., 1, 8)
    ux, uy = u[..., 0:1], u[..., 1:2]                            # (..., P, 1)
    proj_u = cx * ux + cy * uy                                   # (..., P, 8)
    proj_v = cx * -uy + cy * ux
    w = proj_u.amax(-1) - proj_u.amin(-1)
    h = proj_v.amax(-1) - proj_v.amin(-1)
    area = torch.where(length > 1e-6, w * h,
                       torch.full((), 1e8, device=corners.device))
    return area.amin(-1)


def giou_3d_loss(pred_gc, target_gc, weight=None, *, avg_factor=1.0,
                 loss_weight: float = 1.0):
    """Rotated 3D GIoU loss of aligned gravity-center boxes ``(..., 7)``
    (``GIoU3DLoss``, ``iou3d_loss.py:36-59`` / ``cal_giou_3d``,
    ``oriented_iou_loss.py:112-130``, with the 'smallest' enclosing box):
    ``1 - IoU + (V_c - union) / V_c``.  The IoU goes through
    ``ops/iou.py:iou_3d_aligned`` (on CUDA tensors the clip kernel's paired
    entry and its backward kernel); the enclosing box is
    :func:`_smallest_enclosing_area` of both boxes' BEV corners in the loss
    extension's yaw convention, times the joint z extent.  No shipped head
    calls it (the heads use :func:`iou_3d_loss`)."""
    ious = iou_ops.iou_3d_aligned(pred_gc, target_gc)
    vol1 = pred_gc[..., 3] * pred_gc[..., 4] * pred_gc[..., 5]
    vol2 = target_gc[..., 3] * target_gc[..., 4] * target_gc[..., 5]
    # the union from the IoU: inter = iou * union, union = v1 + v2 - inter
    inter = ious * (vol1 + vol2) / (1.0 + ious)
    union = vol1 + vol2 - inter

    def bev(b):
        return torch.cat([b[..., 0:2], b[..., 3:5], b[..., 6:7]], dim=-1)

    c1 = box_ops.bev_corners_loss(bev(pred_gc))
    c2 = box_ops.bev_corners_loss(bev(target_gc))
    area_c = _smallest_enclosing_area(torch.cat([c1, c2], dim=-2))
    z_max = torch.maximum(pred_gc[..., 2] + pred_gc[..., 5] / 2,
                          target_gc[..., 2] + target_gc[..., 5] / 2)
    z_min = torch.minimum(pred_gc[..., 2] - pred_gc[..., 5] / 2,
                          target_gc[..., 2] - target_gc[..., 5] / 2)
    v_c = (area_c * (z_max - z_min)).clamp(min=1e-8)
    giou_loss = 1.0 - ious + (v_c - union) / v_c
    return loss_weight * _reduce(giou_loss, weight, avg_factor)
