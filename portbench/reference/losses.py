"""Losses of the KITTI anchor head and the SUN RGB-D indoor head, masked
rather than index-gathered.

Counterpart of ``imvoxelnet_tpu/ops/losses.py`` (``_reduce``,
``sigmoid_focal_loss``, ``smooth_l1_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy``, ``iou_3d_loss``):
callers pass dense per-element weights and an ``avg_factor``, so no shape
depends on the data and nothing waits for the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def iou_3d_loss(pred_gc, target_gc, weight=None, *, avg_factor=1.0,
                loss_weight: float = 1.0):
    """``1 - IoU`` of aligned rotated 3D gravity-center boxes ``(..., 7)``
    (``IoU3DLoss``); the intersection goes through the differentiable clip
    (``ops/iou.py:iou_3d_aligned``)."""
    ious = iou_ops.iou_3d_aligned(pred_gc, target_gc)
    return loss_weight * _reduce(1.0 - ious, weight, avg_factor)

