"""Dense MaxIoU anchor-target assignment over a batch with padded GT.

Counterpart of ``imvoxelnet_tpu/core/target_assign.py`` (mmdet's
``MaxIoUAssigner`` with ``BboxOverlapsNearest3D``, ``PseudoSampler`` and
``anchor_target_single_assigner``), with the batch as an explicit leading
dimension where the JAX package ``vmap``s one sample.  Everything is a
device computation over a ``(B, N, G)`` IoU tensor: no host read.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import boxes as box_ops
from ..ops import iou as iou_ops
from . import coder


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.45
    min_pos_iou: float = 0.45


def max_iou_assign(anchors, gt_boxes, gt_mask, cfg: AssignerConfig):
    """Assign each anchor to a GT, to background or to ignore.

    Args:
      anchors: ``(N, 7)``.
      gt_boxes: ``(B, G, 7)``; gt_mask ``(B, G)`` bool.

    Returns:
      ``(B, N)`` int64: the index of the assigned GT, ``-1`` background,
      ``-2`` ignore.
    """
    ious = iou_ops.bbox_overlaps_nearest_3d(anchors, gt_boxes)  # (B, N, G)
    ious = torch.where(gt_mask[:, None, :], ious, -1.0)
    max_iou = ious.amax(dim=2)
    argmax = ious.argmax(dim=2)         # the first of equal maxima, as jnp
    assigned = torch.full_like(argmax, -2)
    assigned = torch.where(max_iou < cfg.neg_iou_thr, -1, assigned)
    assigned = torch.where(max_iou >= cfg.pos_iou_thr, argmax, assigned)

    # low-quality matches: each GT claims its best-overlap anchors; a later
    # GT overwrites an earlier one, so the highest claiming index wins
    gt_max = ious.amax(dim=1, keepdim=True)                      # (B, 1, G)
    claim = ((ious == gt_max) & (gt_max >= cfg.min_pos_iou)
             & gt_mask[:, None, :] & (gt_max > 0))
    g_idx = torch.arange(gt_boxes.shape[1], device=anchors.device)
    last_claim = torch.where(claim, g_idx, -1).amax(dim=2)
    return torch.where(last_claim >= 0, last_claim, assigned)


def get_direction_target(anchors_yaw, gt_yaw, dir_offset: float = 0.0,
                         num_bins: int = 2):
    """Yaw -> direction bin."""
    rot = box_ops.limit_period(gt_yaw - dir_offset, 0.0, 2 * math.pi)
    bins = torch.floor(rot / (2 * math.pi / num_bins)).long()
    return bins.clamp(0, num_bins - 1)


@torch.no_grad()
def anchor_targets(anchors, gt_boxes, gt_labels, gt_mask,
                   assigner: AssignerConfig, num_classes: int,
                   dir_offset: float = 0.0):
    """Anchor targets of a batch.

    Args:
      anchors ``(N, 7)``; gt_boxes ``(B, G, 7)``, gt_labels ``(B, G)`` int,
      gt_mask ``(B, G)`` bool.

    Returns:
      dict of ``(B, N)`` labels (background = ``num_classes``),
      label_weights, ``(B, N, 7)`` bbox_targets, bbox_weights, dir_targets,
      dir_weights, and ``(B,)`` n_pos (at least 1).
    """
    assigned = max_iou_assign(anchors, gt_boxes, gt_mask, assigner)
    pos = assigned >= 0
    neg = assigned == -1
    gt_idx = assigned.clamp(min=0)

    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gt_idx),
                         num_classes)
    matched = torch.gather(
        gt_boxes, 1, gt_idx[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    bbox_targets = torch.where(pos[..., None], coder.encode(anchors, matched),
                               0.0)
    dir_targets = get_direction_target(anchors[:, 6], matched[..., 6],
                                       dir_offset)
    weights = pos.float()
    return dict(labels=labels, label_weights=(pos | neg).float(),
                bbox_targets=bbox_targets, bbox_weights=weights,
                dir_targets=torch.where(pos, dir_targets, 0),
                dir_weights=weights, n_pos=pos.sum(dim=1).clamp(min=1))
