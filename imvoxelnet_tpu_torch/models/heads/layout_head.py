"""Camera pose (pitch, roll) and room layout head of the Total3D presets.

Counterpart of ``imvoxelnet_tpu/models/heads/layout_head.py``
(``LayoutHeadConfig``, ``LayoutHead``, ``layout_head_loss``,
``predicted_extrinsics``), after the reference's ``LayoutHead``
(``mmdet3d/models/dense_heads/layout_head.py:8-117``): two 3-layer MLPs on
the globally average-pooled ResNet C5 features of view 0; the angles are
period-limited, the layout sizes exponentiated.  The losses are a
sin-difference SmoothL1 (weight 100) per angle and the rotated IoU-3D loss
of the 7-DoF layout box (``configs/imvoxelnet/imvoxelnet_total_sunrgbd.py:
13-19``); the layout IoU goes through ``ops/iou.py:RectClipFunction``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops import boxes as box_ops
from ...ops import losses as loss_ops


@dataclasses.dataclass(frozen=True)
class LayoutHeadConfig:
    linear_size: int = 256
    dropout: float = 0.0
    loss_angle_weight: float = 100.0
    loss_layout_weight: float = 1.0


def _mlp(c_in: int, width: int, c_out: int, dropout: float):
    """Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear: the reference's
    ``{angle,layout}_mlp.{0,3,6}`` (``utils/checkpoint.py:307-314``)."""
    return nn.Sequential(nn.Linear(c_in, width), nn.ReLU(),
                         nn.Dropout(dropout), nn.Linear(width, width),
                         nn.ReLU(), nn.Dropout(dropout),
                         nn.Linear(width, c_out))


class LayoutHead(nn.Module):
    """``(B, C, H, W)`` C5 features -> angles ``(B, 2)`` (pitch, roll) and
    the layout ``(B, 7)``, a gravity-center box; float32 throughout."""

    def __init__(self, cfg: LayoutHeadConfig, in_channels: int = 2048):
        super().__init__()
        self.cfg = cfg
        self.angle_mlp = _mlp(in_channels, cfg.linear_size, 2, cfg.dropout)
        self.layout_mlp = _mlp(in_channels, cfg.linear_size, 7, cfg.dropout)

    def forward(self, c5):
        feat = c5.float().mean(dim=(2, 3))
        angles = box_ops.limit_period(self.angle_mlp(feat))
        raw = self.layout_mlp(feat)
        layout = torch.cat([raw[:, :3], torch.exp(raw[:, 3:6]), raw[:, 6:7]],
                           dim=-1)
        return angles, layout


def layout_head_loss(angles, layouts, gt_angles, gt_layouts,
                     cfg: LayoutHeadConfig):
    """The batch loss (``layout_head.py:78-106``): per sample, the
    sin-difference SmoothL1 (beta 1) of pitch and of roll and ``1 - IoU``
    of the layout box against ``gt_layouts`` (bottom-center, turned to its
    gravity center), each with an ``avg_factor`` of 1; then the batch
    means ``angle_loss`` (pitch + roll) and ``layout_loss``.

    Args:
      angles, layouts: the head's ``(B, 2)`` and ``(B, 7)``.
      gt_angles: ``(B, 2)``; gt_layouts: ``(B, 7)`` bottom-center boxes.
    """
    ones = torch.ones(angles.shape[0], device=angles.device)

    def angle_loss(a, gt):
        return loss_ops.smooth_l1_loss(
            torch.sin(a) * torch.cos(gt), torch.cos(a) * torch.sin(gt),
            beta=1.0, avg_factor=ones, loss_weight=cfg.loss_angle_weight)

    pitch = angle_loss(angles[:, 0], gt_angles[:, 0])
    roll = angle_loss(angles[:, 1], gt_angles[:, 1])
    layout = loss_ops.iou_3d_loss(layouts, box_ops.with_gravity_center(
        gt_layouts), avg_factor=ones, loss_weight=cfg.loss_layout_weight)
    return dict(angle_loss=(pitch + roll).mean(), layout_loss=layout.mean())


def predicted_extrinsics(angles):
    """``(B, 4, 4)`` extrinsics from the predicted ``(B, 2)`` pitch and roll
    (``get_extrinsics``, ``imvoxelnet.py:163-187``), for the Total3D test
    path: Total3D's rotation with yaw 0, ``t @ r.T`` for the axis swap
    ``t = [[0, 0, 1], [0, -1, 0], [-1, 0, 0]]``, columns ``[2, 0, 1]``,
    row 2 negated.  Built on the device from the angles, with no read back
    to the host and no constant copied from it."""
    pitch, roll = angles[:, 0], angles[:, 1]
    yaw = torch.zeros_like(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    r = torch.stack([
        torch.stack([cy * cp, sy * sr - cy * cr * sp,
                     cr * sy + cy * sp * sr], -1),
        torch.stack([sp, cp * cr, -cp * sr], -1),
        torch.stack([-cp * sy, cy * sr + cr * sy * sp,
                     cy * cr - sy * sp * sr], -1)], -2)         # (B, 3, 3)
    # t @ r.T: its rows are r's column 2 and the negated columns 1 and 0
    m = torch.stack([r[..., 2], -r[..., 1], -r[..., 0]], dim=-2)
    m = torch.stack([m[..., 2], m[..., 0], m[..., 1]], dim=-1)
    m = torch.cat([m[:, :2], -m[:, 2:]], dim=1)
    ext = torch.zeros((angles.shape[0], 4, 4), dtype=angles.dtype,
                      device=angles.device)
    ext[:, :3, :3] = m
    ext[:, 3, 3] = 1.0
    return ext
