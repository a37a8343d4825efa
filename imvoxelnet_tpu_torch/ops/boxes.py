"""Functional 3D box geometry (the subset the KITTI forward uses).

Counterpart of ``imvoxelnet_tpu/ops/boxes.py``.  Boxes are ``(N, 7)``
tensors ``(x, y, z, dx, dy, dz, yaw)`` with the bottom-center convention.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def limit_period(val, offset: float = 0.5, period: float = PI):
    """Limit angles into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period


def bev(boxes):
    """Rotated BEV box ``(x, y, dx, dy, yaw)``."""
    # sliced, not indexed by a list: an index list becomes a tensor on the
    # host and is copied to the device on every call
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]],
                     dim=-1)


def bev_corners(boxes_xywhr):
    """4 BEV corners of rotated rects ``(..., 4, 2)`` in CCW order.

    Yaw convention of ``rotation_3d_in_axis`` and the reference's iou3d
    kernel: the template ``(tx, ty)`` is rotated as the row vector
    ``(tx, ty) @ [[c, -s], [s, c]]``.
    """
    x, y, w, h, r = boxes_xywhr.unbind(-1)
    tx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    ty = torch.stack([h / 2, h / 2, -h / 2, -h / 2], dim=-1)
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    rx = tx * c + ty * s
    ry = -tx * s + ty * c
    return torch.stack([rx + x[..., None], ry + y[..., None]], dim=-1)
