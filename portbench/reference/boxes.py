"""Functional 3D box geometry.

Counterpart of ``imvoxelnet_tpu/ops/boxes.py``.  Boxes are ``(N, 7)``
tensors ``(x, y, z, dx, dy, dz, yaw)`` with the bottom-center convention.
Every product of a point with a rotation or projection matrix is written
out as its sum of products, so that it is exact float32 arithmetic on the
card too (a matmul there may take TF32; the JAX package asks for
``Precision.HIGHEST``).
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def limit_period(val, offset: float = 0.5, period: float = PI):
    """Limit angles into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period


def rotation_3d_in_axis(points, angles, axis: int = 2):
    """Rotate points ``(..., M, 3)`` by angles ``(...)`` about ``axis``.

    The row-vector convention of the reference's einsum
    (``core/bbox/structures/utils.py:21-61``): ``out = points @ R``, for
    ``axis=2`` with ``R = [[c, -s, 0], [s, c, 0], [0, 0, 1]]``.  Axes 0 and 1
    take the reference's matrices verbatim, quirks included (JAX
    ``ops/boxes.py:59-78``): axis 0 also permutes the output (``out_x =
    z``), and axis 1 rotates with the opposite sign from axis 2.  The
    default is 2 (every caller of the model's paths rotates about z); the
    JAX function's is 0, so a caller ported from it passes its axis.
    """
    c = torch.cos(angles)[..., None]
    s = torch.sin(angles)[..., None]
    x, y, z = points.unbind(-1)
    if axis in (2, -1):
        out = (x * c + y * s, y * c - x * s, z)
    elif axis == 1:
        out = (x * c + z * s, y, z * c - x * s)
    elif axis == 0:
        out = (z, x * c + y * s, y * c - x * s)
    else:
        raise ValueError(f'axis should be in [0, 1, 2], got {axis}')
    return torch.stack(torch.broadcast_tensors(*out), dim=-1)


def volume(boxes):
    """Per-box volume ``dx * dy * dz``."""
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def gravity_center(boxes):
    """Bottom-center boxes -> their gravity (true) centers ``(..., 3)``."""
    return torch.cat([boxes[..., :2], boxes[..., 2:3] + boxes[..., 5:6] * 0.5],
                     dim=-1)


def to_bottom_center(boxes_gc):
    """Gravity-center boxes back to the bottom-center convention."""
    z_bottom = boxes_gc[..., 2:3] - boxes_gc[..., 5:6] * 0.5
    return torch.cat([boxes_gc[..., :2], z_bottom, boxes_gc[..., 3:]],
                     dim=-1)


def bev(boxes):
    """Rotated BEV box ``(x, y, dx, dy, yaw)``."""
    # sliced, not indexed by a list: an index list becomes a tensor on the
    # host and is copied to the device on every call
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]],
                     dim=-1)


def nearest_bev(boxes):
    """Axis-aligned (rotation-snapped) BEV box ``(x1, y1, x2, y2)``: the yaw
    is normalised to ``[-pi/2, pi/2)`` and the BEV extents swap where
    ``|yaw| > pi/4``."""
    rot = torch.abs(limit_period(boxes[..., 6], 0.5, PI))
    swap = (rot > PI / 4)[..., None]
    wh = torch.where(swap, boxes[..., 3:5].flip(-1), boxes[..., 3:5])
    centers = boxes[..., 0:2]
    return torch.cat([centers - wh / 2, centers + wh / 2], dim=-1)


def bev_corners(boxes_xywhr):
    """4 BEV corners of rotated rects ``(..., 4, 2)`` in CCW order.

    Yaw convention of ``rotation_3d_in_axis`` and mmdet3d's rotated BEV
    IoU: the template ``(tx, ty)`` is rotated as the row vector
    ``(tx, ty) @ [[c, -s], [s, c]]``.
    """
    x, y, w, h, r = boxes_xywhr.unbind(-1)
    tx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    ty = torch.stack([h / 2, h / 2, -h / 2, -h / 2], dim=-1)
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    rx = tx * c + ty * s
    ry = -tx * s + ty * c
    return torch.stack([rx + x[..., None], ry + y[..., None]], dim=-1)


def bev_corners_loss(boxes_xywhr):
    """4 BEV corners ``(..., 4, 2)`` in the rotated-IoU *loss* extension's
    yaw convention (``box2corners_th``): the template is rotated as
    ``(tx, ty) @ [[c, s], [-s, c]]``, the opposite direction from
    :func:`bev_corners`.  The IoU-3D training loss uses this convention,
    :func:`bev_corners` everything else."""
    x, y, w, h, r = boxes_xywhr.unbind(-1)
    tx = torch.stack([w / 2, -w / 2, -w / 2, w / 2], dim=-1)
    ty = torch.stack([h / 2, h / 2, -h / 2, -h / 2], dim=-1)
    c, s = torch.cos(r)[..., None], torch.sin(r)[..., None]
    rx = tx * c - ty * s
    ry = tx * s + ty * c
    return torch.stack([rx + x[..., None], ry + y[..., None]], dim=-1)

