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


def rotation_matrix_2d(angles):
    """Row-vector 2D rotation ``[[c, -s], [s, c]]`` per angle, ``(..., 2,
    2)``: ``p_new = p @ M``."""
    c, s = torch.cos(angles), torch.sin(angles)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


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


def xywhr2xyxyr(boxes_xywhr):
    """Rotated BEV boxes ``(x, y, w, h, r)`` -> ``(x1, y1, x2, y2, r)``."""
    x, y, w, h, r = boxes_xywhr.split(1, dim=-1)
    return torch.cat([x - w / 2, y - h / 2, x + w / 2, y + h / 2, r], dim=-1)


def volume(boxes):
    """Per-box volume ``dx * dy * dz``."""
    return boxes[..., 3] * boxes[..., 4] * boxes[..., 5]


def gravity_center(boxes):
    """Bottom-center boxes -> their gravity (true) centers ``(..., 3)``."""
    return torch.cat([boxes[..., :2], boxes[..., 2:3] + boxes[..., 5:6] * 0.5],
                     dim=-1)


def with_gravity_center(boxes):
    """Bottom-center boxes ``(..., 7)`` -> the same boxes with their
    gravity center ``(cx, cy, cz, dx, dy, dz, yaw)``."""
    return torch.cat([gravity_center(boxes), boxes[..., 3:]], dim=-1)


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


# the reference's corner order (``depth_box3d.py:46-84``): x0y0z0, x0y0z1,
# x0y1z1, x0y1z0, x1y0z0, x1y0z1, x1y1z1, x1y1z0, centred at (0.5, 0.5, 0)
_CORNERS_NORM = ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
                 (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))


def corners(boxes):
    """The 8 corners ``(..., 8, 3)`` of bottom-center boxes ``(..., 7)``,
    rotated about z, in the reference's order."""
    norm = torch.tensor(_CORNERS_NORM, dtype=boxes.dtype,
                        device=boxes.device) - torch.tensor(
        (0.5, 0.5, 0.0), dtype=boxes.dtype, device=boxes.device)
    pts = norm * boxes[..., None, 3:6]
    pts = rotation_3d_in_axis(pts, boxes[..., 6], axis=2)
    return pts + boxes[..., None, :3]


def points_cam2img(points_3d, proj_mat):
    """Project points ``(..., 3)`` with a ``(4, 4)`` or ``(3, 4)`` matrix to
    pixels ``(..., 2)``: ``[p, 1] @ proj.T``, divided by its third entry."""
    x, y, z = points_3d.unbind(-1)

    def row(r):
        m = proj_mat[r]
        return ((m[0] * x + m[1] * y) + m[2] * z) + m[3]

    w = row(2)
    return torch.stack([row(0) / w, row(1) / w], dim=-1)


def _rot_mat_t(angle, mode):
    """The mode's ``rot_mat_T`` (``(3, 3)``, applied on the right) and the
    sign of the yaw change."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if mode == 'lidar':
        rows, sign = ((c, -s, zero), (s, c, zero), (zero, zero, one)), 1.0
    elif mode == 'cam':
        rows, sign = ((c, zero, -s), (zero, one, zero), (s, zero, c)), 1.0
    elif mode == 'depth':
        rows, sign = ((c, s, zero), (-s, c, zero), (zero, zero, one)), -1.0
    else:
        raise ValueError(mode)
    return torch.stack([torch.stack(r) for r in rows]), sign


def _times(xyz, m):
    """``xyz (..., 3) @ m (3, 3)``, summed in order."""
    x, y, z = xyz.unbind(-1)
    return torch.stack([(x * m[0, k] + y * m[1, k]) + z * m[2, k]
                        for k in range(3)], dim=-1)


def rotate_boxes(boxes, angle, mode: str = 'lidar', points=None):
    """Rotate ``(N, 7)`` boxes (and optional ``(M, >=3)`` points) in the
    plane of the mode (``lidar_box3d.py:113-151``, ``cam_box3d.py:168-203``,
    ``depth_box3d.py:113-157``): xyz times the mode's ``rot_mat_T`` on the
    right; the yaw ``+= angle`` for lidar and cam, ``-= angle`` for depth.

    Returns ``(boxes, points, rot_mat_T)`` (``points`` None if not given).
    """
    angle = torch.as_tensor(angle, dtype=boxes.dtype, device=boxes.device)
    rot_mat_t, sign = _rot_mat_t(angle, mode)
    yaw = boxes[..., 6] + sign * angle
    out = torch.cat([_times(boxes[..., :3], rot_mat_t), boxes[..., 3:6],
                     yaw[..., None]], dim=-1)
    if points is not None:
        points = torch.cat([_times(points[..., :3], rot_mat_t),
                            points[..., 3:]], dim=-1)
    return out, points, rot_mat_t


# per mode, the axis a BEV flip negates: (horizontal, vertical)
_FLIP_AXES = {'lidar': (1, 0), 'cam': (0, 2), 'depth': (0, 1)}


def flip_boxes(boxes, direction: str = 'horizontal', mode: str = 'lidar',
               points=None):
    """BEV flip of ``(N, 7)`` boxes (and optional points), per mode
    (``lidar_box3d.py:153-186``, ``cam_box3d.py:204-238``,
    ``depth_box3d.py:159-196``): one coordinate negated and ``yaw -> -yaw +
    pi`` (horizontal) or ``-yaw`` (vertical), with no period limiting.
    Returns ``(boxes, points)``."""
    axis = _FLIP_AXES[mode][0 if direction == 'horizontal' else 1]
    sign = torch.ones(3, dtype=boxes.dtype, device=boxes.device)
    sign[axis] = -1.0
    yaw = -boxes[..., 6] + (PI if direction == 'horizontal' else 0.0)
    out = torch.cat([boxes[..., :3] * sign, boxes[..., 3:6], yaw[..., None]],
                    dim=-1)
    if points is not None:
        points = torch.cat([points[..., :3] * sign, points[..., 3:]], dim=-1)
    return out, points


def in_range_bev(boxes, box_range):
    """Whether each box's BEV center lies strictly inside ``(x_min, y_min,
    x_max, y_max)`` (``lidar_box3d.py`` ``in_range_bev``)."""
    return ((boxes[..., 0] > box_range[0]) & (boxes[..., 1] > box_range[1])
            & (boxes[..., 0] < box_range[2])
            & (boxes[..., 1] < box_range[3]))
