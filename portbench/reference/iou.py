"""Axis-aligned BEV IoU for target assignment, rotated BEV IoU by an exact
rect-rect clip, and the differentiable rotated 3D IoU of the indoor loss.

Plain PyTorch throughout: every clip is :func:`rect_intersection_area`,
differentiated by autograd.
"""

from __future__ import annotations

import torch

from . import boxes as box_ops

_EPS = 1e-8
_SLOTS = 8  # rect ∩ rect has at most 8 vertices


def bbox_overlaps_2d(boxes1, boxes2, mode: str = 'iou', eps: float = 1e-6):
    """Pairwise axis-aligned IoU (``mode='iou'``) or intersection over the
    first box's area (``'iof'``) of xyxy boxes ``(..., N, 4)`` and ``(...,
    M, 4)`` -> ``(..., N, M)``; leading dims broadcast."""
    def area(b):
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])

    area1, area2 = area(boxes1), area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    if mode == 'iou':
        union = area1[..., :, None] + area2[..., None, :] - overlap
    elif mode == 'iof':
        union = area1[..., :, None].expand(overlap.shape)
    else:
        raise ValueError(mode)
    return overlap / union.clamp(min=eps)


def bbox_overlaps_nearest_3d(boxes1, boxes2, mode: str = 'iou'):
    """Nearest-BEV IoU (or IoF) of ``(..., N, 7)`` and ``(..., M, 7)``
    boxes, the MaxIoU assignment metric of the KITTI anchor head."""
    return bbox_overlaps_2d(box_ops.nearest_bev(boxes1),
                            box_ops.nearest_bev(boxes2), mode=mode)


def rect_intersection_area(corners1, corners2):
    """Exact intersection area of two rotated rects: a port of
    ``_rect_intersection_area_jnp`` (``imvoxelnet_tpu/ops/iou.py:206-274``).

    Sort-free Sutherland-Hodgman clip of rect1 against rect2's four edges in
    structure-of-arrays form, ``(8 slots, P pairs)``.  Every sum whose order
    matters is written out in the JAX function's order.

    Args:
      corners1, corners2: ``(..., 4, 2)`` with broadcastable batch dims.
    Returns:
      ``(...,)`` float32 intersection areas.
    """
    batch = torch.broadcast_shapes(corners1.shape[:-2], corners2.shape[:-2])
    c1 = corners1.float().broadcast_to(batch + (4, 2)).reshape(-1, 4, 2)
    c2 = corners2.float().broadcast_to(batch + (4, 2)).reshape(-1, 4, 2)
    p = c1.shape[0]
    dev = c1.device
    zero = torch.zeros((), device=dev)

    pad = torch.zeros((_SLOTS - 4, p), device=dev)
    vx = torch.cat([c1[:, :, 0].T, pad], dim=0)                  # (8, P)
    vy = torch.cat([c1[:, :, 1].T, pad], dim=0)
    count = torch.full((p,), 4, dtype=torch.int32, device=dev)
    cx2 = (((c2[:, 0, 0] + c2[:, 1, 0]) + c2[:, 2, 0]) + c2[:, 3, 0]) * 0.25
    cy2 = (((c2[:, 0, 1] + c2[:, 1, 1]) + c2[:, 2, 1]) + c2[:, 3, 1]) * 0.25
    slot = torch.arange(_SLOTS, device=dev)[:, None]

    for e in range(4):
        ax = c2[:, e, 0]
        ay = c2[:, e, 1]
        abx = c2[:, (e + 1) % 4, 0] - ax
        aby = c2[:, (e + 1) % 4, 1] - ay
        ref = abx * (cy2 - ay) - aby * (cx2 - ax)
        sign = torch.where(ref >= 0, 1.0, -1.0)

        s_cur = (abx * (vy - ay) - aby * (vx - ax)) * sign       # (8, P)
        active = slot < count
        take_next = (slot + 1) < count
        nvx = torch.where(take_next, vx.roll(-1, 0), vx[0:1])
        nvy = torch.where(take_next, vy.roll(-1, 0), vy[0:1])
        s_nxt = torch.where(take_next, s_cur.roll(-1, 0), s_cur[0:1])

        inside_cur = s_cur >= 0
        inside_nxt = s_nxt >= 0
        emit_cur = active & inside_cur
        emit_int = active & (inside_cur != inside_nxt)

        denom = s_cur - s_nxt
        t = s_cur / torch.where(denom.abs() > 1e-12, denom,
                                torch.ones((), device=dev))
        ix = vx + t * (nvx - vx)
        iy = vy + t * (nvy - vy)

        n_emit = emit_cur.int() + emit_int.int()
        pos0 = torch.cumsum(n_emit, dim=0) - n_emit               # exclusive
        pos1 = pos0 + emit_cur.int()
        # each packed slot k receives exactly one emitted value (or none)
        new_vx, new_vy = [], []
        for k in range(_SLOTS):
            w0 = (pos0 == k) & emit_cur
            w1 = (pos1 == k) & emit_int
            new_vx.append((torch.where(w0, vx, zero)
                           + torch.where(w1, ix, zero)).sum(0))
            new_vy.append((torch.where(w0, vy, zero)
                           + torch.where(w1, iy, zero)).sum(0))
        vx = torch.stack(new_vx)
        vy = torch.stack(new_vy)
        count = n_emit.sum(0, dtype=torch.int32)

    # shoelace over the 8 slots in order; inactive slots repeat vertex 0
    active = slot < count
    cvx = torch.where(active, vx, vx[0:1])
    cvy = torch.where(active, vy, vy[0:1])
    nvx = cvx.roll(-1, 0)
    nvy = cvy.roll(-1, 0)
    terms = cvx * nvy - cvy * nvx
    total = terms[0]
    for k in range(1, _SLOTS):
        total = total + terms[k]
    area = 0.5 * total.abs()
    area = torch.where(count > 2, area, zero)
    return area.reshape(batch)


def rotated_overlaps_bev(boxes_xywhr1, boxes_xywhr2):
    """Pairwise rotated BEV intersection areas ``(..., N, M)``; leading batch
    dims (a class axis in multiclass NMS) broadcast."""
    return rect_intersection_area(
        box_ops.bev_corners(boxes_xywhr1)[..., :, None, :, :],
        box_ops.bev_corners(boxes_xywhr2)[..., None, :, :, :])


def iou_from_overlaps(inter, area1, area2):
    """``inter (..., N, M)`` over the union of boxes of ``area1 (..., N)``
    and ``area2 (..., M)``."""
    return inter / (area1[..., :, None] + area2[..., None, :] - inter).clamp(
        min=_EPS)


def rotated_iou_bev(boxes_xywhr1, boxes_xywhr2):
    """Pairwise rotated BEV IoU ``(..., N, M)``."""
    inter = rotated_overlaps_bev(boxes_xywhr1, boxes_xywhr2)
    return iou_from_overlaps(inter,
                             boxes_xywhr1[..., 2] * boxes_xywhr1[..., 3],
                             boxes_xywhr2[..., 2] * boxes_xywhr2[..., 3])


def iou_3d_aligned(boxes1_gc, boxes2_gc):
    """Element-wise rotated 3D IoU of gravity-center boxes ``(..., 7)``
    ``(x, y, z, dx, dy, dz, yaw)``, differentiable: the IoU-3D loss's core
    (``cal_iou_3d``).  The BEV corners take the loss extension's yaw
    convention (``boxes.bev_corners_loss``)."""
    bev1 = torch.cat([boxes1_gc[..., 0:2], boxes1_gc[..., 3:5],
                      boxes1_gc[..., 6:7]], dim=-1)
    bev2 = torch.cat([boxes2_gc[..., 0:2], boxes2_gc[..., 3:5],
                      boxes2_gc[..., 6:7]], dim=-1)
    inter_bev = rect_intersection_area(box_ops.bev_corners_loss(bev1),
                                       box_ops.bev_corners_loss(bev2))
    zmax = torch.minimum(boxes1_gc[..., 2] + boxes1_gc[..., 5] * 0.5,
                         boxes2_gc[..., 2] + boxes2_gc[..., 5] * 0.5)
    zmin = torch.maximum(boxes1_gc[..., 2] - boxes1_gc[..., 5] * 0.5,
                         boxes2_gc[..., 2] - boxes2_gc[..., 5] * 0.5)
    inter = inter_bev * (zmax - zmin).clamp(min=0)
    vol1 = boxes1_gc[..., 3] * boxes1_gc[..., 4] * boxes1_gc[..., 5]
    vol2 = boxes2_gc[..., 3] * boxes2_gc[..., 4] * boxes2_gc[..., 5]
    union = (vol1 + vol2 - inter).clamp(min=_EPS)
    return inter / union

