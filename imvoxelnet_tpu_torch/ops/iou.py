"""Axis-aligned BEV IoU for target assignment, and rotated BEV IoU by an
exact rect-rect clip.

Counterpart of ``imvoxelnet_tpu/ops/iou.py`` (``bbox_overlaps_2d``,
``bbox_overlaps_nearest_3d``, ``rect_intersection_area``,
``rotated_overlaps_bev``, ``rotated_iou_bev``).  On CUDA tensors, for every
pair count, ``rect_intersection_area`` runs the paired entry of the clip
kernel (``kernels/rect_clip.py``) and ``rotated_overlaps_bev`` /
``rotated_iou_bev`` its pairwise entry, which reads each box once and makes
no broadcast copy; CPU tensors take the plain versions.  The plain version
of the kernel's fused NMS entry and the packing of its mask words are here
too.
"""

from __future__ import annotations

import torch

from ..kernels import rect_clip as clip_kernel
from . import boxes as box_ops

_EPS = 1e-8
_SLOTS = 8  # rect ∩ rect has at most 8 vertices


def bbox_overlaps_2d(boxes1, boxes2, eps: float = 1e-6):
    """Pairwise axis-aligned IoU of xyxy boxes ``(..., N, 4)`` and
    ``(..., M, 4)`` -> ``(..., N, M)``; leading dims broadcast."""
    def area(b):
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])

    area1, area2 = area(boxes1), area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / union.clamp(min=eps)


def bbox_overlaps_nearest_3d(boxes1, boxes2):
    """Nearest-BEV IoU of ``(..., N, 7)`` and ``(..., M, 7)`` boxes, the
    MaxIoU assignment metric of the KITTI anchor head."""
    return bbox_overlaps_2d(box_ops.nearest_bev(boxes1),
                            box_ops.nearest_bev(boxes2))


def rect_intersection_area_plain(corners1, corners2):
    """Plain PyTorch version of the clip kernel: a port of
    ``_rect_intersection_area_jnp`` (``imvoxelnet_tpu/ops/iou.py:206-274``).

    Sort-free Sutherland-Hodgman clip of rect1 against rect2's four edges in
    structure-of-arrays form, ``(8 slots, P pairs)``.  Every sum whose order
    matters is written out in order, so the areas are bit-identical to the
    kernel's and to the JAX reference's.

    Args:
      corners1, corners2: ``(..., 4, 2)``.
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


def rect_intersection_area(corners1, corners2):
    """Exact intersection area of two rotated rects, ``(..., 4, 2)`` corner
    arrays with broadcastable batch dims -> ``(...,)`` float32.

    CUDA tensors go through the clip kernel (forward only); CPU tensors
    through :func:`rect_intersection_area_plain`.
    """
    if not corners1.is_cuda:
        return rect_intersection_area_plain(corners1, corners2)
    batch = torch.broadcast_shapes(corners1.shape[:-2], corners2.shape[:-2])
    c1 = corners1.float().broadcast_to(batch + (4, 2)).reshape(-1, 4, 2)
    c2 = corners2.float().broadcast_to(batch + (4, 2)).reshape(-1, 4, 2)
    return clip_kernel.rect_intersection_area(
        c1.contiguous(), c2.contiguous()).reshape(batch)


def rect_intersection_area_pairwise_plain(corners1, corners2):
    """Plain version of the kernel's pairwise entry: the paired plain clip
    on broadcast views.  ``(..., N, 4, 2)`` x ``(..., M, 4, 2)`` ->
    ``(..., N, M)``."""
    return rect_intersection_area_plain(corners1[..., :, None, :, :],
                                        corners2[..., None, :, :, :])


def rect_intersection_area_pairwise(corners1, corners2):
    """Intersection area of every rect of ``corners1 (..., N, 4, 2)`` with
    every rect of ``corners2 (..., M, 4, 2)`` -> ``(..., N, M)`` float32;
    the leading dims broadcast and are one group axis to the kernel."""
    if not corners1.is_cuda:
        return rect_intersection_area_pairwise_plain(corners1, corners2)
    lead = torch.broadcast_shapes(corners1.shape[:-3], corners2.shape[:-3])
    n, m = corners1.shape[-3], corners2.shape[-3]
    c1 = corners1.float().broadcast_to(lead + (n, 4, 2)).reshape(-1, n, 4, 2)
    c2 = corners2.float().broadcast_to(lead + (m, 4, 2)).reshape(-1, m, 4, 2)
    return clip_kernel.rect_intersection_area_pairwise(
        c1.contiguous(), c2.contiguous()).reshape(lead + (n, m))


def rotated_overlaps_bev(boxes_xywhr1, boxes_xywhr2):
    """Pairwise rotated BEV intersection areas ``(..., N, M)``; leading batch
    dims (a class axis in multiclass NMS) broadcast."""
    return rect_intersection_area_pairwise(
        box_ops.bev_corners(boxes_xywhr1), box_ops.bev_corners(boxes_xywhr2))


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


def pack_mask(bits):
    """Pack a bool ``(..., N)`` into int32 words ``(..., ceil(N / 32))``:
    bit ``j % 32`` of word ``j // 32`` is entry ``j``; bits beyond N are 0."""
    n = bits.shape[-1]
    pad = -n % 32
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    lanes = torch.arange(32, device=bits.device)
    words = (bits.reshape(bits.shape[:-1] + (-1, 32)).long() << lanes).sum(-1)
    # bit 31 is the sign of an int32 word
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_mask(words, n: int):
    """Inverse of :func:`pack_mask`: int32 ``(..., W)`` -> bool ``(..., n)``."""
    lanes = torch.arange(32, device=words.device)
    bits = (words.long()[..., None] >> lanes) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].bool()


def nms_dominance_mask_plain(corners, box_areas, iou_thr: float):
    """Plain version of the kernel's fused NMS entry
    (``kernels/rect_clip.py:nms_dominance_mask``): which box would suppress
    which, from ``(G, N, 4, 2)`` corners in rank order and their ``(G, N)``
    areas, packed to ``(G, N, ceil(N / 32))`` int32."""
    inter = rect_intersection_area_pairwise_plain(corners, corners)
    iou = iou_from_overlaps(inter, box_areas, box_areas)
    idx = torch.arange(corners.shape[-3], device=corners.device)
    return pack_mask((iou > iou_thr) & (idx[:, None] < idx[None, :]))
