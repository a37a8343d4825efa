"""Axis-aligned BEV IoU for target assignment, axis-aligned 3D IoU for the
ScanNet head, rotated BEV IoU by an exact rect-rect clip, and the
differentiable rotated 3D IoU of the indoor loss.

Counterpart of ``imvoxelnet_tpu/ops/iou.py`` (``bbox_overlaps_2d``,
``axis_aligned_bbox_overlaps_3d``, ``bbox_overlaps_nearest_3d``,
``rect_intersection_area``, ``rotated_overlaps_bev``, ``rotated_iou_bev``,
``bbox_overlaps_3d``, ``iou_3d_aligned``).  On CUDA
tensors, for every pair count, ``rect_intersection_area`` runs
:class:`RectClipFunction`: the paired entry of the clip kernel
(``kernels/rect_clip.py``) forward and its backward kernel backward, as the
JAX package's ``custom_vjp`` runs its Pallas clip forward and the vjp of its
jnp clip backward.  ``rotated_overlaps_bev`` / ``rotated_iou_bev`` take the
pairwise entry, which reads each box once and makes no broadcast copy.  CPU
tensors take the plain versions, and autograd differentiates them.  The
plain versions of the kernel's two NMS entries and the packing of their
mask words are here too.
"""

from __future__ import annotations

import torch

from ..kernels import rect_clip as clip_kernel
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


def axis_aligned_bbox_overlaps_3d(boxes1, boxes2, mode: str = 'iou',
                                  is_aligned: bool = False,
                                  eps: float = 1e-6):
    """Axis-aligned 3D IoU (``mode='iou'``) or GIoU (``'giou'``) of
    corner-form boxes ``(x1, y1, z1, x2, y2, z2)``
    (``iou3d_calculator.py:207-320``, the ScanNet head's metric):
    ``(..., N, 6)`` x ``(..., M, 6)`` -> ``(..., N, M)``, or, with
    ``is_aligned``, ``(..., N, 6)`` x ``(..., N, 6)`` -> ``(..., N)``."""
    def vol(b):
        return ((b[..., 3] - b[..., 0]) * (b[..., 4] - b[..., 1])
                * (b[..., 5] - b[..., 2]))

    area1, area2 = vol(boxes1), vol(boxes2)
    if not is_aligned:
        boxes1, boxes2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    lt = torch.maximum(boxes1[..., :3], boxes2[..., :3])
    rb = torch.minimum(boxes1[..., 3:], boxes2[..., 3:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1] * wh[..., 2]
    union = (area1 + area2 - overlap).clamp(min=eps)
    ious = overlap / union
    if mode == 'iou':
        return ious
    if mode != 'giou':
        raise ValueError(mode)
    enc_wh = (torch.maximum(boxes1[..., 3:], boxes2[..., 3:])
              - torch.minimum(boxes1[..., :3], boxes2[..., :3])).clamp(min=0)
    enc = (enc_wh[..., 0] * enc_wh[..., 1] * enc_wh[..., 2]).clamp(min=eps)
    return ious - (enc - union) / enc


def bbox_overlaps_nearest_3d(boxes1, boxes2, mode: str = 'iou'):
    """Nearest-BEV IoU (or IoF) of ``(..., N, 7)`` and ``(..., M, 7)``
    boxes, the MaxIoU assignment metric of the KITTI anchor head."""
    return bbox_overlaps_2d(box_ops.nearest_bev(boxes1),
                            box_ops.nearest_bev(boxes2), mode=mode)


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


class RectClipFunction(torch.autograd.Function):
    """Paired clip areas of ``(n, 4, 2)`` float32 CUDA corner sets with a
    gradient: the forward is the clip kernel's paired entry, the backward
    its backward kernel (``kernels/rect_clip.py``), which computes what
    autograd of :func:`rect_intersection_area_plain` computes, up to the
    order of the sums."""

    @staticmethod
    def forward(ctx, corners1, corners2):
        ctx.save_for_backward(corners1, corners2)
        return clip_kernel.rect_intersection_area(corners1.detach(),
                                                  corners2.detach())

    @staticmethod
    def backward(ctx, grad_areas):
        corners1, corners2 = ctx.saved_tensors
        return clip_kernel.rect_intersection_area_grad(
            corners1.detach(), corners2.detach(),
            grad_areas.detach().float().contiguous())


def rect_intersection_area(corners1, corners2):
    """Exact intersection area of two rotated rects, ``(..., 4, 2)`` corner
    arrays with broadcastable batch dims -> ``(...,)`` float32.

    CUDA tensors go through :class:`RectClipFunction` (the clip kernel and
    its backward kernel); CPU tensors through
    :func:`rect_intersection_area_plain`, differentiated by autograd.
    """
    if not corners1.is_cuda:
        return rect_intersection_area_plain(corners1, corners2)
    batch = torch.broadcast_shapes(corners1.shape[:-2], corners2.shape[:-2])
    c1 = corners1.float().broadcast_to(batch + (4, 2)).reshape(-1, 4, 2)
    c2 = corners2.float().broadcast_to(batch + (4, 2)).reshape(-1, 4, 2)
    return RectClipFunction.apply(c1.contiguous(),
                                  c2.contiguous()).reshape(batch)


def rect_intersection_area_pairwise_plain(corners1, corners2):
    """Plain version of the kernel's pairwise entry: the paired plain clip
    on broadcast views.  ``(..., N, 4, 2)`` x ``(..., M, 4, 2)`` ->
    ``(..., N, M)``."""
    return rect_intersection_area_plain(corners1[..., :, None, :, :],
                                        corners2[..., None, :, :, :])


def rect_intersection_area_pairwise(corners1, corners2):
    """Intersection area of every rect of ``corners1 (..., N, 4, 2)`` with
    every rect of ``corners2 (..., M, 4, 2)`` -> ``(..., N, M)`` float32;
    the leading dims broadcast and are one group axis to the kernel (the
    operator ``torch.ops.imvx.rect_clip_pairwise`` on CUDA tensors)."""
    if not corners1.is_cuda:
        return rect_intersection_area_pairwise_plain(corners1, corners2)
    lead = torch.broadcast_shapes(corners1.shape[:-3], corners2.shape[:-3])
    n, m = corners1.shape[-3], corners2.shape[-3]
    c1 = corners1.float().broadcast_to(lead + (n, 4, 2)).reshape(-1, n, 4, 2)
    c2 = corners2.float().broadcast_to(lead + (m, 4, 2)).reshape(-1, m, 4, 2)
    return clip_kernel.pairwise_op(
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


def bbox_overlaps_3d(boxes1, boxes2, mode: str = 'iou'):
    """Pairwise rotated 3D IoU (``mode='iou'``) or intersection over the
    first box's volume (``'iof'``) of bottom-center boxes ``(..., N, 7)``
    and ``(..., M, 7)`` -> ``(..., N, M)``; the leading dims broadcast and
    are one group axis to the clip kernel (``BaseInstance3DBoxes.overlaps``,
    ``base_box3d.py:385-443``, the indoor protocol's metric; JAX
    ``ops/iou.py:336-358``).  On CUDA tensors the BEV areas are one launch
    of the clip kernel's pairwise entry."""
    inter_bev = rotated_overlaps_bev(box_ops.bev(boxes1), box_ops.bev(boxes2))
    zmin1 = boxes1[..., 2]
    zmax1 = zmin1 + boxes1[..., 5]
    zmin2 = boxes2[..., 2]
    zmax2 = zmin2 + boxes2[..., 5]
    z_overlap = (torch.minimum(zmax1[..., :, None], zmax2[..., None, :])
                 - torch.maximum(zmin1[..., :, None], zmin2[..., None, :])
                 ).clamp(min=0)
    inter = inter_bev * z_overlap
    vol1 = box_ops.volume(boxes1)[..., :, None]
    if mode == 'iou':
        denom = vol1 + box_ops.volume(boxes2)[..., None, :] - inter
    elif mode == 'iof':
        denom = vol1.expand(inter.shape)
    else:
        raise ValueError(f'unknown mode {mode!r}')
    return (inter / denom.clamp(min=_EPS)).clamp(0.0, 1.0)


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


def pack_mask(bits):
    """Pack a bool ``(..., N)`` into int32 words ``(..., ceil(N / 32))``:
    bit ``j % 32`` of word ``j // 32`` is entry ``j``; bits beyond N are 0.

    Packed as bytes (eight bits shifted into one uint8 each), whose
    little-endian quadruples are the words: no intermediate wider than the
    bool input."""
    n = bits.shape[-1]
    pad = -n % 32
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    lanes = torch.arange(8, dtype=torch.uint8, device=bits.device)
    octets = bits.reshape(bits.shape[:-1] + (-1, 8)).to(torch.uint8)
    packed = (octets << lanes).sum(-1, dtype=torch.uint8)
    return packed.view(torch.int32)


def unpack_mask(words, n: int):
    """Inverse of :func:`pack_mask`: int32 ``(..., W)`` -> bool ``(..., n)``."""
    lanes = torch.arange(32, device=words.device)
    bits = (words.long()[..., None] >> lanes) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n].bool()


def nms_over_bits_plain(corners, box_areas, iou_thr: float):
    """Plain version of the kernel's exact-NMS entry
    (``kernels/rect_clip.py:nms_over_bits``): which boxes overlap above the
    threshold, every ordered pair, from ``(S, N, 4, 2)`` corners and their
    ``(S, N)`` areas, packed to ``(S, N, ceil(N / 32))`` int32."""
    inter = rect_intersection_area_pairwise_plain(corners, corners)
    return pack_mask(iou_from_overlaps(inter, box_areas, box_areas) > iou_thr)


def nms_dominance_mask_plain(corners, box_areas, iou_thr: float):
    """Plain version of the kernel's fused NMS entry
    (``kernels/rect_clip.py:nms_dominance_mask``): which box would suppress
    which, from ``(G, N, 4, 2)`` corners in rank order and their ``(G, N)``
    areas, packed to ``(G, N, ceil(N / 32))`` int32."""
    inter = rect_intersection_area_pairwise_plain(corners, corners)
    iou = iou_from_overlaps(inter, box_areas, box_areas)
    idx = torch.arange(corners.shape[-3], device=corners.device)
    return pack_mask((iou > iou_thr) & (idx[:, None] < idx[None, :]))
