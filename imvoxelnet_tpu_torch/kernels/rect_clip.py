"""Wrappers of the rotated-rect clip kernels (``csrc/rect_clip.cu``).

Replaces ``imvoxelnet_tpu/ops/iou_pallas.py:rect_intersection_area_pallas``.
One clip serves three entry points, which share the ``launches`` count:
paired areas, pairwise areas of two box sets per group, and the pairwise NMS
dominance mask (IoU, threshold and rank order fused, one bit per pair).
``nms_scan`` walks such a mask greedily; it counts in ``scan_launches``.
The paired entry has a backward, ``rect_intersection_area_grad`` (the
vector-Jacobian product of the clip: a zero pass over every pair, then a
sweep over the pairs with an area gradient), counted in ``grad_launches``,
one a call; ``ops/iou.py:RectClipFunction`` joins the two.

Plain versions: ``ops/iou.py`` (``rect_intersection_area_plain``, whose
autograd is the backward's, ``rect_intersection_area_pairwise_plain``,
``nms_dominance_mask_plain``) and ``ops/nms.py`` (``nms_scan_plain``).
"""

from __future__ import annotations

import torch

from . import build
from ._checks import require, same_device, stream_of

launches = 0
scan_launches = 0
grad_launches = 0

_MAX_GRID_YZ = 65535
# the scan keeps 33 words per 32 candidates in 48 KB of shared memory
_MAX_SCAN_N = 32 * (48 * 1024 // (33 * 4))


def mask_words(n: int) -> int:
    """32-bit words per row of an ``n``-candidate dominance mask."""
    return (n + 31) // 32


def _corners(t, name, ndim):
    if t.requires_grad:
        raise RuntimeError('the rect clip kernel has no backward of its own; '
                           'call it under torch.no_grad(), or take '
                           'ops.iou.rect_intersection_area for gradients')
    require(t, name, (torch.float32,), ndim)
    if t.shape[-2:] != (4, 2):
        raise ValueError(f'{name} must end in (4, 2), got {tuple(t.shape)}')


def _launch(fn_name, *args):
    global launches
    build.check(build.kernel('rect_clip', fn_name)(*args), fn_name)
    launches += 1


def _paired(corners1, corners2):
    _corners(corners1, 'corners1', 3)
    _corners(corners2, 'corners2', 3)
    same_device(corners1, corners2)
    n = corners1.shape[0]
    if corners2.shape[0] != n:
        raise ValueError(f'corners must both be (n, 4, 2), got '
                         f'{tuple(corners1.shape)}, {tuple(corners2.shape)}')
    return n


def rect_intersection_area(corners1, corners2):
    """Intersection areas of ``(n, 4, 2)`` float32 rect pairs -> ``(n,)``."""
    n = _paired(corners1, corners2)
    areas = torch.empty((n,), dtype=torch.float32, device=corners1.device)
    if n:
        _launch('imvx_rect_clip', corners1.data_ptr(), corners2.data_ptr(),
                areas.data_ptr(), n, stream_of(corners1))
    return areas


def rect_intersection_area_grad(corners1, corners2, grad_areas):
    """The gradients of ``sum(grad_areas * areas)`` with respect to both
    ``(n, 4, 2)`` float32 corner sets, for ``(n,)`` float32 ``grad_areas``:
    the backward of :func:`rect_intersection_area`.

    One call is one memset and two kernel launches (``csrc/rect_clip.cu``).
    The memset zeroes a live count on the device.  The zero pass
    (``rect_clip_grad_zero_kernel``) writes zeros for every pair and lists
    the pairs whose area gradient is not 0 (NaN included).  The sweep
    (``rect_clip_grad_sweep_kernel``), on a grid of resident blocks, runs
    the clip and its reverse sweep for the listed pairs alone, up to the
    count it reads on the device.  Nothing is
    read back to the host.  Each pair is computed alone, so the result does
    not depend on the list's order and repeats bit for bit."""
    grad1, grad2, _ = rect_intersection_area_grad_live(corners1, corners2,
                                                       grad_areas)
    return grad1, grad2


def rect_intersection_area_grad_live(corners1, corners2, grad_areas):
    """:func:`rect_intersection_area_grad`, also returning the kernels' live
    count: ``(grad1, grad2, n_live)``, ``n_live`` a ``(1,)`` int32 CUDA
    tensor, the number of pairs that the sweep ran."""
    global grad_launches
    n = _paired(corners1, corners2)
    require(grad_areas, 'grad_areas', (torch.float32,), 1)
    same_device(corners1, grad_areas)
    if grad_areas.shape[0] != n:
        raise ValueError(f'grad_areas must be ({n},), got '
                         f'{tuple(grad_areas.shape)}')
    if n >= 2 ** 31:
        raise ValueError(f'{n} pairs exceed the 32-bit live list')
    # fresh allocations: 16-byte aligned, as the zero pass's stores need
    grad1 = torch.empty_like(corners1)
    grad2 = torch.empty_like(corners2)
    scratch = torch.empty((n + 1,), dtype=torch.int32,
                          device=corners1.device)
    if n:
        build.check(build.kernel('rect_clip', 'imvx_rect_clip_grad')(
            corners1.data_ptr(), corners2.data_ptr(), grad_areas.data_ptr(),
            grad1.data_ptr(), grad2.data_ptr(), scratch.data_ptr(), n,
            stream_of(corners1)), 'imvx_rect_clip_grad')
        grad_launches += 1
    else:
        scratch.zero_()
    return grad1, grad2, scratch[:1]


def _grid_fits(g, n):
    if g > _MAX_GRID_YZ or (n + 3) // 4 > _MAX_GRID_YZ:
        raise ValueError(f'{g} groups of {n} rows exceed the launch grid')


def rect_intersection_area_pairwise(corners1, corners2):
    """Intersection areas of every rect of ``corners1 (G, N, 4, 2)`` with
    every rect of ``corners2 (G, M, 4, 2)`` -> ``(G, N, M)`` float32."""
    _corners(corners1, 'corners1', 4)
    _corners(corners2, 'corners2', 4)
    same_device(corners1, corners2)
    g, n = corners1.shape[:2]
    m = corners2.shape[1]
    if corners2.shape[0] != g:
        raise ValueError(f'group counts differ: {tuple(corners1.shape)}, '
                         f'{tuple(corners2.shape)}')
    _grid_fits(g, n)
    areas = torch.empty((g, n, m), dtype=torch.float32,
                        device=corners1.device)
    if areas.numel():
        _launch('imvx_rect_clip_pairwise', corners1.data_ptr(),
                corners2.data_ptr(), areas.data_ptr(), g, n, m,
                stream_of(corners1))
    return areas


def nms_dominance_mask(corners, box_areas, iou_thr: float):
    """Which box would suppress which, one bit per pair.

    Args:
      corners: ``(G, N, 4, 2)`` float32 BEV corners, rows in rank order.
      box_areas: ``(G, N)`` float32 ``w * h`` of the same boxes.
    Returns:
      ``(G, N, ceil(N / 32))`` int32: bit ``j % 32`` of word ``[g, i, j // 32]``
      is set iff ``i < j`` and ``inter / max(a_i + a_j - inter, 1e-8) >
      iou_thr``.
    """
    _corners(corners, 'corners', 4)
    require(box_areas, 'box_areas', (torch.float32,), 2)
    same_device(corners, box_areas)
    g, n = corners.shape[:2]
    if box_areas.shape != (g, n):
        raise ValueError(f'box_areas must be {(g, n)}, got '
                         f'{tuple(box_areas.shape)}')
    _grid_fits(g, n)
    mask = torch.empty((g, n, mask_words(n)), dtype=torch.int32,
                       device=corners.device)
    if mask.numel():
        _launch('imvx_nms_mask', corners.data_ptr(), box_areas.data_ptr(),
                float(iou_thr), mask.data_ptr(), g, n, stream_of(corners))
    return mask


def nms_scan(mask, valid):
    """Greedy NMS over a dominance mask: walking the rows in rank order, a
    row that is valid and not yet suppressed is kept and suppresses the rows
    its bits name.

    Args:
      mask: ``(G, N, ceil(N / 32))`` int32 from :func:`nms_dominance_mask`.
      valid: ``(G, N)`` bool.
    Returns:
      keep: ``(G, N)`` bool, in the same (rank) order.
    """
    global scan_launches
    require(mask, 'mask', (torch.int32,), 3)
    require(valid, 'valid', (torch.bool,), 2)
    same_device(mask, valid)
    g, n = valid.shape
    if mask.shape != (g, n, mask_words(n)):
        raise ValueError(f'mask must be {(g, n, mask_words(n))}, got '
                         f'{tuple(mask.shape)}')
    if n > _MAX_SCAN_N:
        raise ValueError(f'the scan holds at most {_MAX_SCAN_N} candidates '
                         f'per group, got {n}')
    keep = torch.empty((g, n), dtype=torch.bool, device=valid.device)
    if keep.numel():
        build.check(build.kernel('rect_clip', 'imvx_nms_scan')(
            mask.data_ptr(), valid.data_ptr(), keep.data_ptr(), g, n,
            stream_of(valid)), 'imvx_nms_scan')
        scan_launches += 1
    return keep


# The serving entries as operators of PyTorch's dispatcher
# (``torch.ops.imvx``), so that ``torch.export`` records each launch as one
# node: their CUDA implementations are the wrappers above (which count the
# launches; the names are looked up at each call), their fake
# implementations give the outputs' shapes.  No CPU implementation is
# registered: the plain versions are the op layers'.
pairwise_op = torch.library.custom_op(
    'imvx::rect_clip_pairwise', lambda corners1, corners2:
    rect_intersection_area_pairwise(corners1.contiguous(),
                                    corners2.contiguous()),
    mutates_args=(), device_types='cuda',
    schema='(Tensor corners1, Tensor corners2) -> Tensor')
nms_mask_op = torch.library.custom_op(
    'imvx::nms_mask', lambda corners, box_areas, iou_thr:
    nms_dominance_mask(corners.contiguous(), box_areas.contiguous(),
                       iou_thr),
    mutates_args=(), device_types='cuda',
    schema='(Tensor corners, Tensor box_areas, float iou_thr) -> Tensor')
nms_scan_op = torch.library.custom_op(
    'imvx::nms_scan', lambda mask, valid: nms_scan(mask.contiguous(),
                                                   valid.contiguous()),
    mutates_args=(), device_types='cuda',
    schema='(Tensor mask, Tensor valid) -> Tensor')


@pairwise_op.register_fake
def _(corners1, corners2):
    return corners1.new_empty(
        (corners1.shape[0], corners1.shape[1], corners2.shape[1]))


@nms_mask_op.register_fake
def _(corners, box_areas, iou_thr):
    g, n = corners.shape[:2]
    return corners.new_empty((g, n, mask_words(n)), dtype=torch.int32)


@nms_scan_op.register_fake
def _(mask, valid):
    return torch.empty_like(valid)
