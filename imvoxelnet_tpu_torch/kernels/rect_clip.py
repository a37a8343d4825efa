"""Wrapper of the rotated-rect clip kernel (``csrc/rect_clip.cu``).

Replaces ``imvoxelnet_tpu/ops/iou_pallas.py:rect_intersection_area_pallas``.
The plain version is ``ops/iou.py:rect_intersection_area_plain``.
"""

from __future__ import annotations

import torch

from . import build
from ._checks import require, same_device, stream_of

launches = 0


def rect_intersection_area(corners1, corners2):
    """Intersection areas of ``(n, 4, 2)`` float32 rect pairs -> ``(n,)``.

    Forward only: raises if a gradient is required.
    """
    global launches
    if corners1.requires_grad or corners2.requires_grad:
        raise RuntimeError('the rect clip kernel has no backward yet; '
                           'call it under torch.no_grad()')
    require(corners1, 'corners1', (torch.float32,), 3)
    require(corners2, 'corners2', (torch.float32,), 3)
    same_device(corners1, corners2)
    n = corners1.shape[0]
    if corners1.shape != (n, 4, 2) or corners2.shape != (n, 4, 2):
        raise ValueError(f'corners must both be (n, 4, 2), got '
                         f'{tuple(corners1.shape)}, {tuple(corners2.shape)}')
    areas = torch.empty((n,), dtype=torch.float32, device=corners1.device)
    if n == 0:
        return areas
    err = build.kernel('rect_clip')(
        corners1.data_ptr(), corners2.data_ptr(), areas.data_ptr(), n,
        stream_of(corners1))
    build.check(err, 'rect_clip')
    launches += 1
    return areas
