"""Wrapper of the backprojection kernel (``csrc/backproject.cu``).

Replaces ``imvoxelnet_tpu/ops/backproject_pallas.py:backproject_pallas``.
The plain version is ``ops/backproject.py:backproject_batch_plain``.
"""

from __future__ import annotations

import torch

from . import build
from ._checks import require, same_device, stream_of

launches = 0


def backproject_batch(features, points, projections, valid_hw):
    """Masked feature sums and view counts, voxel-major.

    Args:
      features: ``(B, V, Hf, Wf, C)`` float32 or bfloat16, C even.
      points: ``(B, P, 3)`` float32 voxel centers.
      projections: ``(B, V, 3, 4)`` float32.
      valid_hw: ``(B, 2)`` int32 valid ``(h, w)`` feature extent.

    Returns:
      acc ``(P, B, C)`` and cnt ``(P, B)`` in the features' dtype, summed in
      float32.
    """
    global launches
    require(features, 'features', (torch.float32, torch.bfloat16), 5)
    require(points, 'points', (torch.float32,), 3)
    require(projections, 'projections', (torch.float32,), 4)
    require(valid_hw, 'valid_hw', (torch.int32,), 2)
    same_device(features, points, projections, valid_hw)
    b, v, hf, wf, c = features.shape
    p = points.shape[1]
    if c % 2 or c < 2:
        raise ValueError(f'channel count must be even and positive, got {c}')
    if (points.shape != (b, p, 3) or projections.shape != (b, v, 3, 4)
            or valid_hw.shape != (b, 2)):
        raise ValueError('shape mismatch: features '
                         f'{tuple(features.shape)}, points '
                         f'{tuple(points.shape)}, projections '
                         f'{tuple(projections.shape)}, valid_hw '
                         f'{tuple(valid_hw.shape)}')
    acc = torch.empty((p, b, c), dtype=features.dtype, device=features.device)
    cnt = torch.empty((p, b), dtype=features.dtype, device=features.device)
    err = build.kernel('backproject')(
        features.data_ptr(), int(features.dtype == torch.bfloat16),
        points.data_ptr(), projections.data_ptr(), valid_hw.data_ptr(),
        acc.data_ptr(), cnt.data_ptr(), b, v, hf, wf, c, p,
        stream_of(features))
    build.check(err, 'backproject')
    launches += 1
    return acc, cnt
