"""Wrappers of the backprojection kernels (``csrc/backproject.cu``).

``backproject_batch`` replaces
``imvoxelnet_tpu/ops/backproject_pallas.py:backproject_pallas``; its plain
version is ``ops/backproject.py:backproject_batch_plain``.
``backproject_batch_grad`` is its backward (the JAX package differentiates
the XLA gather); its plain version is
``ops/backproject.py:backproject_batch_grad_plain``.
"""

from __future__ import annotations

import torch

from . import build
from ._checks import require, same_device, stream_of

launches = 0
grad_launches = 0


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


def backproject_batch_grad(grad_acc, points, projections, valid_hw,
                           hf: int, wf: int):
    """Gradient of the sums with respect to the features: each feature row
    gets the sum of the ``grad_acc`` rows of the voxels that read it.

    A pixel-major gather with no floating-point atomics (``csrc/
    backproject.cu``: count, scan, fill and sum passes after one memset):
    each output row is summed in float32 from zero in ascending voxel order,
    the order in which ``ops/backproject.py:backproject_batch_grad_plain``
    adds on the CPU, and rounded once to the output's type, so the result
    equals the plain version's bit for bit and repeats from call to call.

    Args:
      grad_acc: ``(P, B, C)`` float32 or bfloat16, C even.
      points, projections, valid_hw: as for :func:`backproject_batch`.
      hf, wf: the feature map's height and width.

    Returns:
      ``(B, V, hf, wf, C)`` in ``grad_acc``'s dtype.
    """
    global grad_launches
    require(grad_acc, 'grad_acc', (torch.float32, torch.bfloat16), 3)
    require(points, 'points', (torch.float32,), 3)
    require(projections, 'projections', (torch.float32,), 4)
    require(valid_hw, 'valid_hw', (torch.int32,), 2)
    same_device(grad_acc, points, projections, valid_hw)
    p, b, c = grad_acc.shape
    v = projections.shape[1]
    if c % 2 or c < 2:
        raise ValueError(f'channel count must be even and positive, got {c}')
    if (points.shape != (b, p, 3) or projections.shape != (b, v, 3, 4)
            or valid_hw.shape != (b, 2) or hf < 1 or wf < 1):
        raise ValueError('shape mismatch: grad_acc '
                         f'{tuple(grad_acc.shape)}, points '
                         f'{tuple(points.shape)}, projections '
                         f'{tuple(projections.shape)}, valid_hw '
                         f'{tuple(valid_hw.shape)}, feature map {(hf, wf)}')
    if b * v * p >= 2 ** 31 or b * v * hf * wf >= 2 ** 31 - 1:
        raise ValueError(f'too many rows for 32-bit segment indices: '
                         f'B*V*P = {b * v * p}, B*V*Hf*Wf = {b * v * hf * wf}')
    dev = grad_acc.device
    n_scratch = build.kernel('backproject', 'imvx_backproject_grad_scratch')(
        b, v, hf, wf, p)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    out = torch.empty((b, v, hf, wf, c), dtype=grad_acc.dtype, device=dev)
    err = build.kernel('backproject', 'imvx_backproject_grad')(
        grad_acc.data_ptr(), int(grad_acc.dtype == torch.bfloat16),
        points.data_ptr(), projections.data_ptr(), valid_hw.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, v, hf, wf, c, p,
        stream_of(grad_acc))
    build.check(err, 'backproject_grad')
    grad_launches += 1
    return out
