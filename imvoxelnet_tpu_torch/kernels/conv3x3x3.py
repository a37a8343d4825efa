"""Wrapper of the 3x3x3 64->64 conv kernel (``csrc/conv3x3x3.cu``).

Replaces ``imvoxelnet_tpu/ops/conv3z_pallas.py:conv3z_lanepack``.  The plain
version is ``ops/conv3z.py:conv3x3x3_plain`` (``F.conv3d``).
"""

from __future__ import annotations

import torch

from . import build
from ._checks import require, same_device, stream_of

launches = 0
CHANNELS = 64


def conv3x3x3(x, kernel):
    """3x3x3 SAME stride-1 conv, ``(B, nx, ny, nz, 64) x (3, 3, 3, 64, 64)``.

    Both in channels-last (NDHWC / DHWIO) layout, both float32 or both
    bfloat16; accumulates in float32 and returns ``x.dtype``.
    """
    global launches
    require(x, 'x', (torch.float32, torch.bfloat16), 5)
    require(kernel, 'kernel', (x.dtype,), 5)
    same_device(x, kernel)
    b, nx, ny, nz, cin = x.shape
    if cin != CHANNELS or kernel.shape != (3, 3, 3, CHANNELS, CHANNELS):
        raise ValueError(f'kernel takes 64 -> 64 channels, got x '
                         f'{tuple(x.shape)} and kernel {tuple(kernel.shape)}')
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = build.kernel('conv3x3x3')(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), b, nx, ny, nz, stream_of(x))
    build.check(err, 'conv3x3x3')
    launches += 1
    return out
