"""3x3x3 SAME stride-1 convolution of the KITTI neck's 64-channel block0.

Counterpart of ``imvoxelnet_tpu/ops/conv3z_pallas.py`` (``conv3z_lanepack``),
with its layouts: ``x (B, nx, ny, nz, Cin)`` and ``kernel (3, 3, 3, Cin,
Cout)``.  ``conv3x3x3`` runs the CUDA kernel (``kernels/conv3x3x3.py``) on
CUDA tensors and ``conv3x3x3_plain`` (``F.conv3d``) on CPU tensors.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..kernels import conv3x3x3 as conv_kernel


def conv3x3x3_plain(x, kernel):
    """``F.conv3d`` on channels-last operands, returning channels-last."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


def conv3x3x3(x, kernel):
    """3x3x3 SAME stride-1 conv with float32 accumulation; ``x`` and
    ``kernel`` share a dtype.  The CUDA path (tensor cores, both dtypes)
    takes 64 -> 64 channels only."""
    if x.is_cuda:
        return conv_kernel.conv3x3x3(x.contiguous(), kernel.contiguous())
    return conv3x3x3_plain(x, kernel)
