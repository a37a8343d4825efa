"""The KITTI 3D neck, NCDHW (volume ``(B, C, nx, ny, nz)``).

Counterpart of ``imvoxelnet_tpu/models/necks3d.py`` (``BN``, ``Conv3x3x3``,
``ConvBnRelu3d``, ``BasicBlock3d``, ``KittiImVoxelNeck``), with the
reference's parameter names (``neck_3d.model.{i}...``).  The volume is kept
in ``channels_last_3d`` memory, the layout the 3x3x3 kernel reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3z import conv3x3x3
from .layers import BatchNorm3d, Conv3d

# The plane size from which the 64-channel block0 convs take the 3x3x3
# kernel (the JAX gate's ``_CONV3Z_MIN_PLANE``, necks3d.py:96-100).
CONV3Z_MIN_PLANE = 16384


class Conv3x3x3(nn.Module):
    """Bias-free 3x3x3 conv (``weight (Cout, Cin, 3, 3, 3)``).

    Stride-1 SAME 64 -> 64 convs on shallow-z volumes with a large plane
    (6 <= nz <= 16, nx*ny >= ``CONV3Z_MIN_PLANE``) go through
    :func:`ops.conv3z.conv3x3x3`, the port of the JAX package's lane-packed
    Pallas conv; every other shape is ``F.conv3d``.
    """

    def __init__(self, cin: int, cout: int, stride=1, padding=1):
        super().__init__()
        self.stride = (stride,) * 3 if isinstance(stride, int) else stride
        self.padding = (padding,) * 3 if isinstance(padding, int) else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def takes_kernel(self, x) -> bool:
        _, cin, nx, ny, nz = x.shape
        return (self.stride == (1, 1, 1) and self.padding == (1, 1, 1)
                and cin == 64 and self.weight.shape[0] == 64
                and 6 <= nz <= 16 and nx * ny >= CONV3Z_MIN_PLANE)

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.takes_kernel(x):
            y = conv3x3x3(x.permute(0, 2, 3, 4, 1),
                          w.permute(2, 3, 4, 1, 0))
            return y.permute(0, 4, 1, 2, 3)
        return F.conv3d(x, w, stride=self.stride, padding=self.padding)


class BasicBlock3d(nn.Module):
    """Residual 3x3x3 block (``necks/imvoxelnet.py:191-230``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv3x3x3(c, c)
        self.bn1 = BatchNorm3d(c)
        self.conv2 = Conv3x3x3(c, c)
        self.bn2 = BatchNorm3d(c)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + x)


def conv_bn_relu3d(cin, cout, stride, padding):
    """``Sequential(conv, bn, relu)`` -> names ``{i}.0.*`` and ``{i}.1.*``."""
    return nn.Sequential(Conv3d(cin, cout, 3, stride=stride, padding=padding),
                         BatchNorm3d(cout), nn.ReLU(inplace=True))


class KittiImVoxelNeck(nn.Module):
    """Outdoor z-collapsing neck (``necks/imvoxelnet.py:94-123``).

    Input ``(B, C, nx, ny, nz)`` with nz = 12; three stride-(1,1,2) stages
    and a padding-0 conv collapse z to 1.  Output is the BEV map
    ``(B, C_out, ny-2, nx-2)`` (``x[..., 0].transpose(-1, -2)``).
    """

    def __init__(self, in_channels: int = 64, out_channels: int = 256):
        super().__init__()
        c = in_channels
        self.model = nn.Sequential(
            BasicBlock3d(c),
            conv_bn_relu3d(c, c * 2, (1, 1, 2), 1),
            BasicBlock3d(c * 2),
            conv_bn_relu3d(c * 2, c * 4, (1, 1, 2), 1),
            BasicBlock3d(c * 4),
            conv_bn_relu3d(c * 4, out_channels, 1, 0))

    def forward(self, x):
        x = self.model(x.contiguous(memory_format=torch.channels_last_3d))
        if x.shape[-1] != 1:
            raise ValueError(f'z must collapse to 1, got {tuple(x.shape)}')
        return x[..., 0].transpose(-1, -2)
