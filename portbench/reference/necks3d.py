"""The 3D necks, NCDHW (volume ``(B, C, nx, ny, nz)``).

Counterpart of ``imvoxelnet_tpu/models/necks3d.py`` (``BN``, ``Conv3x3x3``,
``ConvBnRelu3d``, ``BasicBlock3d``, ``KittiImVoxelNeck``, ``ImVoxelNeck``),
with the reference's parameter names (``neck_3d.model.{i}...`` for KITTI,
``neck_3d.model.layers_down...`` and ``neck_3d.conv_blocks.{i}`` for the
encoder-decoder).  Volumes are kept in ``channels_last_3d`` memory, as in
the port.  Every batch norm is :class:`layers.BatchNorm3d` (flax's running
variance rule).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm3d, Conv3d


class Conv3x3x3(nn.Module):
    """Bias-free 3x3x3 conv (``weight (Cout, Cin, 3, 3, 3)``), always
    ``F.conv3d``: the program takes a hand-written kernel for some shapes,
    the reference none."""

    def __init__(self, cin: int, cout: int, stride=1, padding=1):
        super().__init__()
        self.stride = (stride,) * 3 if isinstance(stride, int) else stride
        self.padding = (padding,) * 3 if isinstance(padding, int) else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, 3))

    def forward(self, x):
        return F.conv3d(x, self.weight.to(x.dtype), stride=self.stride,
                        padding=self.padding)


class BasicBlock3d(nn.Module):
    """Residual 3x3x3 block (``necks/imvoxelnet.py:191-230``).

    ``zero_init_bn2``: ``init_weights`` zeroes ``bn2``'s scale, as the
    encoder-decoder's reference init does (``necks/imvoxelnet.py:340-343``).
    """

    def __init__(self, c: int, zero_init_bn2: bool = False):
        super().__init__()
        self.zero_init_bn2 = zero_init_bn2
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


def trilinear_up2(x):
    """Trilinear x2 upsampling of ``(B, C, nx, ny, nz)``, half-pixel
    centres (the JAX package's ``_trilinear_up2``)."""
    return F.interpolate(x, scale_factor=2, mode='trilinear',
                         align_corners=False)


class _Proj(nn.Module):
    """The encoder-decoder's skip projection: 1x1x1 conv, BN, ReLU
    (``proj.{i}.conv`` / ``proj.{i}.norm``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv3d(c, c, 1, bias=False)
        self.norm = BatchNorm3d(c)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class _EncoderDecoder(nn.Module):
    """Atlas-style encoder-decoder (``neck_3d.model``, conditional=False).

    ``layers_down.{0}`` holds level 0's blocks; ``layers_down.{i > 0}`` a
    stride-2 conv at 0, its BN at 1, an identity at 2 (the reference's
    dropout, inactive in the shipped configs and absent from the JAX
    package), a ReLU at 3 and the blocks from 4.  ``layers_up_conv.{i}``
    (1x1x1), ``proj.{i}`` and ``layers_up_res.{i}`` work on the decoder's
    ``i``-th step, coarse to fine.
    """

    def __init__(self, channels, down_layers, up_layers):
        super().__init__()
        chans = list(channels)
        self.layers_down = nn.ModuleList()
        for i, ch in enumerate(chans):
            layer = []
            if i > 0:
                layer += [Conv3d(chans[i - 1], ch, 3, stride=2, padding=1,
                                 bias=False),
                          BatchNorm3d(ch), nn.Identity(), nn.ReLU()]
            layer += [BasicBlock3d(ch, zero_init_bn2=True)
                      for _ in range(down_layers[i])]
            self.layers_down.append(nn.Sequential(*layer))
        rev = chans[::-1]
        self.layers_up_conv = nn.ModuleList(
            Conv3d(rev[i], rev[i + 1], 1, bias=False)
            for i in range(len(rev) - 1))
        self.proj = nn.ModuleList(_Proj(rev[i + 1])
                                  for i in range(len(rev) - 1))
        self.layers_up_res = nn.ModuleList(
            nn.Sequential(*[BasicBlock3d(rev[i + 1], zero_init_bn2=True)
                            for _ in range(up_layers[i])])
            for i in range(len(rev) - 1))

    def forward(self, x):
        """Returns the decoder's outputs coarse to fine."""
        skips = []
        for layer in self.layers_down:
            x = layer(x)
            skips.append(x)
        skips = skips[::-1]
        outs = []
        for i, up_conv in enumerate(self.layers_up_conv):
            x = up_conv(trilinear_up2(x))
            x = (x + self.proj[i](skips[i + 1])) / 2.0
            x = self.layers_up_res[i](x)
            outs.append(x)
        return outs


class ImVoxelNeck(nn.Module):
    """Indoor encoder-decoder neck with a conv-bn-relu per output scale
    (``necks/imvoxelnet.py:70-91``).

    Input ``(B, C0, nx, ny, nz)`` with ``C0 = channels[0]``; returns 3 scales
    finest first, ``[(B, out, nx, ny, nz), /2, /4]``.  The reference also
    builds a ``conv_blocks`` entry for the coarsest encoder level, which its
    forward never reads; the port, like the JAX package, has none (a
    released checkpoint's ``conv_blocks.3`` is dropped on conversion).
    """

    def __init__(self, channels=(64, 128, 256, 512), out_channels: int = 64,
                 down_layers=(1, 2, 3, 4), up_layers=(3, 2, 1)):
        super().__init__()
        self.model = _EncoderDecoder(channels, down_layers, up_layers)
        self.conv_blocks = nn.ModuleList(
            conv_bn_relu3d(c, out_channels, 1, 1) for c in channels[:-1])

    def forward(self, x):
        outs = self.model(x.contiguous(memory_format=torch.channels_last_3d))
        return [block(o) for block, o in zip(self.conv_blocks, outs[::-1])]

