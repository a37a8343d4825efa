"""The 3D necks, NCDHW (volume ``(B, C, nx, ny, nz)``).

Counterpart of ``imvoxelnet_tpu/models/necks3d.py`` (``BN``, ``Conv3x3x3``,
``ConvBnRelu3d``, ``BasicBlock3d``, ``BasicBlock3dV2``, ``KittiImVoxelNeck``,
``NuScenesImVoxelNeck``, ``ImVoxelNeck``, ``FastIndoorImVoxelNeck``), with
the reference's parameter names (``neck_3d.model.{i}...`` for KITTI and
nuScenes, ``neck_3d.model.layers_down...``
and ``neck_3d.conv_blocks.{i}`` for the encoder-decoder, ``neck_3d.
down_layer_{i}`` / ``up_block_{i}`` / ``out_block_{i}`` for the fast neck).
Volumes are kept in ``channels_last_3d`` memory, the layout the 3x3x3 kernel
reads.  Every batch norm is :class:`layers.BatchNorm3d` (flax's running
variance rule).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv3z import conv3x3x3
from .layers import BatchNorm3d, Conv3d, ConvTranspose3d

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


class BasicBlock3dV2(nn.Module):
    """The fast neck's residual block, with a strided 1x1x1 conv + BN on the
    identity path when ``stride != 1`` (``necks/imvoxelnet.py:233-260``)."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3x3x3(cin, cout, stride=stride)
        self.norm1 = BatchNorm3d(cout)
        self.conv2 = Conv3x3x3(cout, cout)
        self.norm2 = BatchNorm3d(cout)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                Conv3d(cin, cout, 1, stride=stride, bias=False),
                BatchNorm3d(cout))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        return F.relu(out + identity)


def conv_bn_relu3d(cin, cout, stride, padding):
    """``Sequential(conv, bn, relu)`` -> names ``{i}.0.*`` and ``{i}.1.*``."""
    return nn.Sequential(Conv3d(cin, cout, 3, stride=stride, padding=padding),
                         BatchNorm3d(cout), nn.ReLU(inplace=True))


class KittiImVoxelNeck(nn.Module):
    """Outdoor z-collapsing neck (``necks/imvoxelnet.py:94-123``).

    Input ``(B, C, nx, ny, nz)`` with nz = 12; three stride-(1,1,2) stages
    and a padding-0 conv collapse z to 1.  Output is the BEV map
    ``(B, C_out, ny-2, nx-2)`` (``x[..., 0].transpose(-1, -2)``).
    ``down0_stride`` and ``out_padding`` are the first strided conv's
    stride and the last conv's padding (nuScenes: 2 and (1, 1, 0)).
    """

    def __init__(self, in_channels: int = 64, out_channels: int = 256,
                 down0_stride=(1, 1, 2), out_padding=0):
        super().__init__()
        c = in_channels
        self.model = nn.Sequential(
            BasicBlock3d(c),
            conv_bn_relu3d(c, c * 2, down0_stride, 1),
            BasicBlock3d(c * 2),
            conv_bn_relu3d(c * 2, c * 4, (1, 1, 2), 1),
            BasicBlock3d(c * 4),
            conv_bn_relu3d(c * 4, out_channels, 1, out_padding))

    def forward(self, x):
        x = self.model(x.contiguous(memory_format=torch.channels_last_3d))
        if x.shape[-1] != 1:
            raise ValueError(f'z must collapse to 1, got {tuple(x.shape)}')
        return x[..., 0].transpose(-1, -2)


class NuScenesImVoxelNeck(KittiImVoxelNeck):
    """The KITTI neck with its first strided conv at stride 2 in every axis
    and its last conv padded in x and y (``necks/imvoxelnet.py:126-154``):
    z collapses 12 -> 6 -> 3 -> 1 and the BEV map is ``(B, C_out, ny/2,
    nx/2)``."""

    def __init__(self, in_channels: int = 64, out_channels: int = 256):
        super().__init__(in_channels, out_channels, down0_stride=2,
                         out_padding=(1, 1, 0))


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


class FastIndoorImVoxelNeck(nn.Module):
    """The v3 simplified indoor neck (``necks/imvoxelnet.py:9-67``).

    ``down_layer_{i}``: level ``i``'s blocks, the first of levels ``i > 0``
    with stride 2 and twice the channels; ``up_block_{i}``: a stride-2
    ``ConvTranspose3d(2)`` to level ``i - 1``'s channels, BN, ReLU, a 3x3x3
    conv, BN, ReLU, added to level ``i - 1``; ``out_block_{i}``: 3x3x3 conv
    to ``out_channels``, BN, ReLU.  Returns the scales finest first.
    """

    def __init__(self, in_channels: int = 256, n_blocks=(1, 1, 1),
                 out_channels: int = 128):
        super().__init__()
        self.n_scales = len(n_blocks)
        chans, ch = [], in_channels
        for i, n in enumerate(n_blocks):
            blocks = []
            for j in range(n):
                if i > 0 and j == 0:
                    blocks.append(BasicBlock3dV2(ch, ch * 2, stride=2))
                    ch *= 2
                else:
                    blocks.append(BasicBlock3dV2(ch, ch))
            self.add_module(f'down_layer_{i}', nn.Sequential(*blocks))
            chans.append(ch)
        for i in range(1, self.n_scales):
            c = chans[i - 1]
            self.add_module(f'up_block_{i}', nn.Sequential(
                ConvTranspose3d(chans[i], c, 2, stride=2, bias=False),
                BatchNorm3d(c), nn.ReLU(inplace=True),
                Conv3x3x3(c, c), BatchNorm3d(c), nn.ReLU(inplace=True)))
        for i in range(self.n_scales):
            self.add_module(f'out_block_{i}', nn.Sequential(
                Conv3x3x3(chans[i], out_channels), BatchNorm3d(out_channels),
                nn.ReLU(inplace=True)))

    def forward(self, x):
        x = x.contiguous(memory_format=torch.channels_last_3d)
        downs = []
        for i in range(self.n_scales):
            x = getattr(self, f'down_layer_{i}')(x)
            downs.append(x)
        outs = []
        for i in range(self.n_scales - 1, -1, -1):
            if i < self.n_scales - 1:
                x = downs[i] + getattr(self, f'up_block_{i + 1}')(x)
            outs.append(getattr(self, f'out_block_{i}')(x))
        return outs[::-1]
