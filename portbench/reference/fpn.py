"""Feature Pyramid Network (mmdet-compatible), NCHW.

Counterpart of ``imvoxelnet_tpu/models/fpn.py``: 4 lateral 1x1 convs,
top-down nearest upsampling with add, 4 output 3x3 convs, no norm.  Only the
stride-4 output is consumed by the detector, but every level's parameters
exist so reference checkpoints load (``neck.lateral_convs.{i}.conv``,
``neck.fpn_convs.{i}.conv``).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d


def upsample_nearest(x, out_hw):
    """Nearest upsample of ``(N, C, h, w)`` to ``out_hw``: ``out[i, j] =
    x[i * h // oh, j * w // ow]``, as torch ``interpolate`` for the sizes
    here; an exact 2x is a broadcast that writes the output once."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    if oh == 2 * h and ow == 2 * w:
        y = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
        return y.reshape(n, c, oh, ow)
    rows = (torch.arange(oh, device=x.device) * h) // oh
    cols = (torch.arange(ow, device=x.device) * w) // ow
    return x[:, :, rows][:, :, :, cols]


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` without norm/act: just ``.conv``."""

    def __init__(self, cin, cout, k, padding=0):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=padding)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels=64):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [_ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [_ConvModule(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[2:])
        return [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
