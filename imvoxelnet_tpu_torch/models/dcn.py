"""Modulated deformable convolution (DCNv2), plain PyTorch, channels last.

Counterpart of ``imvoxelnet_tpu/models/dcn.py`` (``bilinear_sample``,
``DeformConv2d``): the nuScenes backbone's conv2 in ResNet stages 3-4
(``configs/imvoxelnet/imvoxelnet_nuscenes.py:13-14``).  A regular 3x3 conv
(``conv_offset``, float32) predicts per output position 9 offsets
``(dy_k, dx_k)`` and 9 modulation masks; each tap is sampled bilinearly at
``base grid + tap + offset`` as four row gathers of the ``(B*H*W, C)``
channels-last map, modulated, and the ``(B, oh, ow, 9*C)`` sampled columns
contract with the kernel as one matmul.  The JAX package's default
formulation (row gathers), with its rounding: coordinates and bilinear
weights in float32, gathered values, their weighted sum and the mask product
in the compute dtype.  It was plain XLA in the JAX package, and is plain
PyTorch here; the gathers' backward is an accumulating ``index_put_``.

Module names follow mmcv's ``ModulatedDeformConv2dPack``: ``weight (F, C, 3,
3)`` without a bias, and ``conv_offset``, a ``Conv2d`` of 27 channels with a
bias.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.tracing import span
from .layers import Conv2d


def taps(device=None):
    """The base grid's float32 offsets ``(dy, dx)`` of the 9 taps in
    tap-major ``(ky, kx)`` order, each in {-1, 0, 1}; made on ``device``
    (no copy from the host)."""
    k = torch.arange(3, dtype=torch.float32, device=device) - 1
    return k.repeat_interleave(3), k.repeat(3)


def bilinear_sample(feat, x, y):
    """Sample ``feat (B, H, W, C)`` at float32 coordinates ``x, y (B,
    ...)``, zero outside the map; returns ``(B, ..., C)`` in ``feat``'s dtype.

    The four corners are gathered as rows of the flattened map at clipped
    indices; each corner is zeroed on its own when it falls outside, weighted
    by its float32 bilinear weight cast to ``feat``'s dtype, and the terms
    are added in the order c00 + c01 + c10 + c11 (``models/dcn.py:61-97``
    of the JAX package, ``window=False``).
    """
    b, h, w, c = feat.shape
    rows = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w)).reshape(
        (b,) + (1,) * (x.dim() - 1))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    corners = ((y0, x0, (1 - dx) * (1 - dy)),
               (y0, x0 + 1, dx * (1 - dy)),
               (y0 + 1, x0, (1 - dx) * dy),
               (y0 + 1, x0 + 1, dx * dy))
    out = None
    for yi, xi, wgt in corners:
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        vals = rows[base + yi_c * w + xi_c]
        term = (torch.where(inside[..., None], vals, 0)
                * wgt[..., None].to(feat.dtype))
        out = term if out is None else out + term
    return out


class DeformConv2d(nn.Module):
    """3x3 modulated deformable conv, stride 1 or 2, padding 1, no bias.

    ``x (B, C, H, W)`` in the compute dtype (channels-last memory, as the
    backbone keeps it) -> ``(B, F, oh, ow)``, a view of channels-last
    memory.
    """

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)
        self.conv_offset = Conv2d(cin, 27, 3, stride=stride, padding=1,
                                  bias=True)

    def offsets_and_masks(self, x):
        """``conv_offset`` in float32 on the float32 input: the ``(B, oh,
        ow, 9, 2)`` offsets as ``(dy, dx)`` per tap and the ``(B, oh, ow,
        9)`` sigmoid masks."""
        om = self.conv_offset(x.float()).permute(0, 2, 3, 1)
        b, oh, ow, _ = om.shape
        return om[..., :18].reshape(b, oh, ow, 9, 2), torch.sigmoid(
            om[..., 18:])

    @span('dcn')
    def forward(self, x):
        b, c, _, _ = x.shape
        offset, mask = self.offsets_and_masks(x)
        oh, ow = offset.shape[1:3]
        dev = x.device
        ys = torch.arange(oh, dtype=torch.float32, device=dev) * self.stride
        xs = torch.arange(ow, dtype=torch.float32, device=dev) * self.stride
        taps_dy, taps_dx = taps(dev)
        sy = (ys[:, None, None] + taps_dy) + offset[..., 0]    # (B, oh, ow, 9)
        sx = (xs[None, :, None] + taps_dx) + offset[..., 1]
        vals = bilinear_sample(x.permute(0, 2, 3, 1), sx, sy)
        sampled = (vals * mask[..., None].to(x.dtype)).reshape(
            b, oh, ow, 9 * c)
        kernel = self.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(
            self.weight.shape[0], 9 * c)
        return (sampled @ kernel.t()).permute(0, 3, 1, 2)
