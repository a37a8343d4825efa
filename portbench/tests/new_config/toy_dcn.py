"""A reference module that a new configuration brings as a file of its
own (``reference/toy_dcn.py`` in the test's copy of the benchmark): the
default detector whose backbone takes a modulated deformable conv (DCNv2)
as conv2 of every bottleneck of the stages ``stage_with_dcn`` names, as
the nuScenes backbone does (stages 3-4).  Plain PyTorch, a copy of the
port's plain DCN (``models/dcn.py``) with mmcv's module names
(``conv2.weight``, ``conv2.conv_offset.{weight,bias}``); its weight is
no module of the generic weights' scheme, so ``init_overrides`` gives it,
and zeroes ``conv_offset`` as mmcv's init does."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from . import detector
from .detector import (imvoxelnet_predict, make_optimizer,  # noqa: F401
                       make_train_step, param_label)
from .layers import Conv2d


def bilinear_sample(feat, x, y):
    """Sample ``feat (B, H, W, C)`` at float32 coordinates ``x, y (B,
    ...)``, zero outside the map, in ``feat``'s dtype: four corner rows
    gathered, each weighted by its float32 weight cast to that dtype."""
    b, h, w, c = feat.shape
    rows = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w)).reshape(
        (b,) + (1,) * (x.dim() - 1))
    x0, y0 = torch.floor(x), torch.floor(y)
    dx, dy = x - x0, y - y0
    out = None
    for yi, xi, wgt in ((y0, x0, (1 - dx) * (1 - dy)),
                        (y0, x0 + 1, dx * (1 - dy)),
                        (y0 + 1, x0, (1 - dx) * dy),
                        (y0 + 1, x0 + 1, dx * dy)):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = rows[base + yi.clamp(0, h - 1).long() * w
                    + xi.clamp(0, w - 1).long()]
        term = (torch.where(inside[..., None], vals, 0)
                * wgt[..., None].to(feat.dtype))
        out = term if out is None else out + term
    return out


class DeformConv2d(nn.Module):
    """3x3 modulated deformable conv, padding 1, no bias."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.conv_offset = Conv2d(cin, 27, 3, stride=stride, padding=1,
                                  bias=True)

    def forward(self, x):
        b, c, _, _ = x.shape
        om = self.conv_offset(x.float()).permute(0, 2, 3, 1)
        _, oh, ow, _ = om.shape
        offset = om[..., :18].reshape(b, oh, ow, 9, 2)
        mask = torch.sigmoid(om[..., 18:])
        k = torch.arange(3, dtype=torch.float32, device=x.device) - 1
        ys = torch.arange(oh, dtype=torch.float32,
                          device=x.device) * self.stride
        xs = torch.arange(ow, dtype=torch.float32,
                          device=x.device) * self.stride
        sy = (ys[:, None, None] + k.repeat_interleave(3)) + offset[..., 0]
        sx = (xs[None, :, None] + k.repeat(3)) + offset[..., 1]
        vals = bilinear_sample(x.permute(0, 2, 3, 1), sx, sy)
        sampled = (vals * mask[..., None].to(x.dtype)).reshape(
            b, oh, ow, 9 * c)
        kernel = self.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(
            self.weight.shape[0], 9 * c)
        return (sampled @ kernel.t()).permute(0, 3, 1, 2)


@dataclasses.dataclass(frozen=True)
class ImVoxelNetConfig(detector.ImVoxelNetConfig):
    stage_with_dcn: Tuple[bool, ...] = (False,) * 4


def config_from_dict(d: dict) -> ImVoxelNetConfig:
    """The default reference's config of ``d``, with its deformable
    stages."""
    base = detector.config_from_dict(dict(d, stage_with_dcn=[False] * 4))
    return ImVoxelNetConfig(
        **{f.name: getattr(base, f.name)
           for f in dataclasses.fields(detector.ImVoxelNetConfig)},
        stage_with_dcn=tuple(d['stage_with_dcn']))


class ImVoxelNet(detector.ImVoxelNet):
    def __init__(self, cfg: ImVoxelNetConfig):
        super().__init__(cfg)
        for stage, deformable in enumerate(cfg.stage_with_dcn):
            if deformable:
                for block in getattr(self.backbone, f'layer{stage + 1}'):
                    conv = block.conv2
                    block.conv2 = DeformConv2d(conv.in_channels,
                                               conv.out_channels,
                                               conv.stride[0])


def init_overrides(model: ImVoxelNet, serve: bool) -> dict:
    plan = detector.init_overrides(model, serve)
    for name, mod in model.named_modules():
        if isinstance(mod, DeformConv2d):
            plan[name + '.weight'] = ('normal',
                                      mod.weight[0].numel() ** -0.5)
            plan[name + '.conv_offset.weight'] = ('fill', 0.0)
            plan[name + '.conv_offset.bias'] = ('fill', 0.0)
    return plan
