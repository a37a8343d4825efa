"""ResNet backbone with frozen batch norm, NCHW.

Counterpart of ``imvoxelnet_tpu/models/resnet.py``: mmdet's torchvision-style
ResNet-50 (``frozen_stages=1``, BN with ``requires_grad=False`` and
``norm_eval=True``), so every batch norm is an affine map from fixed
statistics.  Parameter names are the reference's
(``backbone.layer1.0.conv1.weight``,
``backbone.layer1.0.downsample.1.running_mean``, ...).
The deformable stages of the nuScenes backbone are left out: no cell of
the benchmark runs them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FrozenBatchNorm(nn.Module):
    """Inference-mode batch norm; its four tensors carry the BN names."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        root = torch.sqrt(self.running_var + self.eps)
        inv = (self.weight / root).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight / root).to(
            x.dtype)
        return x * inv[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, bias=False),
                FrozenBatchNorm(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-50/101 with bottleneck blocks; returns the 4 stage outputs."""

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 base_planes: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, base_planes, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = FrozenBatchNorm(base_planes)
        cin, planes = base_planes, base_planes
        for stage, n_blocks in enumerate(stage_blocks):
            stride = 1 if stage == 0 else 2
            blocks = []
            for block in range(n_blocks):
                blocks.append(Bottleneck(cin, planes,
                                         stride if block == 0 else 1,
                                         downsample=(block == 0)))
                cin = planes * Bottleneck.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*blocks))
            planes *= 2
        self.n_stages = len(stage_blocks)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in range(self.n_stages):
            x = getattr(self, f'layer{stage + 1}')(x)
            outs.append(x)
        return outs
