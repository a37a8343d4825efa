"""Convolutions that compute in their input's dtype.

Parameters stay float32; the forward casts them to the dtype of the input
(bfloat16 when the model's ``compute_dtype`` is ``'bfloat16'``), as the JAX
package's ``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

import torch
from torch import nn


class Conv2d(nn.Conv2d):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` (torch eps and momentum) returning its input's dtype."""

    def forward(self, x):
        return super().forward(x).to(x.dtype)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv init: normal with variance ``1 / fan_in``."""
    fan_in = weight[0].numel()
    with torch.no_grad():
        weight.normal_(0.0, fan_in ** -0.5, generator=generator)
