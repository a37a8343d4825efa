"""Convolutions that compute in their input's dtype, and the 3D necks' batch
norm .

Parameters stay float32; the forward casts them to the dtype of the input
(bfloat16 when the model's ``compute_dtype`` is ``'bfloat16'``), as the JAX
package's ``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
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
    """``nn.BatchNorm3d`` (torch eps and momentum) returning its input's
    dtype, whose running variance follows flax ``nn.BatchNorm``, the JAX
    package's rule: in training it moves toward the biased batch variance,
    where torch would take the unbiased one.

    Torch's update is ``rv = (1 - m) * rv_old + m * var * N / (N - 1)`` with
    ``N`` values per channel; subtracting ``(rv - (1 - m) * rv_old) / N``
    leaves ``(1 - m) * rv_old + m * var``.  All on the device, no host read.
    Torch updates a copy of the buffer, which autograd may keep; the buffer
    takes the result.
    """

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x).to(x.dtype)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                           True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            old = self.running_var
            old.copy_(var - (var - (1.0 - self.momentum) * old) / n)
        return out.to(x.dtype)

