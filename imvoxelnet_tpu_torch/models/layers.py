"""Convolutions that compute in their input's dtype, and the 3D necks' batch
norm (global statistics under a process group of several ranks).

Parameters stay float32; the forward casts them to the dtype of the input
(bfloat16 when the model's ``compute_dtype`` is ``'bfloat16'``), as the JAX
package's ``nn.Conv(dtype=...)`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


class Conv2d(nn.Conv2d):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` without output padding, computing in the
    input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose3d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


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

    In training under a process group of W > 1 ranks the statistics are
    those of the global batch, as the JAX package's GSPMD program computes
    them (``parallel/mesh.py``): see :meth:`_global_forward`.
    """

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x).to(x.dtype)
        if mesh.world_size() > 1:
            return self._global_forward(x)
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

    def _global_forward(self, x):
        """Training over W ranks: in float32 (or the input's wider dtype),
        the per-channel sum and count of the rank's values are summed over
        the ranks, then the sum of squares about the global mean (two
        passes, as torch's own batch norm takes the variance about the
        mean: ``E[x^2] - mean^2`` in one pass would cancel where the
        variance is small against the squared mean); every rank normalises
        with the global mean and biased variance.  Both sums go through
        autograd (the backward sums their gradients over the ranks).
        ``running_mean`` and ``running_var`` move by flax's rule toward the
        global mean and biased variance (``N`` the global count);
        ``nn.SyncBatchNorm`` would take the unbiased variance."""
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        c = x.shape[1]
        view = (1, c) + (1,) * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype,
                           device=x.device)
        sums = mesh.all_reduce_sum(torch.cat([xf.sum(dims), count]))
        n = sums[c]
        mean = sums[:c] / n
        d = xf - mean.view(view)
        var = mesh.all_reduce_sum((d * d).sum(dims)) / n
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = d * scale.view(view) + self.bias.view(view)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        return out.to(x.dtype)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv init: normal with variance ``1 / fan_in``."""
    fan_in = weight[0].numel()
    with torch.no_grad():
        weight.normal_(0.0, fan_in ** -0.5, generator=generator)
