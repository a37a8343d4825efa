"""3x3x3 SAME stride-1 convolution of the KITTI neck's 64-channel block0.

Counterpart of ``imvoxelnet_tpu/ops/conv3z_pallas.py`` (``conv3z_lanepack``),
with its layouts: ``x (B, nx, ny, nz, Cin)`` and ``kernel (3, 3, 3, Cin,
Cout)``.  ``conv3x3x3`` runs the CUDA kernel (``kernels/conv3x3x3.py``) on
CUDA tensors and ``conv3x3x3_plain`` (``F.conv3d``) on CPU tensors.

The gradient follows the JAX ``custom_vjp`` (``conv3z_pallas.py:145-149``):
``dx`` is the transpose of the conv, which for a stride-1 pad-1 3x3x3 conv
is the same conv with the kernel flipped in space and its channel axes
swapped, so on the card it runs through the kernel itself; ``dk`` is the
weight gradient of the reference conv (the JAX package leaves it to XLA, the
port to ``aten.convolution_backward``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import conv3x3x3 as conv_kernel


def conv3x3x3_plain(x, kernel):
    """``F.conv3d`` on channels-last operands, returning channels-last."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


def transpose_kernel(kernel):
    """The kernel of the conv's transpose: flipped in space, ``Cin`` and
    ``Cout`` swapped, ``(3, 3, 3, Cout, Cin)`` contiguous."""
    return kernel.flip(0, 1, 2).transpose(3, 4).contiguous()


def kernel_grad(x, g, kernel):
    """``dk`` of the conv for output gradient ``g``, both ``(B, nx, ny, nz,
    C)``; returns ``(3, 3, 3, Cin, Cout)`` in ``x``'s dtype."""
    _, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
        kernel.permute(4, 3, 0, 1, 2), None, [1, 1, 1], [1, 1, 1],
        [1, 1, 1], False, [0, 0, 0], 1, [False, True, False])
    return dw.permute(2, 3, 4, 1, 0)


class Conv3x3x3Function(torch.autograd.Function):
    """B3 with its gradient: ``apply(x, kernel, plain=False)``.

    Forward and ``dx`` run the kernel (``plain=True``: ``conv3x3x3_plain``);
    ``dk`` is :func:`kernel_grad`.  The incoming gradient is cast to ``x``'s
    dtype (as ``_bwd`` does) and made contiguous in NDHWC: it is the gradient
    of a permute of a ``channels_last_3d`` tensor.
    """

    @staticmethod
    def forward(ctx, x, kernel, plain=False):
        ctx.save_for_backward(x, kernel)
        ctx.conv = conv3x3x3_plain if plain else conv_kernel.conv3x3x3
        return ctx.conv(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = ctx.conv(g, transpose_kernel(kernel))
        if ctx.needs_input_grad[1]:
            dk = kernel_grad(x, g, kernel)
        return dx, dk, None


def conv3x3x3(x, kernel):
    """3x3x3 SAME stride-1 conv with float32 accumulation; ``x`` and
    ``kernel`` share a dtype.  The CUDA path (tensor cores, both dtypes)
    takes 64 -> 64 channels only: where no gradient is needed as the
    operator ``torch.ops.imvx.conv3x3x3`` (one node of a ``torch.export``
    program), else through :class:`Conv3x3x3Function`."""
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad
                                        or kernel.requires_grad):
            return Conv3x3x3Function.apply(x.contiguous(),
                                           kernel.contiguous())
        return conv_kernel.conv3x3x3_op(x.contiguous(), kernel.contiguous())
    return conv3x3x3_plain(x, kernel)
