"""Image-to-voxel backprojection.

Counterpart of ``imvoxelnet_tpu/ops/backproject.py``.  Every voxel center is
projected into every view with a ``(3, 4)`` matrix, the nearest pixel of the
stride-4 feature map is gathered, masked by the valid image extent and by
positive depth, and mean-pooled over the views that see the voxel.

``backproject_batch`` runs the CUDA kernel (``kernels/backproject.py``) on
CUDA tensors and its plain version, ``backproject_batch_plain``, on CPU
tensors.  Layouts are the JAX package's: channel-last features
``(B, V, Hf, Wf, C)`` and voxel-major outputs ``(P, B, C)``.

The gradient reaches the features only (the JAX package's indices are
integers): on CUDA tensors through :class:`BackprojectFunction`, whose
backward is a kernel that gathers, for each feature row, the gradient rows of
the voxels that read it and adds them in ascending voxel order (no float
atomics: the result repeats bit for bit), with
``backproject_batch_grad_plain`` as its plain version; on CPU tensors
autograd differentiates the plain forward.
"""

from __future__ import annotations

import torch

from ..kernels import backproject as bp_kernel


def get_points(n_voxels, voxel_size, origins):
    """World coordinates of voxel centers, ``(B, nx, ny, nz, 3)`` float32.

    ``points = idx * voxel_size + origin - n_voxels / 2 * voxel_size``
    (``imvoxelnet.py:132-141``).  ``origins`` is ``(B, 3)``.
    """
    nx, ny, nz = (int(v) for v in n_voxels)
    dev = origins.device

    def const(values):
        # filled on the device: a tensor made from a list is a copy from the
        # host, which waits for the device
        return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                       device=dev) for v in values])
    vs, n = const(voxel_size), const((nx, ny, nz))
    idx = torch.stack(torch.meshgrid(
        torch.arange(nx, dtype=torch.float32, device=dev),
        torch.arange(ny, dtype=torch.float32, device=dev),
        torch.arange(nz, dtype=torch.float32, device=dev),
        indexing='ij'), dim=-1)
    new_origin = origins.float() - n / 2.0 * vs                 # (B, 3)
    return idx[None] * vs + new_origin[:, None, None, None, :]


def compute_projection(intrinsics, extrinsics, ratios):
    """Per-view projection matrices ``K_scaled @ E[:3]``, ``(B, V, 3, 4)``.

    The first two intrinsic rows are divided by
    ``ratio = ori_h / (img_h / stride)`` (``imvoxelnet.py:114-129``).
    ``intrinsics (B, 3, 3)``, ``extrinsics (B, V, 4, 4)``, ``ratios (B,)``.
    """
    k = intrinsics[:, :3, :3].float()
    r = 1.0 / ratios.float()
    scale = torch.stack([r, r, torch.ones_like(r)], dim=-1)      # (B, 3)
    k = k * scale[:, :, None]
    return torch.matmul(k[:, None], extrinsics[:, :, :3, :].float())


def project_points(points, projection):
    """Project points ``(..., P, 3)`` with matrices ``(..., 3, 4)`` (leading
    dims broadcast) to nearest-pixel coordinates.

    The projection is the explicit expression ``p0*x + p1*y + p2*z + p3``,
    evaluated left to right, as the backprojection kernel evaluates it; the
    pixel is ``round`` (half to even) of ``u / w``, with ``w`` replaced by 1
    where it is 0 (the Pallas body's safe divide).

    Returns:
      ``x, y`` rounded pixel coordinates (float) and the depth ``w``.
    """
    x, y, z = points.unbind(-1)

    def row(r):
        m = projection[..., r, :]
        return (m[..., 0:1] * x + m[..., 1:2] * y + m[..., 2:3] * z
                + m[..., 3:4])

    u, v, w = row(0), row(1), row(2)
    w_safe = torch.where(w != 0, w, torch.ones_like(w))
    return torch.round(u / w_safe), torch.round(v / w_safe), w


def _view_indices(points, projections, valid_hw, hf: int, wf: int):
    """Pixel index into each view's ``Hf*Wf`` table and validity, ``(B, V, P)``
    for points ``(B, P, 3)`` and projections ``(B, V, 3, 4)``."""
    xf, yf, w = project_points(points[:, None], projections)
    vh = valid_hw[:, 0].float()[:, None, None]
    vw = valid_hw[:, 1].float()[:, None, None]
    valid = (xf >= 0) & (yf >= 0) & (xf < vw) & (yf < vh) & (w > 0)
    xi = torch.where(valid, xf, torch.zeros_like(xf)).long().clamp(max=wf - 1)
    yi = torch.where(valid, yf, torch.zeros_like(yf)).long().clamp(max=hf - 1)
    return yi * wf + xi, valid


def _sum_dtype(dtype):
    """float32 sums, float64 for float64 inputs (``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def backproject_batch_plain(features, points, projections, valid_hw):
    """Plain PyTorch version of the backprojection kernel.

    Same contract as :func:`backproject_batch`.  Sums in float32 over the
    views in order, as the kernel does, and returns the features' dtype.
    """
    b, v, hf, wf, c = features.shape
    p = points.shape[1]
    idx, valid = _view_indices(points.float(), projections.float(),
                               valid_hw, hf, wf)
    table = features.reshape(b, v, hf * wf, c)
    rows = torch.arange(b, device=features.device)[:, None]
    sum_dtype = _sum_dtype(features.dtype)
    acc = torch.zeros((b, p, c), dtype=sum_dtype, device=features.device)
    for i in range(v):
        gathered = table[:, i][rows, idx[:, i]].to(sum_dtype)    # (B, P, C)
        acc = acc + torch.where(valid[:, i, :, None], gathered,
                                torch.zeros((), device=features.device))
    cnt = valid.sum(dim=1)                                       # (B, P)
    return (acc.transpose(0, 1).to(features.dtype).contiguous(),
            cnt.transpose(0, 1).to(features.dtype).contiguous())


def backproject_batch_grad_plain(grad_acc, points, projections, valid_hw,
                                 hf: int, wf: int):
    """Plain PyTorch version of the backward kernel: the gradient of
    :func:`backproject_batch_plain`'s sums with respect to the features.

    ``grad_acc (P, B, C)`` is added, in float32, into each view's
    ``(hf * wf, C)`` table at the pixels the forward read (``index_add_``);
    returns ``(B, V, hf, wf, C)`` in ``grad_acc``'s dtype.  On the CPU
    ``index_add_`` adds the rows one after another in index order, i.e. each
    feature row is a float32 sum from zero in ascending voxel order, rounded
    once: the kernel's order, so the two agree bit for bit.
    """
    p, b, c = grad_acc.shape
    v = projections.shape[1]
    idx, valid = _view_indices(points.float(), projections.float(),
                               valid_hw, hf, wf)
    sum_dtype = _sum_dtype(grad_acc.dtype)
    g = grad_acc.transpose(0, 1).to(sum_dtype)                  # (B, P, C)
    table = torch.zeros((b * v * hf * wf, c), dtype=sum_dtype,
                        device=grad_acc.device)
    view_base = torch.arange(b, device=grad_acc.device)[:, None] * v
    for i in range(v):
        flat = (view_base + i) * (hf * wf) + idx[:, i]            # (B, P)
        table.index_add_(0, flat[valid[:, i]], g[valid[:, i]])
    return table.reshape(b, v, hf, wf, c).to(grad_acc.dtype)


class BackprojectFunction(torch.autograd.Function):
    """B1 with its gradient: ``apply(features, points, projections,
    valid_hw, plain=False)`` -> ``(acc, cnt)``.

    The forward is the kernel (``plain=True``: ``backproject_batch_plain``)
    and the backward the gather kernel (``plain=True``:
    ``backproject_batch_grad_plain``), which recomputes the pixels rather
    than saving the forward's ``(B, V, P)`` indices, groups the voxels by
    pixel and sums each pixel's gradient rows in ascending voxel order, with
    no float atomics: the same inputs give the same bits.  Only ``features``
    gets a gradient; ``cnt`` is not differentiable.
    """

    @staticmethod
    def forward(ctx, features, points, projections, valid_hw, plain=False):
        fwd = backproject_batch_plain if plain else bp_kernel.backproject_batch
        acc, cnt = fwd(features, points, projections, valid_hw)
        ctx.save_for_backward(points, projections, valid_hw)
        ctx.plain = plain
        ctx.hw = features.shape[2:4]
        ctx.mark_non_differentiable(cnt)
        return acc, cnt

    @staticmethod
    def backward(ctx, grad_acc, _grad_cnt):
        # only ``features`` is differentiable, so it is the input that
        # asked for this call
        grad = (backproject_batch_grad_plain if ctx.plain
                else bp_kernel.backproject_batch_grad)
        points, projections, valid_hw = ctx.saved_tensors
        return (grad(grad_acc.contiguous(), points, projections, valid_hw,
                     *ctx.hw), None, None, None, None)


def backproject_batch(features, points, projections, valid_hw):
    """Whole-batch backprojection: masked sums and view counts.

    Args:
      features: ``(B, V, Hf, Wf, C)``.
      points: ``(B, P, 3)`` per-sample voxel centers.
      projections: ``(B, V, 3, 4)``.
      valid_hw: ``(B, 2)`` int ``(h, w)`` valid feature extents.

    Returns:
      acc ``(P, B, C)`` per-voxel feature sums over valid views and cnt
      ``(P, B)`` the number of views seeing each voxel, in the features'
      dtype.

    On the CPU the plain versions run, the backward too: autograd of the
    plain forward's gather would accumulate with CPU atomics, whose order,
    and so whose bits, change from run to run.  On CUDA features that need
    no gradient the kernel runs as the operator ``torch.ops.imvx.backproject``
    (one node of a ``torch.export`` program), else through
    :class:`BackprojectFunction`.
    """
    if features.is_cuda:
        args = (features.contiguous(), points.float().contiguous(),
                projections.float().contiguous(),
                valid_hw.to(torch.int32).contiguous())
        if torch.is_grad_enabled() and features.requires_grad:
            return BackprojectFunction.apply(*args)
        return bp_kernel.backproject_op(*args)
    return BackprojectFunction.apply(features, points, projections, valid_hw,
                                     True)


def mean_pool_from_sums(acc, cnt, n_views=None):
    """Mean over seen views, zero where unseen (``imvoxelnet.py:70-74``).

    With a single view the masked sums already are the means, so the
    division is skipped.
    """
    seen = cnt > 0
    if n_views == 1:
        return acc, seen
    volume = torch.where(seen[..., None], acc / cnt[..., None].clamp(min=1.0),
                         torch.zeros((), dtype=acc.dtype, device=acc.device))
    return volume, seen
