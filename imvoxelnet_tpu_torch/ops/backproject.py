"""Image-to-voxel backprojection.

Counterpart of ``imvoxelnet_tpu/ops/backproject.py``.  Every voxel center is
projected into every view with a ``(3, 4)`` matrix, the nearest pixel of the
stride-4 feature map is gathered, masked by the valid image extent and by
positive depth, and mean-pooled over the views that see the voxel.

``backproject_batch`` runs the CUDA kernel (``kernels/backproject.py``) on
CUDA tensors and its plain version, ``backproject_batch_plain``, on CPU
tensors.  Layouts are the JAX package's: channel-last features
``(B, V, Hf, Wf, C)`` and voxel-major outputs ``(P, B, C)``.
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
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    n = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
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
    acc = torch.zeros((b, p, c), dtype=torch.float32, device=features.device)
    for i in range(v):
        gathered = table[:, i][rows, idx[:, i]].float()          # (B, P, C)
        acc = acc + torch.where(valid[:, i, :, None], gathered,
                                torch.zeros((), device=features.device))
    cnt = valid.sum(dim=1)                                       # (B, P)
    return (acc.transpose(0, 1).to(features.dtype).contiguous(),
            cnt.transpose(0, 1).to(features.dtype).contiguous())


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
    """
    if features.is_cuda:
        return bp_kernel.backproject_batch(
            features.contiguous(), points.float().contiguous(),
            projections.float().contiguous(),
            valid_hw.to(torch.int32).contiguous())
    return backproject_batch_plain(features, points, projections, valid_hw)


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
