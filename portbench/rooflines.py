"""The bytes and operations the port's hand-written kernels need for the
cell's inputs: a frozen copy of the rules of ``PERF.md``'s kernel table.

* B1, the backprojection forward: the distinct feature rows some voxel
  reads, each once, plus the points, projections and extents read and the
  sums and counts written.  Its backward: the gradient rows of the voxels
  that some view sees, plus the same small inputs, and the feature
  gradient written.  Both are bytes-bound: their bound is bytes over
  ``peaks.PEAK_BYTES``.
* B3, the KITTI neck's block0 3x3x3 convs: ``2 * 27 * Cin * Cout`` per
  output voxel, over the bfloat16 tensor-core peak; a training step runs
  the forward and the input gradient through it (the weight gradient is
  cuDNN's).

The pixels come from the reference's projection
(``reference/backproject.py:_view_indices``), not from the program.
"""

from __future__ import annotations

import torch

from .reference import backproject as bp


def _sizes(cfg, batch):
    b, v, h, w, _ = batch['images'].shape
    nx, ny, nz = cfg.n_voxels
    return b, v, h // cfg.stride, w // cfg.stride, nx * ny * nz


def b1_bytes(cfg, batch, train: bool, elem: int = 2) -> float:
    """Bytes B1 needs for one batch (``train``: forward and backward),
    features of ``elem`` bytes."""
    b, v, hf, wf, p = _sizes(cfg, batch)
    c = cfg.fpn_out_channels
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                           batch['origins']).reshape(b, -1, 3)
    proj = bp.compute_projection(batch['intrinsics'], batch['extrinsics'],
                                 batch['ratios'])
    hw = (batch['img_shape'] // cfg.stride).to(torch.int32)
    idx, valid = bp._view_indices(points, proj, hw, hf, wf)    # (B, V, P)
    keys = (torch.arange(b * v, device=idx.device).reshape(b, v, 1)
            * (hf * wf) + idx)[valid]
    rows_read = int(torch.unique(keys).numel())
    small = 4 * (b * p * 3 + b * v * 12 + b * 2)
    total = rows_read * c * elem + small + p * b * (c + 1) * elem
    if train:
        rows_seen = int(valid.any(1).sum())
        total += rows_seen * c * elem + small + b * v * hf * wf * c * elem
    return float(total)


def b3_flops(cfg, batch, train: bool) -> float:
    """Operations of the block0 convs B3 runs for one batch, 0 where the
    neck takes no B3 (the port gates it to 64 -> 64 channels on a large,
    shallow plane: the KITTI neck)."""
    if cfg.neck.kind != 'kitti':
        return 0.0
    b = batch['images'].shape[0]
    nx, ny, nz = cfg.n_voxels
    c = cfg.neck.in_channels
    per_conv = 2.0 * 27 * c * c * nx * ny * nz * b
    return per_conv * (4 if train else 2)
