"""The bytes and operations the port's hand-written kernels need for the
cell's inputs: a frozen copy of the rules of ``PERF.md``'s kernel table.

* B1, the backprojection forward: the distinct feature rows some voxel
  reads, each once, plus the points, projections and extents read and the
  sums and counts written.  Its backward: the gradient rows of the voxels
  that some view sees, plus the same small inputs, and the feature
  gradient written.  Both are bytes-bound: their bound is bytes over
  ``peaks.PEAK_BYTES``.
* B3, the 3x3x3 convs whose input meets the port's gate (a frozen copy:
  :func:`takes_b3`): ``2 * 27 * Cin * Cout`` per output voxel, over the
  bfloat16 tensor-core peak; a training step runs the forward and the
  input gradient through it (the weight gradient is cuDNN's).

The pixels come from the reference's projection
(``reference/backproject.py:_view_indices``), not from the program.
"""

from __future__ import annotations

import torch
from torch.fx.experimental import _config as fx_config

from .flops import meta_batch
from .reference import backproject as bp
from .reference.necks3d import Conv3x3x3

# the port's gate (``models/necks3d.py:Conv3x3x3.takes_kernel``)
B3_CHANNELS, B3_NZ, B3_MIN_PLANE = 64, (6, 16), 16384


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


def takes_b3(conv, shape) -> bool:
    """Whether the port sends ``conv`` on an input of ``shape`` ``(B, C,
    nx, ny, nz)`` to B3: stride 1, padding 1, 64 to 64 channels, a
    shallow z and a large plane."""
    _, cin, nx, ny, nz = shape
    return (tuple(conv.stride) == (1, 1, 1)
            and tuple(conv.padding) == (1, 1, 1)
            and cin == B3_CHANNELS and conv.weight.shape[0] == B3_CHANNELS
            and B3_NZ[0] <= nz <= B3_NZ[1] and nx * ny >= B3_MIN_PLANE)


def b3_flops(reference, cfg, batch, train: bool) -> float:
    """Operations of the convs B3 runs for one batch: the model of ``cfg``
    of the ``reference`` module walked on the meta device, each
    :class:`Conv3x3x3` whose input meets the gate counted once a forward,
    twice a training step (its input gradient); 0 where none does."""
    with torch.device('meta'):
        model = reference.ImVoxelNet(cfg)
    gated = []

    def record(conv, args):
        shape = args[0].shape
        if takes_b3(conv, shape):
            b, cin, nx, ny, nz = shape
            gated.append(2.0 * 27 * cin * conv.weight.shape[0]
                         * nx * ny * nz * b)
    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, Conv3x3x3)]
    with torch.no_grad(), fx_config.patch(
            meta_nonzero_assume_all_nonzero=True):
        model.eval()(meta_batch(batch))
    for h in hooks:
        h.remove()
    return float(sum(gated)) * (2 if train else 1)
