"""3D anchor generation.

Counterpart of ``imvoxelnet_tpu/core/anchors.py``: linspace centers over the
anchor range (inclusive endpoints) x sizes x rotations, flattened row-major
in the order of a conv head's NHWC ``reshape(-1, ...)``.  Built with numpy in
float32, as the reference does, then moved to the requested device.
"""

from __future__ import annotations

import numpy as np
import torch


def anchors_single_range(feature_size, anchor_range, sizes, rotations,
                         custom_values=()):
    """``(D, H, W, n_sizes, n_rots, 7 + len(custom_values))`` numpy anchors."""
    if len(feature_size) == 2:
        feature_size = (1, feature_size[0], feature_size[1])
    d, h, w = feature_size
    ar = np.asarray(anchor_range, np.float32)
    z = np.linspace(ar[2], ar[5], d, dtype=np.float32)
    y = np.linspace(ar[1], ar[4], h, dtype=np.float32)
    x = np.linspace(ar[0], ar[3], w, dtype=np.float32)
    sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
    rotations = np.asarray(rotations, np.float32)
    ns, nr = sizes.shape[0], rotations.shape[0]

    zz, yy, xx = np.meshgrid(z, y, x, indexing='ij')
    centers = np.stack([xx, yy, zz], axis=-1)
    centers = np.broadcast_to(centers[:, :, :, None, None, :],
                              (d, h, w, ns, nr, 3))
    size_b = np.broadcast_to(sizes[None, None, None, :, None, :],
                             (d, h, w, ns, nr, 3))
    rot_b = np.broadcast_to(rotations[None, None, None, None, :, None],
                            (d, h, w, ns, nr, 1))
    anchors = np.concatenate([centers, size_b, rot_b], axis=-1)
    if custom_values:
        extra = np.zeros((d, h, w, ns, nr, len(custom_values)), np.float32)
        anchors = np.concatenate([anchors, extra], axis=-1)
    return anchors


def grid_anchors(featmap_size, ranges, sizes, rotations, custom_values=(),
                 device=None):
    """Multi-range anchors ``(H*W*n_sizes*n_rots, box_dim)`` on ``device``."""
    sets = [
        anchors_single_range(featmap_size, r, [s], rotations,
                             custom_values=custom_values)
        for r, s in zip(ranges, sizes)
    ]
    anchors = np.concatenate(sets, axis=-3)
    return torch.from_numpy(
        np.ascontiguousarray(anchors.reshape(-1, anchors.shape[-1]))).to(
            device)
