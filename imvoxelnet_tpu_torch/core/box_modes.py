"""Box coordinate-mode conversions (CAM / LIDAR / DEPTH).

Parity: ``Box3DMode.convert`` (``mmdet3d/core/bbox/structures/box_3d_mode.py:
62-175``): xyz transformed by the (default or provided) rotation/translation,
sizes permuted per mode pair, yaw carried through unchanged (the v0.8
convention).  numpy only.

A copy of ``imvoxelnet_tpu/core/box_modes.py`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import numpy as np

CAM = 'cam'
LIDAR = 'lidar'
DEPTH = 'depth'

# default rotations (box_3d_mode.py:105-123) and size-axis permutations
_DEFAULTS = {
    (LIDAR, CAM): (np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32),
                   (1, 2, 0)),
    (CAM, LIDAR): (np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32),
                   (2, 0, 1)),
    (DEPTH, CAM): (np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float32),
                   (0, 2, 1)),
    (CAM, DEPTH): (np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
                   (0, 2, 1)),
    (LIDAR, DEPTH): (np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32),
                     (1, 0, 2)),
    (DEPTH, LIDAR): (np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], np.float32),
                     (1, 0, 2)),
}


def convert(boxes, src: str, dst: str, rt_mat=None):
    """Convert ``(N, >=7)`` boxes between modes.

    ``rt_mat``: optional ``(3, 3)`` or ``(4, 4)``/``(3, 4)`` transform applied
    as ``xyz' = [xyz, 1] @ rt[:3].T`` (overrides the default rotation).
    """
    if src == dst:
        return boxes
    boxes = np.asarray(boxes)
    default_rot, size_perm = _DEFAULTS[(src, dst)]
    if rt_mat is None:
        rt_mat = default_rot
    rt_mat = np.asarray(rt_mat, boxes.dtype)
    xyz = boxes[..., :3]
    if rt_mat.shape[-1] == 4:
        ones = np.ones_like(xyz[..., :1])
        xyz = np.concatenate([xyz, ones], axis=-1) @ rt_mat[:3].T
    else:
        xyz = xyz @ rt_mat.T
    sizes = boxes[..., 3:6][..., list(size_perm)]
    return np.concatenate([xyz[..., :3], sizes, boxes[..., 6:]], axis=-1)
