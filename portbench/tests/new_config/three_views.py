"""A scenes module that a new configuration brings as a file of its own
(``scenes/three_views.py`` in the test's copy of the benchmark): a street
seen by three cameras, KITTI's camera 2 turned by -40, 0 and +40 degrees
about the vertical axis, so that most voxels are seen by one view and the
overlaps by two."""

from __future__ import annotations

import numpy as np

from .kitti import KITTI_ORIGIN, K_KITTI, LIDAR_TO_CAM
from .kitti import ground_truth, ratio  # noqa: F401

VIEWS = 3
YAWS = np.deg2rad([-40.0, 0.0, 40.0])


def _turned(yaw):
    """The camera's extrinsic with the world turned by ``-yaw`` about z."""
    c, s = np.cos(yaw), np.sin(yaw)
    turn = np.array([[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)
    return LIDAR_TO_CAM @ turn


def cameras(rng, b, size, train):
    ext = np.stack([_turned(yaw) for yaw in YAWS]).astype(np.float32)
    return (np.stack([K_KITTI] * b), np.stack([ext] * b),
            np.array([KITTI_ORIGIN] * b, np.float32))
