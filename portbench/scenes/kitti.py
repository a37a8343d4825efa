"""KITTI's camera 2 (intrinsics of the 1242x375 frames) looking along the
lidar's +x axis, the grid centre nudged off the voxel lattice, ``ratio``
4; training scenes hold cars of KITTI sizes inside the anchor range and
the camera's view, at least 4 m apart, their yaws kept off the multiples
of pi/4 where the axis-aligned IoU and the direction bins switch."""

from __future__ import annotations

import numpy as np

K_KITTI = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854],
                    [0.0, 0.0, 1.0]], np.float32)
LIDAR_TO_CAM = np.array([[0, -1, 0, 0.0], [0, 0, -1, -0.08],
                         [1, 0, 0, -0.27], [0, 0, 0, 1]], np.float32)
KITTI_ORIGIN = (34.56 + 0.0137, 0.0 - 0.0213, -1.0 + 0.0071)
KITTI_W = 1280
YAW_KNIFE_EDGES = np.pi / 4 * np.arange(-4, 5)
YAW_MARGIN = 0.05
VIEWS = 1


def car_boxes(rng, b, gt_range, max_gt, x_range, y_per_x, y_range,
              z_bottom=-1.78):
    """Padded GT of ``b`` scenes of ``gt_range`` cars each (KITTI sizes,
    bottom-centre boxes, class 0)."""
    boxes = np.zeros((b, max_gt, 7), np.float32)
    mask = np.zeros((b, max_gt), bool)
    edges = np.delete(YAW_KNIFE_EDGES, [2, 6])
    for s in range(b):
        n = rng.randint(gt_range[0], gt_range[1] + 1)
        centers = []
        while len(centers) < n:
            x = rng.uniform(*x_range)
            lo = max(y_per_x[0] * x, y_range[0])
            hi = min(y_per_x[1] * x, y_range[1])
            y = rng.uniform(lo, hi)
            if all((x - cx) ** 2 + (y - cy) ** 2 > 16 for cx, cy in centers):
                centers.append((x, y))
        for g, (x, y) in enumerate(centers):
            yaw = rng.uniform(-np.pi, np.pi)
            while np.abs(yaw - edges).min() < YAW_MARGIN:
                yaw = rng.uniform(-np.pi, np.pi)
            size = np.array([1.6, 3.9, 1.56]) * np.exp(0.05 * rng.randn(3))
            boxes[s, g] = (x, y, z_bottom + 0.1 * rng.randn(), *size, yaw)
        mask[s, :n] = True
    return boxes, np.zeros((b, max_gt), np.int32), mask


def cameras(rng, b, size, train):
    return (np.stack([K_KITTI] * b), np.stack([LIDAR_TO_CAM[None]] * b),
            np.array([KITTI_ORIGIN] * b, np.float32))


def ratio(w):
    """4 at the published sizes; an image narrower than 1280 (the tests'
    tiny cells) sees the same view through a camera scaled down with it."""
    return 4.0 * KITTI_W / w


def ground_truth(rng, b, size, data):
    lo, hi = data['gt_per_scene']
    w, _ = size
    fx, cx = K_KITTI[0, 0], K_KITTI[0, 2]
    return car_boxes(rng, b, (lo, hi), data['max_gt'],
                     x_range=(5.0, 60.0),
                     y_per_x=(-0.8 * (w - cx) / fx, 0.8 * cx / fx),
                     y_range=(-37.0, 37.0))
