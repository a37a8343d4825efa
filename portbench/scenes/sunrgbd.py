"""SUN RGB-D: a Kinect-like camera (fx = fy = 529.5 at 640x480) pitched
and rolled by a few degrees, the extrinsic built as the dataset builds it
from ``Rt``, grid origin ``(0, 3, -1)``, ``ratio`` 4; training scenes hold
furniture on a floor 1.67-1.75 m below the camera, with one small, one
medium and one large box in every room so that every level of the head
has positives."""

from __future__ import annotations

import numpy as np

SUNRGBD_W = 640
SUNRGBD_ORIGIN = (0.0, 3.0, -1.0)
FLOOR_Z = (-1.75, -1.67)
VIEWS = 1


def furniture_boxes(rng, b, gt_range, max_gt, n_classes):
    """Padded GT of ``b`` rooms of ``gt_range`` furniture boxes each."""
    boxes = np.zeros((b, max_gt, 7), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    mask = np.zeros((b, max_gt), bool)
    half_tan = 0.6 * (SUNRGBD_W / 2) / 529.5
    for s in range(b):
        n = rng.randint(gt_range[0], min(gt_range[1], max_gt) + 1)
        floor = rng.uniform(*FLOOR_Z)
        for g in range(n):
            y, x_share = rng.uniform(1.5, 5.2), 1.0
            if g == 0:
                size = rng.uniform(0.3, 0.9, 3)
                y, x_share = rng.uniform(3.4, 4.8), 0.5
            elif g == 1:
                size = rng.uniform(1.0, 1.5, 3)
                y, x_share = rng.uniform(3.4, 4.8), 0.5
            elif g == 2:
                size = np.r_[rng.uniform(2.1, 2.5, 2), rng.uniform(1.7, 2.5)]
                y, x_share = rng.uniform(3.2, 5.0), 0.3
            else:
                size = rng.uniform(0.3, 2.5, 3)
            x = rng.uniform(-1, 1) * x_share * half_tan * y
            boxes[s, g] = (x, y, floor + rng.uniform(-0.02, 0.02), *size,
                           rng.uniform(-np.pi, np.pi))
            labels[s, g] = rng.randint(n_classes)
        mask[s, :n] = True
    return boxes, labels, mask


def _rotation(pitch, roll):
    cp, sp, cr, sr = np.cos(pitch), np.sin(pitch), np.cos(roll), np.sin(roll)
    r_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    r_y = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    return r_x @ r_y


def _sunrgbd_extrinsic(rt):
    e = np.asarray(rt, np.float32).copy()
    e[:, [1, 2]] = e[:, [2, 1]]
    e[:, 1] = -e[:, 1]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = e.T
    return out


def cameras(rng, b, size, train):
    w, h = size
    f = 529.5 * w / SUNRGBD_W
    k = np.array([[f, 0.0, (w - 1) / 2 + 0.137],
                  [0.0, f, (h - 1) / 2 - 0.213], [0.0, 0.0, 1.0]],
                 np.float32)
    pitch = (-8.0, -2.0) if train else (2.0, 8.0)
    ext = np.stack([
        _sunrgbd_extrinsic(_rotation(np.deg2rad(rng.uniform(*pitch)),
                                     np.deg2rad(rng.uniform(-3, 3))))[None]
        for _ in range(b)])
    return (np.stack([k] * b), ext,
            np.array([SUNRGBD_ORIGIN] * b, np.float32))


def ratio(w):
    return 4.0


def ground_truth(rng, b, size, data):
    lo, hi = data['gt_per_scene']
    return furniture_boxes(rng, b, (lo, hi), data['max_gt'],
                           data['n_classes'])
