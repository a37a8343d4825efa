"""A synthetic KITTI batch: real camera geometry, random images.

The camera is KITTI's camera 2 (intrinsics of the 1242x375 frames) looking
along the lidar's +x axis, so roughly two thirds of the ``imvoxelnet_kitti``
voxel grid (0..69 m ahead, +-40 m across) projects into the image; the grid
center is nudged off the voxel lattice.  Images are padded 1280x384 with
``ratio = ori_h / (img_h / stride) = 4`` (``imvoxelnet.py:118``).
"""

from __future__ import annotations

import numpy as np
import torch

KITTI_H, KITTI_W = 384, 1280
K_KITTI = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854],
                    [0.0, 0.0, 1.0]], np.float32)
LIDAR_TO_CAM = np.array([[0, -1, 0, 0.0], [0, 0, -1, -0.08],
                         [1, 0, 0, -0.27], [0, 0, 0, 1]], np.float32)
# point-cloud-range center, nudged off the voxel grid
KITTI_ORIGIN = (34.56 + 0.0137, 0.0 - 0.0213, -1.0 + 0.0071)


def kitti_batch(b: int, device='cuda', seed: int = 0):
    """A ``b``-sample, one-view batch in the detector's layout."""
    rng = np.random.RandomState(seed)
    h, w = KITTI_H, KITTI_W
    return dict(
        images=torch.tensor(rng.randn(b, 1, h, w, 3).astype(np.float32),
                            device=device),
        intrinsics=torch.tensor(np.stack([K_KITTI] * b), device=device),
        extrinsics=torch.tensor(np.stack([LIDAR_TO_CAM[None]] * b),
                                device=device),
        origins=torch.tensor([KITTI_ORIGIN] * b, dtype=torch.float32,
                             device=device),
        img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                               device=device),
        ratios=torch.full((b,), 4.0, device=device),
    )


YAW_KNIFE_EDGES = np.pi / 4 * np.arange(-4, 5)     # multiples of pi/4
YAW_MARGIN = 0.05


def car_boxes(rng, b: int, max_gt: int, x_range, y_per_x, y_range,
              z_bottom: float = -1.78):
    """Padded GT of ``b`` samples: ``max_gt // 2 .. max_gt`` cars each.

    Cars have KITTI sizes (about 1.6 x 3.9 x 1.56 m, bottom-center boxes)
    with centers at ``x`` in ``x_range`` and ``y`` in ``y_per_x * x``
    (the camera's view) and in ``y_range``, at least 4 m apart.  Yaws keep
    ``YAW_MARGIN`` from every multiple of pi/4 outside pi/2 and -pi/2: from
    the axis-aligned IoU's extent swap at +-pi/4 and +-3pi/4 and from the
    direction bins' edges at 0 and +-pi.

    Returns numpy ``gt_boxes (b, max_gt, 7)`` float32 (padding zeros),
    ``gt_labels (b, max_gt)`` int32 (class 0) and ``gt_mask`` bool.
    """
    boxes = np.zeros((b, max_gt, 7), np.float32)
    mask = np.zeros((b, max_gt), bool)
    edges = np.delete(YAW_KNIFE_EDGES, [2, 6])             # not +-pi/2
    for s in range(b):
        n = rng.randint(max_gt // 2, max_gt + 1)
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


def kitti_train_batch(b: int, device='cuda', seed: int = 0,
                      size=(1408, 416)):
    """A ``b``-sample training batch: :func:`kitti_batch`'s camera at the
    ``imvoxelnet_kitti`` padded train size ``(W, H)``, with 16 padded GT
    slots of cars inside the anchor range and the camera's view."""
    w, h = size
    rng = np.random.RandomState(seed)
    fx, cx = K_KITTI[0, 0], K_KITTI[0, 2]
    # lidar y = -camera x: the image spans -y / x in [-cx, w - cx] / fx
    boxes, labels, mask = car_boxes(
        rng, b, 16, x_range=(5.0, 60.0),
        y_per_x=(-0.8 * (w - cx) / fx, 0.8 * cx / fx),
        y_range=(-37.0, 37.0))
    batch = dict(
        images=torch.tensor(rng.randn(b, 1, h, w, 3).astype(np.float32),
                            device=device),
        intrinsics=torch.tensor(np.stack([K_KITTI] * b), device=device),
        extrinsics=torch.tensor(np.stack([LIDAR_TO_CAM[None]] * b),
                                device=device),
        origins=torch.tensor([KITTI_ORIGIN] * b, dtype=torch.float32,
                             device=device),
        img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                               device=device),
        ratios=torch.full((b,), 4.0, device=device),
        gt_boxes=torch.tensor(boxes, device=device),
        gt_labels=torch.tensor(labels, device=device),
        gt_mask=torch.tensor(mask, device=device))
    return batch
