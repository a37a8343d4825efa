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
