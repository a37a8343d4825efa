"""The one traffic generator: pools of distinct seeded batches.

A traffic mix (``portbench/traffic/<name>.json``) names the mode (``serve``
or ``train``), the batch size and how many distinct batches the pool
holds; the configuration's file names the dataset, the image sizes and the
assumed ground truth per scene.  Everything is drawn from ``--seed``: the
cameras and boxes on the host (a few hundred numbers), the images on the
device in one call.

The scene geometry is a frozen copy of the port's synthetic batches
(``imvoxelnet_tpu_torch/utils/synthetic.py``), so that a change there
cannot move the benchmark:

* KITTI: KITTI's camera 2 (intrinsics of the 1242x375 frames) looking
  along the lidar's +x axis, the grid centre nudged off the voxel lattice,
  ``ratio`` 4; training scenes hold cars of KITTI sizes inside the anchor
  range and the camera's view, at least 4 m apart, their yaws kept off the
  multiples of pi/4 where the axis-aligned IoU and the direction bins
  switch.
* SUN RGB-D: a Kinect-like camera (fx = fy = 529.5 at 640x480) pitched
  and rolled by a few degrees, the extrinsic built as the dataset builds it
  from ``Rt``, grid origin ``(0, 3, -1)``; training scenes hold furniture
  on a floor 1.67-1.75 m below the camera, with one small, one medium and
  one large box in every room so that every level of the head has
  positives.
"""

from __future__ import annotations

import numpy as np
import torch

K_KITTI = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854],
                    [0.0, 0.0, 1.0]], np.float32)
LIDAR_TO_CAM = np.array([[0, -1, 0, 0.0], [0, 0, -1, -0.08],
                         [1, 0, 0, -0.27], [0, 0, 0, 1]], np.float32)
KITTI_ORIGIN = (34.56 + 0.0137, 0.0 - 0.0213, -1.0 + 0.0071)
KITTI_W = 1280
YAW_KNIFE_EDGES = np.pi / 4 * np.arange(-4, 5)
YAW_MARGIN = 0.05
SUNRGBD_W = 640
SUNRGBD_ORIGIN = (0.0, 3.0, -1.0)
FLOOR_Z = (-1.75, -1.67)


def rng_for(seed: int, *tags: int) -> np.random.RandomState:
    """A host generator for ``seed`` (any size of integer) and ``tags``."""
    words = np.random.SeedSequence([int(seed), *tags]).generate_state(8)
    return np.random.RandomState(words)


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``seed`` and ``tags``."""
    word = np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0]
    return int(word) & ((1 << 63) - 1)


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


def _cameras(dataset, rng, b, size, train):
    """``(intrinsics (b, 3, 3), extrinsics (b, 1, 4, 4), origins (b, 3))``
    as numpy float32."""
    w, h = size
    if dataset == 'kitti':
        return (np.stack([K_KITTI] * b), np.stack([LIDAR_TO_CAM[None]] * b),
                np.array([KITTI_ORIGIN] * b, np.float32))
    if dataset == 'sunrgbd':
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
    raise ValueError(f'no traffic for dataset {dataset!r}')


def _ratio(dataset, w):
    """``ori_h / (img_h / stride)``: 4 at the published sizes; a KITTI
    image narrower than 1280 (the tests' tiny cells) sees the same view
    through a camera scaled down with it."""
    return 4.0 * KITTI_W / w if dataset == 'kitti' else 4.0


def _ground_truth(dataset, rng, b, size, data):
    lo, hi = data['gt_per_scene']
    if dataset == 'kitti':
        w, _ = size
        fx, cx = K_KITTI[0, 0], K_KITTI[0, 2]
        return car_boxes(rng, b, (lo, hi), data['max_gt'],
                         x_range=(5.0, 60.0),
                         y_per_x=(-0.8 * (w - cx) / fx, 0.8 * cx / fx),
                         y_range=(-37.0, 37.0))
    return furniture_boxes(rng, b, (lo, hi), data['max_gt'],
                           data['n_classes'])


def make_pool(config: dict, traffic: dict, seed: int, device):
    """``traffic['pool']`` distinct batches of ``traffic['batch']`` scenes
    of ``config``'s dataset in the detector's layout, on ``device``.
    Serving batches are at the test size, training batches at the train
    size with padded ground truth."""
    data = config['data']
    train = traffic['mode'] == 'train'
    b, n = traffic['batch'], traffic['pool']
    w, h = data['train_size'] if train else data['test_size']
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 1))
    images = torch.randn((n, b, 1, h, w, 3), generator=gen, device=device)
    pool = []
    for i in range(n):
        rng = rng_for(seed, 2, i)
        k, ext, origins = _cameras(data['dataset'], rng, b, (w, h), train)
        batch = dict(
            images=images[i],
            intrinsics=torch.tensor(k, device=device),
            extrinsics=torch.tensor(ext, device=device),
            origins=torch.tensor(origins, device=device),
            img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                                   device=device),
            ratios=torch.full((b,), _ratio(data['dataset'], w),
                              device=device))
        if train:
            boxes, labels, mask = _ground_truth(data['dataset'], rng, b,
                                                (w, h), data)
            batch.update(gt_boxes=torch.tensor(boxes, device=device),
                         gt_labels=torch.tensor(labels, device=device),
                         gt_mask=torch.tensor(mask, device=device))
        pool.append(batch)
    return pool
