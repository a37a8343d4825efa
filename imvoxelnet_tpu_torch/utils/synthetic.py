"""Synthetic batches: real camera geometry, random images.

KITTI (:func:`kitti_batch`): the camera is KITTI's camera 2 (intrinsics of
the 1242x375 frames) looking along the lidar's +x axis, so roughly two
thirds of the ``imvoxelnet_kitti`` voxel grid (0..69 m ahead, +-40 m across)
projects into the image; the grid center is nudged off the voxel lattice.
Images are padded 1280x384 with ``ratio = ori_h / (img_h / stride) = 4``
(``imvoxelnet.py:118``).

SUN RGB-D (:func:`sunrgbd_batch`, :func:`sunrgbd_train_batch` with
:func:`furniture_boxes`): a Kinect-like camera (fx = fy = 529.5 at
640x480) tilted by a few degrees of pitch and roll, with the extrinsic built
as the dataset builds it from the calibration's ``Rt``
(``imvoxelnet_tpu/data/datasets.py:231-240``) and the dataset's grid origin
``(0, 3, -1)``: the 6.4 x 6.4 x 2.56 m grid starts 0.2 m behind the camera.
Total3D's training batch (``layout=True``) adds the camera's ``(pitch,
roll)`` as ``gt_angles``, from which Total3D's ``predicted_extrinsics``
rebuilds the batch's extrinsic, and a room box around the furniture as
``gt_layout``.

ScanNet (:func:`scannet_batch`, :func:`scannet_train_batch` with
:func:`room_boxes`): ``V`` posed views of one room, cameras on a circle
around the room's middle looking at it, each view's extrinsic
``inv(axis_align @ pose)`` from a camera-to-world ``pose`` as the dataset
builds it (``imvoxelnet_tpu/data/datasets.py:310-323``), intrinsics of
ScanNet's 640x480 frames shared by the views, grid origin ``(0, 0, 0.5)``.

nuScenes (:func:`nuscenes_batch`, :func:`nuscenes_train_batch`): the six
cameras of the nuScenes ego at their published yaws (front, front right and
left at -55 and 55 degrees, back, back left and right at 110 and -110), about
1.5 m above the ground, in the lidar frame (x ahead, y left, z up; the lidar
1.84 m up).  As the dataset passes them (``imvoxelnet_tpu/data/
datasets.py:353-394``), each view's "extrinsic" is the whole ``lidar2img``
matrix with an nuScenes-like intrinsic folded in, and the intrinsic is the
identity; 1600x900 frames padded to 928, ``ratio`` 4, grid origin ``(0, 0,
-1)``.
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


def kitti_batch(b: int, device='cuda', seed: int = 0,
                size=(KITTI_W, KITTI_H), views: int = 1):
    """A ``b``-sample batch in the detector's layout, padded images of
    ``size (W, H)``; ``views`` images a sample, all from camera 2's pose."""
    rng = np.random.RandomState(seed)
    w, h = size
    return dict(
        images=torch.tensor(rng.randn(b, views, h, w, 3).astype(np.float32),
                            device=device),
        intrinsics=torch.tensor(np.stack([K_KITTI] * b), device=device),
        extrinsics=torch.tensor(np.stack([[LIDAR_TO_CAM] * views] * b),
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


SUNRGBD_H, SUNRGBD_W = 480, 640
SUNRGBD_ORIGIN = (0.0, 3.0, -1.0)           # datasets.py:228


def _rotation(pitch: float, roll: float):
    """Camera tilt ``Rt`` (3, 3) in the upright depth frame (z up, y ahead):
    a pitch about x, then a roll about y."""
    cp, sp, cr, sr = np.cos(pitch), np.sin(pitch), np.cos(roll), np.sin(roll)
    r_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    r_y = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    return r_x @ r_y


def _sunrgbd_extrinsic(rt):
    """``SunRgbdMultiViewDataset._matrices``'s extrinsic from ``Rt``: the
    depth frame's y and z columns swapped, y negated, transposed."""
    e = np.asarray(rt, np.float32).copy()
    e[:, [1, 2]] = e[:, [2, 1]]
    e[:, 1] = -e[:, 1]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = e.T
    return out


def sunrgbd_batch(b: int, device='cuda', seed: int = 0,
                  size=(SUNRGBD_W, SUNRGBD_H), pitch=(2.0, 8.0)):
    """A ``b``-sample, one-view SUN RGB-D-like batch in the detector's
    layout at image ``size (W, H)``: each sample's camera pitches by
    ``pitch`` degrees (uniform; positive looks up) and rolls by -3..3;
    intrinsics scale with the size from fx = fy = 529.5 at 640x480, the
    principal point nudged off the pixel grid; ``ratio = 4`` (the images
    are not resized)."""
    return _sunrgbd_batch(b, device, seed, size, pitch)[0]


def _sunrgbd_batch(b, device, seed, size, pitch):
    """:func:`sunrgbd_batch` and its cameras' ``(b, 2)`` (pitch, roll) in
    radians."""
    rng = np.random.RandomState(seed)
    w, h = size
    f = 529.5 * w / SUNRGBD_W
    k = np.array([[f, 0.0, (w - 1) / 2 + 0.137], [0.0, f, (h - 1) / 2 - 0.213],
                  [0.0, 0.0, 1.0]], np.float32)
    angles = np.array([(np.deg2rad(rng.uniform(*pitch)),
                        np.deg2rad(rng.uniform(-3, 3))) for _ in range(b)],
                      np.float64).reshape(b, 2)
    ext = np.stack([_sunrgbd_extrinsic(_rotation(p, r))[None]
                    for p, r in angles])
    return dict(
        images=torch.tensor(rng.randn(b, 1, h, w, 3).astype(np.float32),
                            device=device),
        intrinsics=torch.tensor(np.stack([k] * b), device=device),
        extrinsics=torch.tensor(ext, device=device),
        origins=torch.tensor([SUNRGBD_ORIGIN] * b, dtype=torch.float32,
                             device=device),
        img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                               device=device),
        ratios=torch.full((b,), 4.0, device=device),
    ), angles.astype(np.float32)


FLOOR_Z = (-1.75, -1.67)      # floor height below the camera (m)


def furniture_boxes(rng, b: int, max_gt: int, n_classes: int = 10):
    """Padded GT of ``b`` rooms: 4-16 furniture-sized boxes each, inside
    the view of the SUN RGB-D synthetic camera and grid (1.5-5.2 m ahead,
    within 60% of the image's half-width), bottoms within 2 cm of a floor
    1.67-1.75 m below the camera, yaws uniform.  Every room holds one small
    box (sides 0.3-0.9 m) and one medium (1.0-1.5 m), both 3.4-4.8 m ahead,
    and one large (2.1-2.5 m across, 1.7-2.5 m tall, 3.2-5 m ahead), nearer
    the middle of the view, so that the v1 regress ranges and the v2 level
    rule (27 points of 0.64 m) each give every level positives; the rest
    have sides of 0.3-2.5 m.

    Returns numpy ``gt_boxes (b, max_gt, 7)`` float32 (bottom center,
    padding zeros), ``gt_labels (b, max_gt)`` int32 and ``gt_mask`` bool.
    """
    boxes = np.zeros((b, max_gt, 7), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    mask = np.zeros((b, max_gt), bool)
    half_tan = 0.6 * (SUNRGBD_W / 2) / 529.5
    for s in range(b):
        n = rng.randint(4, min(16, max_gt) + 1)
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


def layout_boxes(rng, boxes, mask):
    """Total3D room layouts ``(b, 7)`` float32, bottom-center: per room an
    axis-aligned box around the BEV corners of its furniture with a margin
    of 0.3-0.8 m a side, from its floor to 2.5-3.1 m above it, turned by a
    yaw of -0.1..0.1."""
    out = np.zeros((boxes.shape[0], 7), np.float32)
    for s in range(boxes.shape[0]):
        bx = boxes[s][mask[s]].astype(np.float64)
        c, sn = np.cos(bx[:, 6]), np.sin(bx[:, 6])
        hx, hy = bx[:, 3] / 2, bx[:, 4] / 2
        ext_x = np.abs(c) * hx + np.abs(sn) * hy
        ext_y = np.abs(sn) * hx + np.abs(c) * hy
        lo = np.array([(bx[:, 0] - ext_x).min(), (bx[:, 1] - ext_y).min()])
        hi = np.array([(bx[:, 0] + ext_x).max(), (bx[:, 1] + ext_y).max()])
        lo -= rng.uniform(0.3, 0.8, 2)
        hi += rng.uniform(0.3, 0.8, 2)
        out[s] = (*(lo + hi) / 2, bx[:, 2].min(), *(hi - lo),
                  rng.uniform(2.5, 3.1), rng.uniform(-0.1, 0.1))
    return out


def sunrgbd_train_batch(b: int, device='cuda', seed: int = 0,
                        size=(768, 576), max_gt: int = 64,
                        n_classes: int = 10, layout: bool = False):
    """A ``b``-sample SUN RGB-D training batch: :func:`sunrgbd_batch`'s
    camera, looking down by 2-8 degrees onto the room, at the presets'
    padded train size ``(W, H)``, with :func:`furniture_boxes` padded to
    ``max_gt``.  ``layout`` (Total3D) adds ``gt_angles (b, 2)``, the
    cameras' (pitch, roll), and ``gt_layout (b, 7)`` from
    :func:`layout_boxes`."""
    rng = np.random.RandomState(seed + 1)
    boxes, labels, mask = furniture_boxes(rng, b, max_gt, n_classes)
    batch, angles = _sunrgbd_batch(b, device, seed, size, (-8.0, -2.0))
    batch.update(gt_boxes=torch.tensor(boxes, device=device),
                 gt_labels=torch.tensor(labels, device=device),
                 gt_mask=torch.tensor(mask, device=device))
    if layout:
        rooms = layout_boxes(np.random.RandomState(seed + 2), boxes, mask)
        batch.update(gt_angles=torch.tensor(angles, device=device),
                     gt_layout=torch.tensor(rooms, device=device))
    return batch


SCANNET_H, SCANNET_W = 480, 640
SCANNET_ORIGIN = (0.0, 0.0, 0.5)            # datasets.py:296
# ScanNet's depth-camera intrinsics at 640x480
SCANNET_F = 577.87


def _look_at(eye, target):
    """Camera-to-world pose (4, 4) of a camera at ``eye`` looking at
    ``target``: camera x right, y down, z ahead (ScanNet's poses)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x = x / np.linalg.norm(x)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, np.cross(z, x), \
        z, eye
    return pose


def scannet_batch(b: int, views: int, device='cuda', seed: int = 0,
                  size=(SCANNET_W, SCANNET_H)):
    """A ``b``-sample, ``views``-view ScanNet-like batch at image ``size
    (W, H)``: per room, cameras at 1.2-1.7 m on a circle of radius 2.2-2.8
    m around the room's middle, spread evenly over the circle with a
    jitter, each looking at a point within 0.5 m of the middle at 0.3-0.8 m
    height; the aligned frame is the scan's frame turned and shifted by a
    random ``axis_align`` matrix, so every extrinsic is ``inv(axis_align @
    pose)`` of the scan-frame pose.  Intrinsics (b, 3, 3) scale with the
    size from fx = fy = 577.87 at 640x480, the principal point nudged off
    the pixel grid; ``ratio = 4``."""
    rng = np.random.RandomState(seed)
    w, h = size
    f = SCANNET_F * w / SCANNET_W
    k = np.array([[f, 0.0, (w - 1) / 2 + 0.137], [0.0, f, (h - 1) / 2 - 0.213],
                  [0.0, 0.0, 1.0]], np.float32)
    ext = np.zeros((b, views, 4, 4), np.float32)
    for s in range(b):
        t = rng.uniform(-np.pi, np.pi)
        align = np.eye(4)
        align[:2, :2] = [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
        align[:3, 3] = rng.uniform(-3.0, 3.0, 3)
        phase = rng.uniform(-np.pi, np.pi)
        for v in range(views):
            a = phase + 2 * np.pi * (v + rng.uniform(-0.3, 0.3)) / views
            r = rng.uniform(2.2, 2.8)
            eye = np.array([r * np.cos(a), r * np.sin(a),
                            rng.uniform(1.2, 1.7)])
            target = np.r_[rng.uniform(-0.5, 0.5, 2), rng.uniform(0.3, 0.8)]
            # the scan-frame pose whose aligned pose looks at the target
            pose = np.linalg.inv(align) @ _look_at(eye, target)
            ext[s, v] = np.linalg.inv(align @ pose)
    return dict(
        images=torch.tensor(rng.randn(b, views, h, w, 3).astype(np.float32),
                            device=device),
        intrinsics=torch.tensor(np.stack([k] * b), device=device),
        extrinsics=torch.tensor(ext, device=device),
        origins=torch.tensor([SCANNET_ORIGIN] * b, dtype=torch.float32,
                             device=device),
        img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                               device=device),
        ratios=torch.full((b,), 4.0, device=device),
    )


def room_boxes(rng, b: int, max_gt: int, n_classes: int = 18):
    """Padded GT of ``b`` ScanNet rooms: 4-16 axis-aligned, yaw-free boxes
    each with centres within 2.2 m of the room's middle and bottoms within
    2 cm of the floor (z = 0).  As in :func:`furniture_boxes`, every room
    holds one small box (sides 0.3-0.9 m), one medium (1.0-1.5 m) and one
    large (2.6-3.0 m across, 1.7-2.5 m tall), so that every level gets
    positives: the grid's coarsest level has only two layers of 0.64 m
    voxels above the floor (at 0.50 and 1.14 m), so the v2 rule's 27 points
    need 4 x 4 of its columns; the rest have sides of 0.3-2.5 m.

    Returns numpy ``gt_boxes (b, max_gt, 7)`` float32 (bottom center, yaw
    0, padding zeros), ``gt_labels (b, max_gt)`` int32 and ``gt_mask``
    bool."""
    boxes = np.zeros((b, max_gt, 7), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    mask = np.zeros((b, max_gt), bool)
    for s in range(b):
        n = rng.randint(4, min(16, max_gt) + 1)
        for g in range(n):
            if g == 0:
                size = rng.uniform(0.3, 0.9, 3)
            elif g == 1:
                size = rng.uniform(1.0, 1.5, 3)
            elif g == 2:
                size = np.r_[rng.uniform(2.6, 3.0, 2), rng.uniform(1.7, 2.5)]
            else:
                size = rng.uniform(0.3, 2.5, 3)
            xy = rng.uniform(-2.2, 2.2, 2) * (0.5 if g == 2 else 1.0)
            boxes[s, g] = (*xy, rng.uniform(-0.02, 0.02), *size, 0.0)
            labels[s, g] = rng.randint(n_classes)
        mask[s, :n] = True
    return boxes, labels, mask


def scannet_train_batch(b: int, views: int, device='cuda', seed: int = 0,
                        size=(SCANNET_W, SCANNET_H), max_gt: int = 64,
                        n_classes: int = 18):
    """A ``b``-sample ScanNet training batch: :func:`scannet_batch`'s
    ``views`` cameras with :func:`room_boxes` padded to ``max_gt``."""
    rng = np.random.RandomState(seed + 1)
    boxes, labels, mask = room_boxes(rng, b, max_gt, n_classes)
    batch = scannet_batch(b, views, device, seed=seed, size=size)
    batch.update(gt_boxes=torch.tensor(boxes, device=device),
                 gt_labels=torch.tensor(labels, device=device),
                 gt_mask=torch.tensor(mask, device=device))
    return batch


NUSCENES_W, NUSCENES_H = 1600, 900         # camera frames
NUSCENES_PAD_H = 928                        # padded to a multiple of 32
NUSCENES_ORIGIN = (0.0, 0.0, -1.0)          # imvoxelnet_nuscenes.py:73
POINT_CLOUD_RANGE = (-49.92, -49.92, -2.92, 49.92, 49.92, 0.92)
# CAM_FRONT's focal length and principal point at 1600x900
NUSCENES_F, NUSCENES_C = 1266.42, (816.27, 491.51)
LIDAR_HEIGHT = 1.84
# the dataset's camera order: (yaw in degrees, x, y, height) on the ego,
# the lidar at (0.94, 0)
NUSCENES_CAMERAS = (
    (0.0, 1.70, 0.02, 1.51),        # CAM_FRONT
    (-55.0, 1.55, -0.49, 1.50),     # CAM_FRONT_RIGHT
    (55.0, 1.52, 0.49, 1.51),       # CAM_FRONT_LEFT
    (180.0, 0.03, 0.00, 1.58),      # CAM_BACK
    (110.0, 1.04, 0.48, 1.56),      # CAM_BACK_LEFT
    (-110.0, 1.04, -0.48, 1.56),    # CAM_BACK_RIGHT
)
LIDAR_ON_EGO = (0.94, 0.0)


def nuscenes_lidar2img(rng, scale: float = 1.0):
    """The six views' ``(6, 4, 4)`` lidar2img matrices for frames scaled by
    ``scale`` from 1600x900: each camera's yaw jittered by up to 1 degree
    and its pitch by up to 0.5, its principal point by up to 2 pixels (off
    the pixel grid)."""
    out = np.zeros((len(NUSCENES_CAMERAS), 4, 4), np.float32)
    for v, (yaw, x, y, z) in enumerate(NUSCENES_CAMERAS):
        a = np.deg2rad(yaw + rng.uniform(-1.0, 1.0))
        p = np.deg2rad(rng.uniform(-0.5, 0.5))
        ahead = np.array([np.cos(a) * np.cos(p), np.sin(a) * np.cos(p),
                          np.sin(p)])
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        down = np.cross(ahead, right)
        rot = np.stack([right, down, ahead])          # lidar -> camera
        centre = np.array([x - LIDAR_ON_EGO[0], y - LIDAR_ON_EGO[1],
                           z - LIDAR_HEIGHT])
        rt = np.eye(4)
        rt[:3, :3], rt[:3, 3] = rot, -rot @ centre
        k = np.eye(4)
        k[0, 0] = k[1, 1] = NUSCENES_F * scale
        k[0, 2] = (NUSCENES_C[0] + rng.uniform(-2.0, 2.0)) * scale + 0.137
        k[1, 2] = (NUSCENES_C[1] + rng.uniform(-2.0, 2.0)) * scale - 0.213
        out[v] = k @ rt
    return out


def nuscenes_batch(b: int, device='cuda', seed: int = 0,
                   size=(NUSCENES_W, NUSCENES_PAD_H)):
    """A ``b``-sample, six-view nuScenes-like batch at padded image ``size
    (W, H)``: frames of 1600x900 scaled to width ``W`` (``img_shape``),
    padded with zeros to ``H``; per view the :func:`nuscenes_lidar2img`
    matrix as the extrinsic, the identity as the intrinsic; ``ratio = 4``
    (the frames are not resized)."""
    rng = np.random.RandomState(seed)
    w, h_pad = size
    scale = w / NUSCENES_W
    h = int(round(NUSCENES_H * scale))
    ext = np.stack([nuscenes_lidar2img(rng, scale) for _ in range(b)])
    images = rng.randn(b, len(NUSCENES_CAMERAS), h_pad, w, 3).astype(
        np.float32)
    images[:, :, h:] = 0.0
    return dict(
        images=torch.tensor(images, device=device),
        intrinsics=torch.eye(3, device=device).repeat(b, 1, 1),
        extrinsics=torch.tensor(ext, device=device),
        origins=torch.tensor([NUSCENES_ORIGIN] * b, dtype=torch.float32,
                             device=device),
        img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                               device=device),
        ratios=torch.full((b,), 4.0, device=device),
    )


NUSCENES_CAR = (1.98, 4.67, 1.74)           # the preset's anchor size


def nuscenes_cars(rng, b: int, max_gt: int, extent: float = 45.0):
    """Padded GT of ``b`` samples: 8-32 cars each (at most ``max_gt``) of
    about the anchor size, with centres within ``extent`` of the lidar in x
    and y (inside ``POINT_CLOUD_RANGE`` for the preset's 45), at least 4 m
    from it and 6 m from each other, bottoms on the ground (1.84 m below
    the lidar) within 5 cm, yaws within 0.3 of 0, pi/2, pi or -pi/2 (away
    from the extent swap at odd multiples of pi/4 and the direction bins'
    edges at pi/4 and -3pi/4).

    Returns numpy ``gt_boxes (b, max_gt, 7)`` float32 (bottom center,
    padding zeros), ``gt_labels (b, max_gt)`` int32 (class 0) and
    ``gt_mask`` bool."""
    boxes = np.zeros((b, max_gt, 7), np.float32)
    mask = np.zeros((b, max_gt), bool)
    for s in range(b):
        n = rng.randint(min(8, max_gt), min(32, max_gt) + 1)
        centres = []
        while len(centres) < n:
            xy = rng.uniform(-extent, extent, 2)
            if np.hypot(*xy) > 4.0 and all(
                    np.hypot(*(xy - c)) > 6.0 for c in centres):
                centres.append(xy)
        for g, (x, y) in enumerate(centres):
            yaw = np.pi / 2 * rng.randint(-1, 3) + rng.uniform(-0.3, 0.3)
            size = np.array(NUSCENES_CAR) * np.exp(0.05 * rng.randn(3))
            boxes[s, g] = (x, y, -LIDAR_HEIGHT + rng.uniform(-0.05, 0.05),
                           *size, yaw)
        mask[s, :n] = True
    return boxes, np.zeros((b, max_gt), np.int32), mask


def nuscenes_train_batch(b: int, device='cuda', seed: int = 0,
                         size=(NUSCENES_W, NUSCENES_PAD_H), max_gt: int = 64,
                         extent: float = 45.0):
    """A ``b``-sample nuScenes training batch: :func:`nuscenes_batch`'s six
    cameras at the preset's padded train size ``(W, H)`` with
    :func:`nuscenes_cars` padded to ``max_gt``."""
    rng = np.random.RandomState(seed + 1)
    boxes, labels, mask = nuscenes_cars(rng, b, max_gt, extent)
    batch = nuscenes_batch(b, device, seed=seed, size=size)
    batch.update(gt_boxes=torch.tensor(boxes, device=device),
                 gt_labels=torch.tensor(labels, device=device),
                 gt_mask=torch.tensor(mask, device=device))
    return batch


def serving_batch(dataset: str, b: int, device='cuda', seed: int = 0,
                  views: int = 1, size=None):
    """The synthetic serving batch of a preset's ``data.dataset``;
    ``views`` (its ``data.n_images_test``) for ScanNet and KITTI (nuScenes
    has its six cameras); ``size (W, H)``: the padded images' (by default
    the dataset's frames')."""
    kw = {} if size is None else dict(size=tuple(size))
    if dataset == 'sunrgbd':
        return sunrgbd_batch(b, device, seed=seed, **kw)
    if dataset == 'kitti':
        return kitti_batch(b, device, seed=seed, views=views, **kw)
    if dataset == 'scannet':
        return scannet_batch(b, views, device, seed=seed, **kw)
    if dataset == 'nuscenes':
        return nuscenes_batch(b, device, seed=seed, **kw)
    raise NotImplementedError(f'no synthetic {dataset!r} batch')


def train_batch(data, b: int, device='cuda', seed: int = 0,
                layout: bool = False):
    """The synthetic training batch of a preset's ``data`` config
    (``configs/presets.py:DataConfig``), at its padded train size, with
    ``data.n_images_train`` views; ``layout`` adds Total3D's camera angles
    and room layout."""
    if data.dataset == 'sunrgbd':
        return sunrgbd_train_batch(b, device, seed=seed,
                                   size=data.train_size, max_gt=data.max_gt,
                                   n_classes=len(data.classes), layout=layout)
    if data.dataset == 'scannet':
        return scannet_train_batch(b, data.n_images_train, device, seed=seed,
                                   size=data.train_size, max_gt=data.max_gt,
                                   n_classes=len(data.classes))
    if data.dataset == 'kitti':
        return kitti_train_batch(b, device, seed=seed, size=data.train_size)
    if data.dataset == 'nuscenes':
        return nuscenes_train_batch(b, device, seed=seed,
                                    size=data.train_size, max_gt=data.max_gt)
    raise NotImplementedError(f'no synthetic {data.dataset!r} training '
                              f'batch')


# --------------------------------------------------------------------------
# PNG files (the evaluation path's tests and smoke run write their splits)
# --------------------------------------------------------------------------

_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}       # channels -> PNG color type


def png_filter_rows(px: np.ndarray, filters, bpp: int) -> np.ndarray:
    """The PNG row filters (spec section 9.2) applied to ``(h, row_bytes)``
    uint8 ``px``, each row with its type in ``filters`` (0-4): ``(h, 1 +
    row_bytes)`` bytes, the filter type first."""
    x = px.astype(np.int32)
    h = x.shape[0]
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    filters = np.asarray(filters, np.int64)
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = (x - preds[filters, np.arange(h)]) & 255
    return out


def write_png(path: str, img: np.ndarray, filters=None, level: int = 6):
    """Write an ``(h, w)`` gray or ``(h, w, c)`` uint8 image (c = 2 gray +
    alpha, 3 RGB, 4 RGBA) as an 8-bit PNG.  ``filters``: each row's filter
    type (0-4); by default row ``y`` takes ``y % 5``, so every type is
    used."""
    import struct
    import zlib

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if filters is None:
        filters = np.arange(h) % 5
    raw = png_filter_rows(img.reshape(h, w * ch), filters, ch)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))

    data = (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8,
                                         _PNG_COLOR[ch], 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
            + chunk(b'IEND', b''))
    with open(path, 'wb') as f:
        f.write(data)
