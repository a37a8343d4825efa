"""Numpy data pipeline: ``MultiViewPipeline`` and friends
(``mmdet3d/datasets/pipelines/multi_view.py``) plus the mmdet 2D transforms
it composes (LoadImageFromFile / RandomFlip / Resize / Normalize / Pad), on
the host.  The output is a fixed-shape sample (padded images, padded GT and
masks).

Counterpart of ``imvoxelnet_tpu/data/pipeline.py``: the same functions, the
same ``RandomState`` draws in the same order, and bit-identical images.
Decoding and the resize come from ``data/image_io.py`` (no ``cv2`` for PNG
files), normalize + pad from the native fused pass (``native/image_ops.cc``,
which raises where it cannot be built); :func:`normalize` and
:func:`pad_to` are its plain version.

Key mmdet semantics reproduced:
  - keep-ratio resize: ``scale_factor = min(max_long/long, max_short/short)``
  - 'range' multiscale: sample long/short edge uniformly between the two
    given scales (``imvoxelnet_kitti.py:82-86``)
  - Normalize: BGR->RGB then (x - mean) / std
  - Pad: to divisor 32 or a fixed size, zero fill
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native
from .image_io import imresize, load_image  # noqa: F401  (the pipeline's)

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def keep_ratio_scale(hw: Tuple[int, int], scale: Tuple[int, int]) -> float:
    """mmdet ``rescale_size``: scale=(max_long, max_short)."""
    h, w = hw
    max_long, max_short = max(scale), min(scale)
    return min(max_long / max(h, w), max_short / min(h, w))


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    return (img.astype(np.float32) - mean) / std


def pad_to(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    ph, pw = size_hw
    assert ph >= h and pw >= w, (img.shape, size_hw)
    out = np.zeros((ph, pw) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    return out


@dataclasses.dataclass
class ImagePipelineConfig:
    test_scale: Tuple[int, int] = (1280, 384)       # (W, H) like the configs
    train_scales: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
    pad_size: Tuple[int, int] = (384, 1280)          # fixed (H, W) test output
    train_pad_size: Optional[Tuple[int, int]] = None  # defaults to pad_size
    flip_ratio: float = 0.0
    fixed_size_resize: bool = False                  # ScanNet: exact 640x480


def process_image(img: np.ndarray, cfg: ImagePipelineConfig, train: bool,
                  rng: np.random.RandomState):
    """Resize(+flip)+normalize+pad one image.

    Returns (padded_img, info) where info has ``img_shape`` (resized, pre-pad),
    ``ori_shape``, ``scale_factor``, ``flip``.
    """
    ori_shape = img.shape[:2]
    flip = bool(train and cfg.flip_ratio > 0 and rng.rand() < cfg.flip_ratio)
    if flip:
        img = img[:, ::-1]

    if cfg.fixed_size_resize:
        # ScanNet keeps 640x480 inputs as-is (Resize keep_ratio with equal
        # scale is identity for 640x480 frames)
        factor = keep_ratio_scale(ori_shape, cfg.test_scale)
    elif train and cfg.train_scales is not None:
        (l0, s0), (l1, s1) = cfg.train_scales
        long_edge = rng.randint(min(l0, l1), max(l0, l1) + 1)
        short_edge = rng.randint(min(s0, s1), max(s0, s1) + 1)
        factor = keep_ratio_scale(ori_shape, (long_edge, short_edge))
    else:
        factor = keep_ratio_scale(ori_shape, cfg.test_scale)

    img = imresize(img, factor)
    img_shape = img.shape[:2]
    pad_size = (cfg.train_pad_size or cfg.pad_size) if train else cfg.pad_size
    # fused native normalize + pad: one u8 -> f32 pass, the interpreter lock
    # released; bit-identical to pad_to(normalize(img), pad_size)
    img = native.normalize_pad_u8(img, IMAGENET_MEAN, IMAGENET_STD, pad_size)
    info = dict(ori_shape=ori_shape, img_shape=img_shape,
                scale_factor=factor, flip=flip)
    return img, info


# ---------------------------------------------------------------------------
# Geometric per-dataset transforms (``pipelines/multi_view.py:35-124``)
# ---------------------------------------------------------------------------

def kitti_set_origin(point_cloud_range):
    pcr = np.asarray(point_cloud_range, np.float32)
    return (pcr[:3] + pcr[3:]) / 2.0


def kitti_random_flip(intrinsic, extrinsic, boxes, ori_shape):
    """Flip conjugation for KITTI (``multi_view.py:57-78``): cx mirror on the
    intrinsics, X/Y flip conjugation on the extrinsic, alpha-preserving yaw
    recomputation on the boxes.  Returns updated (intrinsic, extrinsic, boxes).
    """
    intrinsic = intrinsic.copy()
    intrinsic[0, 2] = -intrinsic[0, 2] + ori_shape[1]
    f0 = np.eye(4, dtype=np.float32)
    f0[0, 0] = -1
    f1 = np.eye(4, dtype=np.float32)
    f1[1, 1] = -1
    extrinsic = f0 @ extrinsic @ f1.T
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        center = boxes[:, :3]
        alpha = boxes[:, 6]
        phi = np.arctan2(center[:, 0], -center[:, 1]) - alpha
        center[:, 1] *= -1
        boxes[:, 6] = np.arctan2(center[:, 0], -center[:, 1]) + phi
        boxes[:, :3] = center
    return intrinsic, extrinsic, boxes


def sunrgbd_random_flip(extrinsic, boxes):
    """SUN RGB-D flip (``multi_view.py:109-124``)."""
    flip = np.eye(3, dtype=np.float32)
    flip[0, 0] = -1
    extrinsic = extrinsic.copy()
    extrinsic[:3, :3] = flip @ extrinsic[:3, :3] @ flip.T
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        center = boxes[:, :3]
        alpha = boxes[:, 6]
        phi = np.arctan2(center[:, 1], center[:, 0]) - alpha
        center_flip = center @ flip
        boxes[:, 6] = np.arctan2(center_flip[:, 1], center_flip[:, 0]) + phi
        boxes[:, :3] = center_flip
    return extrinsic, boxes


def sunrgbd_set_origin(intrinsic, extrinsic, ori_shape):
    """Origin from the back-projected image center x3 (``multi_view.py:82-92``)."""
    projection = intrinsic[:3, :3] @ extrinsic[:3, :3]
    h, w = ori_shape[:2]
    center = np.array([w / 2, h / 2, 1], np.float32) * 3.0
    return np.linalg.inv(projection) @ center


def random_shift_origin(origin, std, rng):
    """Gaussian origin jitter, ScanNet train (``multi_view.py:35-42``)."""
    return origin + rng.normal(0.0, np.asarray(std, np.float64), 3).astype(
        np.float32)


def object_range_filter(boxes, labels, point_cloud_range, limit_yaw=True):
    """BEV-range GT filter + yaw limiting (``transforms_3d.py:469-511``)."""
    if boxes is None or len(boxes) == 0:
        return boxes, labels
    bev_range = np.asarray(point_cloud_range, np.float32)[[0, 1, 3, 4]]
    mask = ((boxes[:, 0] > bev_range[0]) & (boxes[:, 1] > bev_range[1])
            & (boxes[:, 0] < bev_range[2]) & (boxes[:, 1] < bev_range[3]))
    boxes = boxes[mask].copy()
    labels = labels[mask]
    if limit_yaw and len(boxes):
        # limit_period(yaw, 0.5, 2*pi)
        yaw = boxes[:, 6]
        boxes[:, 6] = yaw - np.floor(yaw / (2 * np.pi) + 0.5) * 2 * np.pi
    return boxes, labels


def pad_gt(boxes, labels, max_gt: int):
    """Pad GT to fixed shape + mask."""
    g = 0 if boxes is None else len(boxes)
    g = min(g, max_gt)
    out_boxes = np.zeros((max_gt, 7), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_mask = np.zeros((max_gt,), bool)
    if g:
        out_boxes[:g] = boxes[:g, :7]
        out_labels[:g] = labels[:g]
        out_mask[:g] = True
    return out_boxes, out_labels, out_mask
