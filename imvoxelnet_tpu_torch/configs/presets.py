"""Named presets of the port: ``imvoxelnet_kitti`` and ``tiny_kitti_test``.

Counterpart of ``imvoxelnet_tpu/configs/presets.py``; the other presets come
with their model families.  Field values equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.target_assign import AssignerConfig
from ..models.detector import ImVoxelNetConfig, NeckConfig
from ..models.heads.anchor3d_head import Anchor3DHeadConfig

KITTI_CLASSES = ('Car',)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str                       # kitti | sunrgbd | scannet | nuscenes
    classes: Tuple[str, ...]
    n_images_train: int = 1
    n_images_test: int = 1
    samples_per_device: int = 4
    repeat_times: int = 3
    train_size: Tuple[int, int] = (1280, 384)   # padded (W, H)
    test_size: Tuple[int, int] = (1280, 384)
    # multiscale 'range' train resize ((long0, short0), (long1, short1));
    # None -> keep-ratio resize to test_size
    train_scales: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
    flip_ratio: float = 0.0
    max_gt: int = 32                   # padded GT boxes per sample
    box_origin: str = 'bottom'


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    model: ImVoxelNetConfig
    data: DataConfig
    lr: float = 1e-4
    weight_decay: float = 1e-4
    backbone_lr_mult: float = 0.1
    grad_clip_norm: float = 35.0
    lr_steps: Tuple[int, ...] = (8, 11)
    total_epochs: int = 12


def build_presets():
    presets = {}

    # --- KITTI monocular car (imvoxelnet_kitti.py)
    kitti_head = Anchor3DHeadConfig(
        num_classes=1, feat_channels=256,
        anchor_ranges=((0, -39.68, -1.78, 69.12 - .32, 39.68 - .32, -1.78),),
        anchor_sizes=((1.6, 3.9, 1.56),), anchor_rotations=(0.0, 1.57),
        dir_offset=0.0, dir_limit_offset=1.0,
        loss_bbox_weight=2.0,
        assigner=AssignerConfig(0.6, 0.45, 0.45),
        nms_pre=100, score_thr=0.1, iou_thr=0.01, max_out=50)
    presets['imvoxelnet_kitti'] = Preset(
        name='imvoxelnet_kitti',
        model=ImVoxelNetConfig(
            n_voxels=(216, 248, 12), voxel_size=(.32, .32, .32),
            fpn_out_channels=64,
            neck=NeckConfig(kind='kitti', in_channels=64, out_channels=256),
            head_kind='anchor3d', anchor_head=kitti_head),
        data=DataConfig(dataset='kitti', classes=KITTI_CLASSES,
                        samples_per_device=4, repeat_times=3,
                        train_size=(1408, 416), test_size=(1280, 384),
                        train_scales=((1173, 352), (1387, 416)),
                        flip_ratio=0.5,
                        max_gt=16))

    # --- tiny smoke-test preset (not one of the reference configs): the
    # real structure at toy sizes, for tests on the CPU
    tiny_head = Anchor3DHeadConfig(
        num_classes=1,
        anchor_ranges=((0, -12.8, -1.78, 25.6, 12.8, -1.78),),
        nms_pre=64, max_out=8)
    presets['tiny_kitti_test'] = Preset(
        name='tiny_kitti_test',
        model=ImVoxelNetConfig(
            n_voxels=(32, 40, 12), voxel_size=(.8, .64, .32),
            fpn_out_channels=16,
            neck=NeckConfig(kind='kitti', in_channels=16, out_channels=32),
            head_kind='anchor3d', anchor_head=tiny_head),
        data=DataConfig(dataset='kitti', classes=('Pedestrian', 'Car'),
                        samples_per_device=2, repeat_times=2,
                        train_size=(320, 96), test_size=(320, 96),
                        max_gt=8))
    return presets


PRESETS = build_presets()


def get_preset(name: str) -> Preset:
    return PRESETS[name]
