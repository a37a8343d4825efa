"""Named presets of the port: ``imvoxelnet_kitti``, ``imvoxelnet_nuscenes``,
``tiny_kitti_test``, the SUN RGB-D votenet, perspective and Total3D families
(``imvoxelnet_sunrgbd``, ``_top27``, ``_fast`` and the same three of
``imvoxelnet_perspective_sunrgbd`` and ``imvoxelnet_total_sunrgbd``) and the
multi-view ScanNet family (``imvoxelnet_scannet``, ``_top27``, ``_fast``).

Counterpart of ``imvoxelnet_tpu/configs/presets.py``, all 14 presets and
``tiny_kitti_test``.  Field values equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..core.target_assign import AssignerConfig
from ..models.detector import ImVoxelNetConfig, NeckConfig
from ..models.heads.anchor3d_head import Anchor3DHeadConfig
from ..models.heads.imvoxel_heads import IndoorHeadConfig
from ..models.heads.layout_head import LayoutHeadConfig

KITTI_CLASSES = ('Car',)
SUNRGBD_VOTENET_CLASSES = (
    'bed', 'table', 'sofa', 'chair', 'toilet', 'desk', 'dresser',
    'night_stand', 'bookshelf', 'bathtub')
# PerspectiveNet benchmark, 30 classes (sunrgbd_data_utils.py:75-81)
SUNRGBD_PERSPECTIVE_CLASSES = (
    'recycle_bin', 'cpu', 'paper', 'toilet', 'stool', 'whiteboard',
    'coffee_table', 'picture', 'keyboard', 'dresser', 'painting', 'bookshelf',
    'night_stand', 'endtable', 'drawer', 'sink', 'monitor', 'computer',
    'cabinet', 'shelf', 'lamp', 'garbage_bin', 'box', 'bed', 'sofa',
    'sofa_chair', 'pillow', 'desk', 'table', 'chair')
SCANNET_CLASSES = (
    'cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window', 'bookshelf',
    'picture', 'counter', 'desk', 'curtain', 'refrigerator', 'showercurtrain',
    'toilet', 'sink', 'bathtub', 'garbagebin')
# Total3DUnderstanding benchmark: 33 trained (+layout) of 37 reported
TOTAL_SUNRGBD_CLASSES = (
    'cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window', 'bookshelf',
    'picture', 'counter', 'blinds', 'desk', 'shelves', 'curtain', 'dresser',
    'pillow', 'mirror', 'clothes', 'books', 'fridge', 'tv', 'paper', 'towel',
    'shower_curtain', 'box', 'whiteboard', 'person', 'night_stand', 'toilet',
    'sink', 'lamp', 'bathtub', 'bag')
NUSCENES_CLASSES = ('car',)


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


def _indoor_model(n_classes, fast: bool, topk: int, n_voxels, voxel_size,
                  dataset: str, layout: bool = False,
                  score_thr: float = 0.05, fast_score_thr: float = 0.0,
                  fast_iou_thr: float = 0.15,
                  regress_ranges=None) -> ImVoxelNetConfig:
    """An indoor model of ``dataset`` (``'sunrgbd'``, 7 regression outputs
    with yaw, or ``'scannet'``, 6): v1 (ImVoxelNeck, head v1) or ``fast``
    (the fast neck, head v2); ``layout`` adds Total3D's layout head."""
    n_reg_outs = 7 if dataset == 'sunrgbd' else 6
    if fast:
        neck = NeckConfig(kind='fast', in_channels=256, out_channels=128,
                          n_blocks=(1, 1, 1))
        head = IndoorHeadConfig(
            n_classes=n_classes, n_reg_outs=n_reg_outs, voxel_size=voxel_size,
            dataset=dataset, version=2, centerness_topk=18, limit=27,
            nms_pre=1000, score_thr=fast_score_thr, iou_thr=fast_iou_thr)
        fpn_out = 256
    else:
        neck = NeckConfig(kind='imvoxel', channels=(64, 128, 256, 512),
                          out_channels=64, down_layers=(1, 2, 3, 4),
                          up_layers=(3, 2, 1))
        extra = {} if regress_ranges is None else dict(
            regress_ranges=regress_ranges)
        head = IndoorHeadConfig(
            n_classes=n_classes, n_reg_outs=n_reg_outs, voxel_size=voxel_size,
            dataset=dataset, version=1, n_convs=0, centerness_topk=topk,
            nms_pre=1000, score_thr=(0.0 if topk > 0 else score_thr),
            iou_thr=0.15, **extra)
        fpn_out = 64
    return ImVoxelNetConfig(
        n_voxels=n_voxels, voxel_size=voxel_size, fpn_out_channels=fpn_out,
        neck=neck, head_kind='indoor', anchor_head=None, indoor_head=head,
        layout_head=LayoutHeadConfig() if layout else None)


def _sunrgbd_family(prefix, classes, layout=False, fast_score_thr=0.0,
                    repeat_times=2, top27_regress_ranges=None):
    """The v1 / top27 / fast triple of a SUN RGB-D benchmark.

    ``repeat_times``: 2 for the votenet and perspective benchmarks
    (``imvoxelnet_sunrgbd.py:76``), 1 for Total3D
    (``imvoxelnet_total_sunrgbd.py:85``), whose data come flipped already
    (``flip_ratio`` 0).  ``top27_regress_ranges``: the Total3D ``_top27``
    head's regress ranges (``imvoxelnet_total_sunrgbd_top27.py:39``).
    """
    presets = {}
    common = dict(dataset='sunrgbd', classes=classes, samples_per_device=4,
                  repeat_times=repeat_times,
                  train_size=(768, 576), test_size=(640, 480),
                  train_scales=((512, 384), (768, 576)),
                  flip_ratio=0.0 if layout else 0.5, max_gt=64)
    for suffix, fast, topk, nvox, vsize in (
            ('', False, -1, (80, 80, 32), (.08, .08, .08)),
            ('_top27', False, 28, (80, 80, 32), (.08, .08, .08)),
            ('_fast', True, 18, (40, 40, 16), (.16, .16, .16))):
        name = prefix + suffix
        presets[name] = Preset(
            name=name,
            model=_indoor_model(
                len(classes), fast, topk, nvox, vsize, 'sunrgbd',
                layout=layout, fast_score_thr=fast_score_thr,
                regress_ranges=(top27_regress_ranges
                                if suffix == '_top27' else None)),
            data=DataConfig(**common))
    return presets


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

    # --- nuScenes 6-camera car (imvoxelnet_nuscenes.py; DCNv2 stages 3-4)
    nus_head = Anchor3DHeadConfig(
        num_classes=1, feat_channels=256,
        anchor_ranges=((-49.92, -49.92, -1.0, 49.92 - .64, 49.92 - .64,
                        -1.0),),
        anchor_sizes=((1.98, 4.67, 1.74),), anchor_rotations=(0.0, 1.57),
        dir_offset=0.7854, dir_limit_offset=0.0,
        loss_bbox_weight=1.0,
        assigner=AssignerConfig(0.6, 0.3, 0.3),
        nms_pre=1000, score_thr=0.05, iou_thr=0.2, max_out=500)
    presets['imvoxelnet_nuscenes'] = Preset(
        name='imvoxelnet_nuscenes',
        model=ImVoxelNetConfig(
            n_voxels=(312, 312, 12), voxel_size=(.32, .32, .32),
            fpn_out_channels=64,
            neck=NeckConfig(kind='nuscenes', in_channels=64,
                            out_channels=256),
            head_kind='anchor3d', anchor_head=nus_head,
            stage_with_dcn=(False, False, True, True)),
        data=DataConfig(dataset='nuscenes', classes=NUSCENES_CLASSES,
                        n_images_train=6, n_images_test=6,
                        samples_per_device=1, repeat_times=1,
                        train_size=(1600, 928), test_size=(1600, 928),
                        max_gt=64))

    # --- SUN RGB-D families
    presets.update(_sunrgbd_family('imvoxelnet_sunrgbd',
                                   SUNRGBD_VOTENET_CLASSES))
    # perspective _fast uses score_thr .01
    # (imvoxelnet_perspective_sunrgbd_fast.py test_cfg)
    presets.update(_sunrgbd_family('imvoxelnet_perspective_sunrgbd',
                                   SUNRGBD_PERSPECTIVE_CLASSES,
                                   fast_score_thr=0.01))
    presets.update(_sunrgbd_family(
        'imvoxelnet_total_sunrgbd', TOTAL_SUNRGBD_CLASSES, layout=True,
        repeat_times=1,
        top27_regress_ranges=((-1e8, .6), (.4, 1.1), (0.9, 1e8))))

    # --- ScanNet multi-view (imvoxelnet_scannet.py + variants): 20 views in
    # training, 50 at test; repeat_times=3 (imvoxelnet_scannet.py:81)
    scan_common = dict(dataset='scannet', classes=SCANNET_CLASSES,
                       n_images_train=20, n_images_test=50,
                       samples_per_device=1, repeat_times=3,
                       train_size=(640, 480), test_size=(640, 480),
                       max_gt=64)
    for suffix, fast, topk, nvox, vsize in (
            ('', False, -1, (80, 80, 32), (.08, .08, .08)),
            ('_top27', False, 28, (80, 80, 32), (.08, .08, .08)),
            ('_fast', True, 18, (40, 40, 16), (.16, .16, .16))):
        name = 'imvoxelnet_scannet' + suffix
        # scannet_fast test_cfg: iou_thr .25, score_thr .01
        presets[name] = Preset(
            name=name,
            model=_indoor_model(len(SCANNET_CLASSES), fast, topk, nvox, vsize,
                                'scannet', score_thr=0.0,
                                fast_score_thr=0.01, fast_iou_thr=0.25),
            data=DataConfig(**scan_common))

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
