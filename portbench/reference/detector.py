"""The ImVoxelNet detector, plain PyTorch: backbone -> FPN ->
backprojection -> 3D neck -> head, its test-time decode and its training
loss, for the outdoor (``head_kind='anchor3d'``, KITTI neck) and indoor
(``head_kind='indoor'``, the v1 ImVoxelNeck) models.

A frozen copy of the port's plain model code with the kernels, the
deformable backbone, the layout head and the process groups left out.  It
imports nothing of the port.  Parameter names are the reference's mmdet
``state_dict`` keys, as the port's are, so one ``state_dict`` loads into
both.

The benchmark's default reference module (``spec.reference``): with the
model, its decode and its loss, it hands out the training step of
``train.py`` and its part of the weights' scheme (``init_overrides``).  A
configuration that needs another model names a module of its own, which
may build on this one.

Batch layout:
  images      (B, V, H, W, 3)   normalized, padded
  intrinsics  (B, 3, 3)
  extrinsics  (B, V, 4, 4)
  origins     (B, 3)
  img_shape   (B, 2) int        resized (pre-pad) image (h, w)
  ratios      (B,) float        ori_h / (img_h / stride)
and for training
  gt_boxes    (B, G, 7)         padded GT boxes, bottom center
  gt_labels   (B, G) int
  gt_mask     (B, G) bool
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from . import anchor3d_head as a3d
from . import backproject as bp
from . import fpn as fpn_lib
from . import imvoxel_heads as ivh
from . import necks3d
from . import resnet as resnet_lib
from .target_assign import AssignerConfig
from .train import make_optimizer, make_train_step, param_label  # noqa: F401

CLS_BIAS_INIT = -4.59511985013459   # -log((1 - 0.01) / 0.01)


@dataclasses.dataclass(frozen=True)
class NeckConfig:
    kind: str = 'kitti'            # kitti | imvoxel
    in_channels: int = 64
    out_channels: int = 256
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    down_layers: Tuple[int, ...] = (1, 2, 3, 4)
    up_layers: Tuple[int, ...] = (3, 2, 1)
    n_blocks: Tuple[int, ...] = (1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ImVoxelNetConfig:
    n_voxels: Tuple[int, int, int] = (216, 248, 12)
    voxel_size: Tuple[float, float, float] = (0.32, 0.32, 0.32)
    fpn_out_channels: int = 64
    neck: NeckConfig = NeckConfig()
    head_kind: str = 'anchor3d'    # anchor3d | indoor
    anchor_head: Optional[a3d.Anchor3DHeadConfig] = None
    indoor_head: Optional[ivh.IndoorHeadConfig] = None
    stride: int = 4
    compute_dtype: str = 'float32'
    backbone_stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)


def _tuples(x):
    """JSON lists back to the tuples the frozen dataclasses hold."""
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return x


def config_from_dict(d: dict) -> ImVoxelNetConfig:
    """An :class:`ImVoxelNetConfig` from a configuration file's ``model``
    object.  Keys of paths the reference does not hold (the port's layout
    head, loss normalization over ranks, deformable stages, view sharding,
    the axis-aligned KITTI NMS, and every indoor head but SUN RGB-D's v1
    with no tower, no centerness top-k and the exact NMS) must be at the
    values the benchmark's configurations give them; any other unknown key
    is an error."""
    def held(group, values):
        for key, value in values.items():
            got = group.pop(key, value)
            if got != value:
                raise ValueError(f'the reference runs {key}={value!r} '
                                 f'alone, not {got!r}')

    d = {k: _tuples(v) for k, v in d.items()}
    held(d, dict(layout_head=None, dp_loss_norm='per_image',
                 view_shard_axis=None,
                 stage_with_dcn=(False, False, False, False)))
    neck = NeckConfig(**d.pop('neck'))
    anchor = d.pop('anchor_head', None)
    if anchor is not None:
        held(anchor, dict(use_rotate_nms=True))
        anchor = a3d.Anchor3DHeadConfig(**dict(
            anchor, assigner=AssignerConfig(**anchor['assigner'])))
    indoor = d.pop('indoor_head', None)
    if indoor is not None:
        indoor.pop('limit', None)                  # the v2 head's alone
        held(indoor, dict(dataset='sunrgbd', version=1, n_convs=0,
                          centerness_topk=-1, pre_nms_k=0))
        indoor = ivh.IndoorHeadConfig(**indoor)
    return ImVoxelNetConfig(neck=neck, anchor_head=anchor,
                            indoor_head=indoor, **d)


def build_neck(cfg: NeckConfig) -> nn.Module:
    if cfg.kind == 'kitti':
        return necks3d.KittiImVoxelNeck(cfg.in_channels, cfg.out_channels)
    if cfg.kind == 'imvoxel':
        return necks3d.ImVoxelNeck(cfg.channels, cfg.out_channels,
                                   cfg.down_layers, cfg.up_layers)
    raise ValueError(f'the reference has no neck {cfg.kind!r}')


class ImVoxelNet(nn.Module):
    """The detector; ``forward(batch)`` -> ``(head_outs, valid)``: the
    head's float32 channel-last outputs and the ``(B, nx, ny, nz)`` bool
    mask of voxels seen by at least one view."""

    def __init__(self, cfg: ImVoxelNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = resnet_lib.ResNet(tuple(cfg.backbone_stage_blocks))
        self.neck = fpn_lib.FPN(out_channels=cfg.fpn_out_channels)
        self.neck_3d = build_neck(cfg.neck)
        if cfg.head_kind == 'anchor3d':
            self.bbox_head = a3d.Anchor3DHead(cfg.anchor_head,
                                              cfg.neck.out_channels)
        elif cfg.head_kind == 'indoor':
            self.bbox_head = ivh.IndoorHead(cfg.indoor_head,
                                            cfg.neck.out_channels)
        else:
            raise ValueError(f'the reference has no head {cfg.head_kind!r}')

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def forward(self, batch):
        cfg = self.cfg
        images = batch['images']
        b, v, h, w, _ = images.shape
        x = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).to(self.dtype)
        c = self.backbone(x)
        x = self.neck(c)[0]
        hf, wf = x.shape[2:]
        if h // hf != cfg.stride:
            raise ValueError(f'feature stride {h // hf} != {cfg.stride}')
        feats = x.permute(0, 2, 3, 1).reshape(b, v, hf, wf, -1)
        nx, ny, nz = cfg.n_voxels
        projections = bp.compute_projection(
            batch['intrinsics'], batch['extrinsics'], batch['ratios'])
        points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                               batch['origins']).reshape(b, -1, 3)
        valid_hw = (batch['img_shape'] // cfg.stride).to(torch.int32)
        acc, cnt = bp.backproject_batch(feats, points, projections, valid_hw)
        vol, seen = bp.mean_pool_from_sums(acc, cnt, n_views=v)
        volume = vol.view(nx, ny, nz, b, -1).permute(3, 4, 0, 1, 2)
        valid = seen.view(nx, ny, nz, b).permute(3, 0, 1, 2)
        head_outs = self.bbox_head(self.neck_3d(volume.to(self.dtype)))
        return head_outs, valid

    def loss(self, head_outs, batch, valid=None):
        """The training losses of this forward's outputs
        (:func:`imvoxelnet_loss`)."""
        return imvoxelnet_loss(self.cfg, head_outs, batch, valid)


def imvoxelnet_predict(cfg: ImVoxelNetConfig, head_outs, valid=None,
                       origins=None):
    """Test-time detections, fixed-shape: ``boxes``, ``scores``,
    ``labels`` and ``valid``."""
    if cfg.head_kind == 'anchor3d':
        return a3d.anchor3d_head_get_bboxes(head_outs, cfg.anchor_head)
    return ivh.indoor_head_get_bboxes(head_outs, valid, origins,
                                      cfg.indoor_head)


def imvoxelnet_loss(cfg: ImVoxelNetConfig, head_outs, batch, valid=None):
    """Training losses, a dict of scalars: ``loss_cls``, ``loss_bbox`` and
    ``loss_dir`` (KITTI) or ``loss_centerness``, ``loss_bbox`` and
    ``loss_cls`` (indoor)."""
    if cfg.head_kind == 'anchor3d':
        return a3d.anchor3d_head_loss(head_outs, batch['gt_boxes'],
                                      batch['gt_labels'], batch['gt_mask'],
                                      cfg.anchor_head)
    return ivh.indoor_head_loss(head_outs, valid, batch['origins'],
                                batch['gt_boxes'], batch['gt_labels'],
                                batch['gt_mask'], cfg.indoor_head)


def init_overrides(model: ImVoxelNet, serve: bool) -> dict:
    """The head's entries of the weights' scheme (``weights.py``), as
    ``{name: ('normal', std) | ('fill', value)}``: normal(0.01) for the
    anchor head's class and box convs and for every conv of the indoor
    head; the class conv's bias at 0 serving (every score near 0.5, above
    the score threshold, so that decode and NMS see full candidate sets, as
    the port's ``tools/profile_forward.py:zero_cls_bias`` does) and at
    ``-log(99)`` training."""
    head = model.bbox_head
    if isinstance(head, a3d.Anchor3DHead):
        small, cls_conv = [head.conv_cls, head.conv_reg], head.conv_cls
    else:
        small = [m for m in head.modules() if isinstance(m, nn.Conv3d)]
        cls_conv = head.cls_conv
    names = {m: n for n, m in model.named_modules()}
    plan = {names[m] + '.weight': ('normal', 0.01) for m in small}
    plan[names[cls_conv] + '.bias'] = ('fill',
                                       0.0 if serve else CLS_BIAS_INIT)
    return plan
