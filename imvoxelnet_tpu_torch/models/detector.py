"""The ImVoxelNet detector: backbone -> FPN -> backprojection -> 3D neck ->
head, its test-time decode (``simple_test``) and its training loss.

Counterpart of ``imvoxelnet_tpu/models/detector.py`` (``ImVoxelNetConfig``,
``NeckConfig``, ``ImVoxelNet``, ``imvoxelnet_predict``, ``imvoxelnet_loss``)
for the outdoor configurations (``head_kind='anchor3d'``, ``neck.kind``
``'kitti'`` or ``'nuscenes'``, the latter with DCNv2 in the backbone's
stages 3-4) and the indoor ones (``head_kind='indoor'``, ``neck.kind``
``'imvoxel'`` or ``'fast'``): SUN RGB-D, Total3D (with the layout head
``head_2d``) and multi-view ScanNet; forward, decode and training loss.  ``model.train()``
is the JAX ``train=True``: the 3D neck's batch norms use batch statistics
and update their running ones; the backbone's ``FrozenBatchNorm`` ignores
the mode.

Batch layout, as in the JAX package (all tensors on one device):
  images      (B, V, H, W, 3)   normalized, padded
  intrinsics  (B, 3, 3)
  extrinsics  (B, V, 4, 4)
  origins     (B, 3)
  img_shape   (B, 2) int        resized (pre-pad) image (h, w)
  ratios      (B,) float        ori_h / (img_h / stride)  (imvoxelnet.py:118)
and for training
  gt_boxes    (B, G, 7)         padded GT boxes, bottom center
  gt_labels   (B, G) int
  gt_mask     (B, G) bool
  gt_angles   (B, 2), gt_layout (B, 7)   (Total3D only)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import backproject as bp
from ..parallel import mesh
from ..utils.tracing import span
from . import fpn as fpn_lib
from . import necks3d
from . import resnet as resnet_lib
from .dcn import DeformConv2d
from .heads import anchor3d_head as a3d
from .heads import imvoxel_heads as ivh
from .heads import layout_head as lh
from .layers import lecun_normal_


@dataclasses.dataclass(frozen=True)
class NeckConfig:
    kind: str = 'kitti'            # kitti | nuscenes | imvoxel | fast
    in_channels: int = 64
    out_channels: int = 256
    # imvoxel neck
    channels: Tuple[int, ...] = (64, 128, 256, 512)
    down_layers: Tuple[int, ...] = (1, 2, 3, 4)
    up_layers: Tuple[int, ...] = (3, 2, 1)
    # fast neck
    n_blocks: Tuple[int, ...] = (1, 1, 1)


@dataclasses.dataclass(frozen=True)
class ImVoxelNetConfig:
    n_voxels: Tuple[int, int, int] = (216, 248, 12)
    voxel_size: Tuple[float, float, float] = (0.32, 0.32, 0.32)
    fpn_out_channels: int = 64
    neck: NeckConfig = NeckConfig()
    head_kind: str = 'anchor3d'    # anchor3d | indoor
    anchor_head: Optional[a3d.Anchor3DHeadConfig] = a3d.Anchor3DHeadConfig()
    indoor_head: Optional[ivh.IndoorHeadConfig] = None
    layout_head: Optional[lh.LayoutHeadConfig] = None
    # the indoor loss's positive-count normalization: 'per_image' (each
    # image by its own count, the reference's reduce_mean on one card) or
    # 'batch_mean' (every image by the global batch's mean count, the JAX
    # package's multi-device choice; tools/train.py picks it for indoor
    # runs over several ranks)
    dp_loss_norm: str = 'per_image'
    stride: int = 4                 # asserted == 4 in the reference
    compute_dtype: str = 'float32'  # conv-path dtype: float32 | bfloat16
    # backbone stages whose conv2 is DCNv2 (nuScenes: stages 3-4)
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)
    # Bottlenecks per stage; (3, 4, 6, 3) = ResNet-50.
    backbone_stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    # When set, the forward runs on this rank's slice of the views (the
    # default process group's ranks split them): backbone, FPN and the
    # backprojection on the local views, the per-voxel (sum, count) pair
    # summed over the ranks, the 3D neck and the head replicated on the
    # pooled volume.  See parallel/mesh.py:view_sharded_forward.
    view_shard_axis: Optional[str] = None


def build_neck(cfg: NeckConfig) -> nn.Module:
    if cfg.kind == 'kitti':
        return necks3d.KittiImVoxelNeck(cfg.in_channels, cfg.out_channels)
    if cfg.kind == 'nuscenes':
        return necks3d.NuScenesImVoxelNeck(cfg.in_channels, cfg.out_channels)
    if cfg.kind == 'imvoxel':
        return necks3d.ImVoxelNeck(cfg.channels, cfg.out_channels,
                                   cfg.down_layers, cfg.up_layers)
    if cfg.kind == 'fast':
        return necks3d.FastIndoorImVoxelNeck(cfg.in_channels, cfg.n_blocks,
                                             cfg.out_channels)
    raise ValueError(f'unknown neck {cfg.kind!r}')


class ImVoxelNet(nn.Module):
    """Parameters carry the reference's mmdet ``state_dict`` names
    (``backbone.*``, ``neck.*``, ``neck_3d.*``, ``bbox_head.*``, and
    ``head_2d.*`` for a layout head).

    The module sets no precision flag of its own: run a ``'float32'`` model
    inside ``utils.precision.compute_precision(cfg.compute_dtype)`` (the
    train step and the tools do) so that its cuDNN convolutions and matmuls
    compute in full float32 rather than TF32 on the card.
    """

    def __init__(self, cfg: ImVoxelNetConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = resnet_lib.ResNet(tuple(cfg.backbone_stage_blocks),
                                          stage_with_dcn=cfg.stage_with_dcn)
        if cfg.layout_head is not None:
            self.head_2d = lh.LayoutHead(cfg.layout_head)
        self.neck = fpn_lib.FPN(out_channels=cfg.fpn_out_channels)
        self.neck_3d = build_neck(cfg.neck)
        if cfg.head_kind == 'anchor3d':
            self.bbox_head = a3d.Anchor3DHead(cfg.anchor_head,
                                              cfg.neck.out_channels)
        elif cfg.head_kind == 'indoor':
            self.bbox_head = ivh.IndoorHead(cfg.indoor_head,
                                            cfg.neck.out_channels)
        else:
            raise NotImplementedError(f'head {cfg.head_kind!r} is not ported')

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    @span('forward')
    def forward(self, batch, use_predicted_extrinsics: bool = False):
        """Returns ``(head_outs, valid)``: the head's float32 channel-last
        outputs (KITTI: ``(cls_score, bbox_pred, dir_pred)`` maps; indoor:
        ``(centernesses, bbox_preds, cls_scores)`` level lists) and the
        ``(B, nx, ny, nz)`` bool mask of voxels seen by at least one view.
        With a layout head: ``(head_outs, valid, features_2d)``, where
        ``features_2d`` is the head's ``(angles, layout)`` from view 0's
        C5 features.

        ``use_predicted_extrinsics`` (the reference's test-time switch,
        ``imvoxelnet.py:59-61, 120-126``): with a layout head, every view
        is projected with the extrinsic built from the predicted pitch and
        roll instead of ``batch['extrinsics']``."""
        cfg = self.cfg
        images = batch['images']
        b, v, h, w, _ = images.shape
        with span('backbone_fpn'):
            # NHWC images viewed as NCHW: channels_last memory, no copy
            x = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).to(
                self.dtype)
            c = self.backbone(x)
            features_2d = None
            if cfg.layout_head is not None:
                c5 = c[-1].reshape((b, v) + c[-1].shape[1:])[:, 0]
                features_2d = self.head_2d(c5)
            x = self.neck(c)[0]
        hf, wf = x.shape[2:]
        if h // hf != cfg.stride:
            raise ValueError(f'feature stride {h // hf} != {cfg.stride}')

        nx, ny, nz = cfg.n_voxels
        with span('backproject'):
            feats = x.permute(0, 2, 3, 1).reshape(b, v, hf, wf, -1)
            extrinsics = batch['extrinsics']
            if use_predicted_extrinsics and features_2d is not None:
                extrinsics = lh.predicted_extrinsics(features_2d[0])[
                    :, None].expand(extrinsics.shape)
            projections = bp.compute_projection(
                batch['intrinsics'], extrinsics, batch['ratios'])
            points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                                   batch['origins']).reshape(b, -1, 3)
            valid_hw = (batch['img_shape'] // cfg.stride).to(torch.int32)
            acc, cnt = bp.backproject_batch(feats, points, projections,
                                            valid_hw)
            if cfg.view_shard_axis is not None:
                # v above is this rank's view count: pool over all the views
                acc, cnt = (mesh.all_reduce_sum(t.float()).to(t.dtype)
                            for t in (acc, cnt))
                vol, seen = bp.mean_pool_from_sums(acc, cnt)
            else:
                vol, seen = bp.mean_pool_from_sums(acc, cnt, n_views=v)
            volume = vol.view(nx, ny, nz, b, -1).permute(3, 4, 0, 1, 2)
            valid = seen.view(nx, ny, nz, b).permute(3, 0, 1, 2)
            volume = volume.to(self.dtype)

        with span('neck3d'):
            volume = self.neck_3d(volume)
        with span('head'):
            head_outs = self.bbox_head(volume)
        if cfg.layout_head is None:
            return head_outs, valid
        return head_outs, valid, features_2d


@span('predict')
def imvoxelnet_predict(cfg: ImVoxelNetConfig, head_outs, valid=None,
                       origins=None, features_2d=None):
    """Test-time detections (``imvoxelnet.py:93-106``), fixed-shape.  The
    indoor decode also needs the forward's ``valid`` mask and the batch's
    ``origins``; with a layout head, the forward's ``features_2d`` become
    the outputs ``angles`` ``(B, 2)`` and ``layout`` ``(B, 7)``."""
    if cfg.head_kind == 'anchor3d':
        return a3d.anchor3d_head_get_bboxes(head_outs, cfg.anchor_head)
    if valid is None or origins is None:
        raise ValueError('the indoor decode needs valid and origins')
    results = ivh.indoor_head_get_bboxes(head_outs, valid, origins,
                                         cfg.indoor_head)
    if cfg.layout_head is not None and features_2d is not None:
        results['angles'], results['layout'] = features_2d
    return results


@span('loss')
def imvoxelnet_loss(cfg: ImVoxelNetConfig, head_outs, batch, valid=None,
                    features_2d=None):
    """Training losses (``imvoxelnet.py:82-87``): a dict of scalars,
    ``loss_cls``, ``loss_bbox`` and ``loss_dir`` (KITTI) or
    ``loss_centerness``, ``loss_bbox`` and ``loss_cls`` (indoor), then, with
    a layout head and the forward's ``features_2d``, ``angle_loss`` and
    ``layout_loss`` (from ``batch['gt_angles']`` and ``batch['gt_layout']``).
    The indoor loss also needs the forward's ``valid`` mask and
    ``batch['origins']``."""
    if cfg.head_kind == 'anchor3d':
        return a3d.anchor3d_head_loss(head_outs, batch['gt_boxes'],
                                      batch['gt_labels'], batch['gt_mask'],
                                      cfg.anchor_head)
    if cfg.dp_loss_norm not in ('per_image', 'batch_mean'):
        raise ValueError(f'unknown dp_loss_norm {cfg.dp_loss_norm!r}')
    if valid is None:
        raise ValueError('the indoor loss needs the forward\'s valid mask')
    losses = ivh.indoor_head_loss(head_outs, valid, batch['origins'],
                                  batch['gt_boxes'], batch['gt_labels'],
                                  batch['gt_mask'], cfg.indoor_head,
                                  batch_mean=cfg.dp_loss_norm == 'batch_mean')
    if cfg.layout_head is not None and features_2d is not None:
        losses.update(lh.layout_head_loss(*features_2d, batch['gt_angles'],
                                          batch['gt_layout'],
                                          cfg.layout_head))
    return losses


def init_weights(model: ImVoxelNet, generator: torch.Generator) -> None:
    """Seeded random weights in the JAX package's init scheme: lecun-normal
    convs and layout-head linears with zero biases, normal(0.01) head convs
    (every conv of the indoor head), identity
    batch norms but for the encoder-decoder blocks' zero ``bn2`` scales,
    ``Scale`` at 1, and the head's cls bias at ``CLS_BIAS_INIT``
    (``anchor3d_head.py:62-63``, ``imvoxel_heads.py:95-97``); a DCN's
    kernel he-normal and its ``conv_offset`` zero, as mmcv and the JAX
    init have them (``models/dcn.py:142-149``), so that every offset starts
    at 0 and every mask at 0.5."""
    head = model.bbox_head
    if isinstance(head, a3d.Anchor3DHead):
        small = {head.conv_cls, head.conv_reg}
        cls_conv, cls_bias = head.conv_cls, a3d.CLS_BIAS_INIT
    else:
        small = {m for m in head.modules() if isinstance(m, nn.Conv3d)}
        cls_conv, cls_bias = head.cls_conv, ivh.CLS_BIAS_INIT
    convs = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, necks3d.Conv3x3x3,
             nn.Linear)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, convs):
                if mod in small:
                    mod.weight.normal_(0.0, 0.01, generator=generator)
                else:
                    lecun_normal_(mod.weight, generator)
                if getattr(mod, 'bias', None) is not None:
                    mod.bias.zero_()
        cls_conv.bias.fill_(cls_bias)
        for mod in model.modules():
            if isinstance(mod, DeformConv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                                   generator=generator)
                mod.conv_offset.weight.zero_()
                mod.conv_offset.bias.zero_()
        for mod in model.modules():
            if isinstance(mod, (resnet_lib.FrozenBatchNorm, nn.BatchNorm3d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, ivh.Scale):
                mod.scale.fill_(1.0)
        for mod in model.modules():
            if isinstance(mod, necks3d.BasicBlock3d) and mod.zero_init_bn2:
                mod.bn2.weight.zero_()


def build_model(cfg: ImVoxelNetConfig, device='cuda', seed: int = 0):
    """An eval-mode :class:`ImVoxelNet` with seeded random weights on
    ``device`` (the card unless the caller asks for the CPU)."""
    model = ImVoxelNet(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
