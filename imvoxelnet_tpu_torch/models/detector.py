"""The ImVoxelNet detector: backbone -> FPN -> backprojection -> 3D neck ->
anchor head, and its test-time decode (``simple_test``).

Counterpart of ``imvoxelnet_tpu/models/detector.py`` (``ImVoxelNetConfig``,
``NeckConfig``, ``ImVoxelNet``, ``imvoxelnet_predict``) for the KITTI
(``head_kind='anchor3d'``, ``neck.kind='kitti'``) configuration.

Batch layout, as in the JAX package (all tensors on one device):
  images      (B, V, H, W, 3)   normalized, padded
  intrinsics  (B, 3, 3)
  extrinsics  (B, V, 4, 4)
  origins     (B, 3)
  img_shape   (B, 2) int        resized (pre-pad) image (h, w)
  ratios      (B,) float        ori_h / (img_h / stride)  (imvoxelnet.py:118)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import backproject as bp
from . import fpn as fpn_lib
from . import necks3d
from . import resnet as resnet_lib
from .heads import anchor3d_head as a3d
from .layers import lecun_normal_


@dataclasses.dataclass(frozen=True)
class NeckConfig:
    kind: str = 'kitti'
    in_channels: int = 64
    out_channels: int = 256


@dataclasses.dataclass(frozen=True)
class ImVoxelNetConfig:
    n_voxels: Tuple[int, int, int] = (216, 248, 12)
    voxel_size: Tuple[float, float, float] = (0.32, 0.32, 0.32)
    fpn_out_channels: int = 64
    neck: NeckConfig = NeckConfig()
    head_kind: str = 'anchor3d'
    anchor_head: Optional[a3d.Anchor3DHeadConfig] = a3d.Anchor3DHeadConfig()
    stride: int = 4                 # asserted == 4 in the reference
    compute_dtype: str = 'float32'  # conv-path dtype: float32 | bfloat16
    # Bottlenecks per stage; (3, 4, 6, 3) = ResNet-50.
    backbone_stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)


class ImVoxelNet(nn.Module):
    """Parameters carry the reference's mmdet ``state_dict`` names
    (``backbone.*``, ``neck.*``, ``neck_3d.*``, ``bbox_head.*``)."""

    def __init__(self, cfg: ImVoxelNetConfig):
        super().__init__()
        if cfg.head_kind != 'anchor3d' or cfg.neck.kind != 'kitti':
            raise NotImplementedError(
                f'the port has the KITTI configuration only, got head '
                f'{cfg.head_kind!r} and neck {cfg.neck.kind!r}')
        self.cfg = cfg
        self.backbone = resnet_lib.ResNet(tuple(cfg.backbone_stage_blocks))
        self.neck = fpn_lib.FPN(out_channels=cfg.fpn_out_channels)
        self.neck_3d = necks3d.KittiImVoxelNeck(cfg.neck.in_channels,
                                                cfg.neck.out_channels)
        self.bbox_head = a3d.Anchor3DHead(cfg.anchor_head,
                                          cfg.neck.out_channels)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def forward(self, batch):
        """Returns ``(head_outs, valid)``: the head's float32 NHWC
        ``(cls_score, bbox_pred, dir_pred)`` and the ``(B, nx, ny, nz)``
        bool mask of voxels seen by at least one view."""
        cfg = self.cfg
        images = batch['images']
        b, v, h, w, _ = images.shape
        # NHWC images viewed as NCHW: channels_last memory, no copy
        x = images.reshape(b * v, h, w, 3).permute(0, 3, 1, 2).to(self.dtype)
        x = self.neck(self.backbone(x))[0]
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

        bev = self.neck_3d(volume.to(self.dtype))
        return self.bbox_head(bev), valid


def imvoxelnet_predict(cfg: ImVoxelNetConfig, head_outs):
    """Test-time detections (``imvoxelnet.py:93-106``), fixed-shape."""
    return a3d.anchor3d_head_get_bboxes(head_outs, cfg.anchor_head)


def init_weights(model: ImVoxelNet, generator: torch.Generator) -> None:
    """Seeded random weights in the JAX package's init scheme: lecun-normal
    convs, normal(0.01) head convs, identity batch norms, the head's cls
    bias at ``CLS_BIAS_INIT`` (``anchor3d_head.py:62-63``)."""
    heads = model.bbox_head
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d, necks3d.Conv3x3x3)):
                if mod is heads.conv_cls or mod is heads.conv_reg:
                    mod.weight.normal_(0.0, 0.01, generator=generator)
                else:
                    lecun_normal_(mod.weight, generator)
                if getattr(mod, 'bias', None) is not None:
                    mod.bias.zero_()
        heads.conv_cls.bias.fill_(a3d.CLS_BIAS_INIT)
        for mod in model.modules():
            if isinstance(mod, (resnet_lib.FrozenBatchNorm, nn.BatchNorm3d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)


def build_model(cfg: ImVoxelNetConfig, device='cuda', seed: int = 0):
    """An eval-mode :class:`ImVoxelNet` with seeded random weights on
    ``device`` (the card unless the caller asks for the CPU)."""
    model = ImVoxelNet(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
