"""Anchor-free FCOS-style indoor 3D head (SUN RGB-D, v1 and v2) and its
fixed-shape inference.

Counterpart of ``imvoxelnet_tpu/models/heads/imvoxel_heads.py``
(``IndoorHeadConfig``, ``Scale``, ``IndoorHead``,
``sunrgbd_bbox_pred_to_bbox``, ``mlvl_points``, ``resize_valid_to_levels``,
``indoor_head_get_bboxes``).  The head keeps the reference's three separate
prediction convs (``centerness_conv``, ``reg_conv``, ``cls_conv``); the JAX
package fuses the first two into one conv only to fill the TPU's lanes, and
each output channel's arithmetic is the same either way.

Head outputs are channel-last float32 level lists ``(B, nx, ny, nz, C)``,
flattened ``(nx, ny, nz)``-major as in the JAX package and the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ...ops import backproject as bp
from ...ops import boxes as box_ops
from ...ops import nms as nms_ops
from ..layers import BatchNorm3d, Conv3d

INF = 1e8
CLS_BIAS_INIT = -4.59511985013459   # -log((1 - 0.01) / 0.01)


@dataclasses.dataclass(frozen=True)
class IndoorHeadConfig:
    n_classes: int
    n_reg_outs: int  # 7 for SUN RGB-D (with yaw), 6 for ScanNet
    voxel_size: Tuple[float, float, float]
    dataset: str = 'sunrgbd'        # 'sunrgbd' | 'scannet'
    version: int = 1                # 1 (towers, regress ranges) | 2 (limit)
    n_convs: int = 0                # v1 tower depth (0 in all shipped configs)
    n_scales: int = 3
    centerness_topk: int = -1       # v1: optional (_top27: 28); v2: needed
    limit: int = 27                 # v2 scale-assignment threshold
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1.0, 0.75), (0.75, 1.5), (1.5, INF))
    # test cfg
    nms_pre: int = 1000
    score_thr: float = 0.05
    iou_thr: float = 0.15           # rotated nms_thr (sunrgbd)
    # fixed-size detection output; the reference caps at max_num = nms_pre
    max_out: int = 1000
    # per-class candidate cap of the rotated NMS (<= 0, the JAX package's
    # untruncated path, is not ported)
    pre_nms_k: int = 256

    @property
    def with_yaw(self) -> bool:
        return self.dataset == 'sunrgbd'


class Scale(nn.Module):
    """Learnable scalar (mmcv ``Scale``)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return x * self.scale


def _tower(c: int):
    """A v1 tower stage: 3x3x3 conv, BN, ReLU (``{reg,cls}_convs.{j}``)."""
    return nn.Sequential(Conv3d(c, c, 3, padding=1, bias=False),
                         BatchNorm3d(c), nn.ReLU(inplace=True))


class IndoorHead(nn.Module):
    """Shared-weight multi-scale head (``imvoxel_head.py:46-84``,
    ``imvoxel_head_v2.py:45-57``); v1 runs ``n_convs`` tower stages before
    the prediction convs, v2 none."""

    def __init__(self, cfg: IndoorHeadConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        c = in_channels
        n_convs = cfg.n_convs if cfg.version == 1 else 0
        self.reg_convs = nn.ModuleList(_tower(c) for _ in range(n_convs))
        self.cls_convs = nn.ModuleList(_tower(c) for _ in range(n_convs))
        self.centerness_conv = Conv3d(c, 1, 3, padding=1, bias=False)
        self.reg_conv = Conv3d(c, cfg.n_reg_outs, 3, padding=1, bias=False)
        self.cls_conv = Conv3d(c, cfg.n_classes, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in range(cfg.n_scales))

    def forward(self, xs):
        """``xs``: the neck's ``(B, C, nx, ny, nz)`` levels.  Returns float32
        channel-last ``(centernesses, bbox_preds, cls_scores)`` level
        lists."""
        def ndhwc(t):
            return t.permute(0, 2, 3, 4, 1).float()

        centernesses, bbox_preds, cls_scores = [], [], []
        for x, scale in zip(xs, self.scales):
            reg_feat = cls_feat = x
            for reg_tower, cls_tower in zip(self.reg_convs, self.cls_convs):
                reg_feat, cls_feat = reg_tower(reg_feat), cls_tower(cls_feat)
            reg_final = ndhwc(self.reg_conv(reg_feat))
            if self.cfg.with_yaw:
                bbox_pred = torch.cat([torch.exp(scale(reg_final[..., :6])),
                                       reg_final[..., 6:]], dim=-1)
            else:
                bbox_pred = torch.exp(scale(reg_final))
            centernesses.append(ndhwc(self.centerness_conv(reg_feat)))
            bbox_preds.append(bbox_pred)
            cls_scores.append(ndhwc(self.cls_conv(cls_feat)))
        return centernesses, bbox_preds, cls_scores


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------

def sunrgbd_bbox_pred_to_bbox(points, bbox_pred):
    """Distances + angle -> gravity-center 7-DoF boxes
    (``imvoxel_head.py:432-449``): points ``(..., 3)``, predictions
    ``(..., 7)`` -> ``(..., 7)``."""
    d = bbox_pred
    shift = torch.stack([(d[..., 1] - d[..., 0]) / 2,
                         (d[..., 3] - d[..., 2]) / 2,
                         (d[..., 5] - d[..., 4]) / 2], dim=-1)
    shift = box_ops.rotation_3d_in_axis(shift[..., None, :], d[..., 6],
                                        axis=2)[..., 0, :]
    size = torch.stack([d[..., 0] + d[..., 1], d[..., 2] + d[..., 3],
                        d[..., 4] + d[..., 5]], dim=-1)
    return torch.cat([points + shift, size, d[..., 6:7]], dim=-1)


def mlvl_points(featmap_sizes, voxel_size, origins):
    """Per-level voxel centers ``(B, P_l, 3)``, level ``i`` at
    ``voxel_size * 2**i`` (``imvoxel_head.py:226-235``); ``origins (B,
    3)``."""
    pts = []
    for i, size in enumerate(featmap_sizes):
        vs = tuple(v * (2 ** i) for v in voxel_size)
        pts.append(bp.get_points(size, vs, origins).reshape(
            origins.shape[0], -1, 3))
    return pts


def resize_valid_to_levels(valid, featmap_sizes):
    """The ``(B, nx, ny, nz)`` seen mask at each level's size: trilinear
    resize (half-pixel centres, no antialiasing) and round half to even, as
    the reference's ``nn.Upsample(mode='trilinear')(valid).round().bool()``
    (``imvoxel_head.py:112-114``)."""
    vf = valid[:, None].float()
    return [torch.round(torch.nn.functional.interpolate(
                vf, size=tuple(size), mode='trilinear',
                align_corners=False))[:, 0] > 0
            for size in featmap_sizes]


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

@torch.no_grad()
def indoor_head_get_bboxes(head_outs, valid, origins, cfg: IndoorHeadConfig):
    """Fixed-shape inference, all samples at once (``_get_bboxes_single`` +
    ``_nms``, ``imvoxel_head.py:269-306, 410-430``; the JAX package
    ``vmap``s the same steps).

    Per level the class scores are multiplied by the centerness and by the
    level's seen mask and the ``nms_pre`` best voxels (ties lowest index
    first) become candidates; the levels' candidates go through one batched
    per-class rotated NMS.  On CUDA tensors nothing here waits for the
    device.

    Returns a dict of ``boxes (B, max_out, 7)`` bottom-center, ``scores``,
    ``labels`` and ``valid`` (``(B, max_out)``).
    """
    if cfg.dataset != 'sunrgbd':
        raise NotImplementedError('only the SUN RGB-D decode is ported')
    if cfg.pre_nms_k <= 0:
        raise NotImplementedError('the untruncated NMS is not ported')
    centernesses, bbox_preds, cls_scores = head_outs
    b = valid.shape[0]
    featmap_sizes = [tuple(x.shape[1:4]) for x in centernesses]
    valids = resize_valid_to_levels(valid, featmap_sizes)
    points = mlvl_points(featmap_sizes, cfg.voxel_size, origins)

    cand_boxes, cand_scores = [], []
    for centerness, bbox_pred, cls_score, valid_l, pts in zip(
            centernesses, bbox_preds, cls_scores, valids, points):
        c = torch.sigmoid(centerness.reshape(b, -1))
        s = torch.sigmoid(cls_score.reshape(b, -1, cfg.n_classes))
        s = s * c[..., None] * valid_l.reshape(b, -1, 1).to(s.dtype)
        k = min(cfg.nms_pre, s.shape[1])
        _, ids = nms_ops.top_k(s.max(dim=-1).values, k)          # (B, k)
        cand_boxes.append(sunrgbd_bbox_pred_to_bbox(
            nms_ops.take_per_sample(pts, ids),
            nms_ops.take_per_sample(
                bbox_pred.reshape(b, -1, bbox_pred.shape[-1]), ids)))
        cand_scores.append(nms_ops.take_per_sample(s, ids))
    boxes = torch.cat(cand_boxes, dim=1)                         # (B, N, 7)
    scores = torch.cat(cand_scores, dim=1)                       # (B, N, C)

    out = nms_ops.multiclass_nms_3d(
        boxes, box_ops.bev(boxes), scores,
        torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device),
        score_thr=cfg.score_thr, max_num=cfg.max_out, iou_thr=cfg.iou_thr,
        pre_nms_k=cfg.pre_nms_k)
    return dict(boxes=box_ops.to_bottom_center(out['boxes']),
                scores=out['scores'], labels=out['labels'],
                valid=out['valid'])
