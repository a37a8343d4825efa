"""BEV anchor head (KITTI) and its fixed-shape inference.

Counterpart of ``imvoxelnet_tpu/models/heads/anchor3d_head.py``
(``Anchor3DHeadConfig``, ``Anchor3DHead``, ``anchor3d_head_get_bboxes``).
The head's outputs are returned channel-last, ``(B, H, W, A*K)``, so anchors
flatten anchor-major exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import torch
from torch import nn

from ...core import anchors as anchor_gen
from ...core import coder
from ...core.target_assign import AssignerConfig
from ...ops import boxes as box_ops
from ...ops import nms as nms_ops
from ..layers import Conv2d

CLS_BIAS_INIT = -4.59511985013459   # -log((1 - 0.01) / 0.01)


@dataclasses.dataclass(frozen=True)
class Anchor3DHeadConfig:
    num_classes: int = 1
    feat_channels: int = 256
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (0, -39.68, -1.78, 69.12 - .32, 39.68 - .32, -1.78),)
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = ((1.6, 3.9, 1.56),)
    anchor_rotations: Tuple[float, ...] = (0.0, 1.57)
    anchor_custom_values: Tuple[float, ...] = ()
    use_direction_classifier: bool = True
    diff_rad_by_sin: bool = True
    dir_offset: float = 0.0
    dir_limit_offset: float = 1.0
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 2.0
    loss_dir_weight: float = 0.2
    assigner: AssignerConfig = AssignerConfig()
    # test cfg (imvoxelnet_kitti.py:58-65)
    nms_pre: int = 100
    score_thr: float = 0.1
    iou_thr: float = 0.01          # nms_thr
    max_out: int = 50              # max_num
    use_rotate_nms: bool = True

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_rotations)

    @property
    def box_code_size(self) -> int:
        return 7 + len(self.anchor_custom_values)


class Anchor3DHead(nn.Module):
    """1x1 conv heads on the BEV map (``anchor3d_head.py:122-130``)."""

    def __init__(self, cfg: Anchor3DHeadConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        a = cfg.num_anchors
        self.conv_cls = Conv2d(in_channels, a * cfg.num_classes, 1)
        self.conv_reg = Conv2d(in_channels, a * cfg.box_code_size, 1)
        self.conv_dir_cls = (Conv2d(in_channels, a * 2, 1)
                             if cfg.use_direction_classifier else None)

    def forward(self, x):
        """``x (B, C, H, W)`` -> float32 ``(B, H, W, A*K)`` maps."""
        def nhwc(t):
            return t.permute(0, 2, 3, 1).float()
        dir_pred = (None if self.conv_dir_cls is None
                    else nhwc(self.conv_dir_cls(x)))
        return nhwc(self.conv_cls(x)), nhwc(self.conv_reg(x)), dir_pred


@functools.lru_cache(maxsize=8)
def _cached_anchors(featmap_size, cfg: Anchor3DHeadConfig, device):
    return anchor_gen.grid_anchors(
        featmap_size, cfg.anchor_ranges, cfg.anchor_sizes,
        cfg.anchor_rotations, cfg.anchor_custom_values, device=device)


def head_anchors(featmap_size, cfg: Anchor3DHeadConfig, device=None):
    """Flattened anchors matching the conv-head channel layout.  Built on
    the host once per map size, config and device and then shared: callers
    must not write to them."""
    return _cached_anchors(tuple(featmap_size), cfg, device)


@torch.no_grad()
def anchor3d_head_get_bboxes(head_outs, cfg: Anchor3DHeadConfig):
    """Fixed-shape inference (``get_bboxes_single``, ``anchor3d_head.py:
    428-517``) including the direction-bin yaw reconstruction, on all
    samples at once (the JAX package ``vmap``s the same steps).  Test-time
    decode: no gradient flows through the top-k and NMS.  On CUDA tensors
    nothing here waits for the device.

    Returns a dict of ``boxes (B, max_out, 7)``, ``scores``, ``labels`` and
    ``valid`` (``(B, max_out)``).
    """
    if not cfg.use_rotate_nms:
        raise NotImplementedError('only rotated NMS is ported')
    cls_score, bbox_pred, dir_pred = head_outs
    b, h, w, _ = cls_score.shape
    anchors = head_anchors((h, w), cfg, device=cls_score.device)
    scores = torch.sigmoid(cls_score.reshape(b, -1, cfg.num_classes))
    deltas = bbox_pred.reshape(b, -1, cfg.box_code_size)
    dir_score = torch.argmax(dir_pred.reshape(b, -1, 2), dim=-1)

    max_scores = scores.max(dim=2).values
    k = min(cfg.nms_pre, max_scores.shape[1])
    _, ids = nms_ops.top_k(max_scores, k)                        # (B, k)
    sample = torch.arange(b, device=ids.device)[:, None]
    boxes = coder.decode(anchors[ids], deltas[sample, ids])
    out = nms_ops.multiclass_nms_3d(
        boxes, box_ops.bev(boxes), scores[sample, ids],
        torch.ones((b, k), dtype=torch.bool, device=scores.device),
        score_thr=cfg.score_thr, max_num=cfg.max_out,
        iou_thr=cfg.iou_thr, pre_nms_k=k,
        mlvl_dir_scores=dir_score[sample, ids].to(scores.dtype))
    boxes_out = out['boxes']
    dir_rot = box_ops.limit_period(
        boxes_out[..., 6] - cfg.dir_offset, cfg.dir_limit_offset, math.pi)
    yaw = dir_rot + cfg.dir_offset + math.pi * out['dir_scores']
    boxes_out = torch.cat([boxes_out[..., :6], torch.where(
        out['valid'], yaw, boxes_out[..., 6])[..., None], boxes_out[..., 7:]],
        dim=-1)
    return dict(boxes=boxes_out, scores=out['scores'], labels=out['labels'],
                valid=out['valid'])
