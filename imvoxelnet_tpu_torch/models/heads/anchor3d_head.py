"""BEV anchor head (KITTI), its training loss and its fixed-shape inference.

Counterpart of ``imvoxelnet_tpu/models/heads/anchor3d_head.py``
(``Anchor3DHeadConfig``, ``Anchor3DHead``, ``add_sin_difference``,
``anchor3d_head_loss``, ``anchor3d_head_get_bboxes``).
The head's outputs are returned channel-last, ``(B, H, W, A*K)``, so anchors
flatten anchor-major exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ...core import anchors as anchor_gen
from ...core import coder
from ...core import target_assign
from ...core.target_assign import AssignerConfig
from ...ops import boxes as box_ops
from ...ops import losses as loss_ops
from ...ops import nms as nms_ops
from ...parallel import mesh
from ...utils.tracing import span
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


_ANCHORS: dict = {}


def head_anchors(featmap_size, cfg: Anchor3DHeadConfig, device=None):
    """Flattened anchors matching the conv-head channel layout.  Built on
    the host once per map size, config and device and then shared: callers
    must not write to them.  Traced by ``torch.export``, a cached set is a
    constant of the program on its device; one not cached yet is built in
    the program (a copy from the host at every call) and not cached, so that
    no traced tensor enters the cache (``utils/export.py`` runs the model
    once before it traces)."""
    key = (tuple(featmap_size), cfg,
           None if device is None else torch.device(device))
    anchors = _ANCHORS.get(key)
    if anchors is None:
        anchors = anchor_gen.grid_anchors(
            key[0], cfg.anchor_ranges, cfg.anchor_sizes, cfg.anchor_rotations,
            cfg.anchor_custom_values, device=device)
        if not torch.compiler.is_compiling():
            _ANCHORS[key] = anchors
    return anchors


def add_sin_difference(pred_yaw, target_yaw):
    """``sin(a - b)`` factorised (``anchor3d_head.py:279-301``)."""
    return (torch.sin(pred_yaw) * torch.cos(target_yaw),
            torch.cos(pred_yaw) * torch.sin(target_yaw))


def anchor3d_head_loss(head_outs, gt_boxes, gt_labels, gt_mask,
                       cfg: Anchor3DHeadConfig):
    """The batch's ``loss_cls``, ``loss_bbox`` and ``loss_dir``, each
    normalised by the batch's positive count ``sum_i max(n_pos_i, 1)``.

    Under a process group of W > 1 ranks, each holding a slice of the
    global batch, the count is the global batch's (JAX ``anchor3d_head.py:
    136`` sees the global batch) and each rank's losses are its share of
    the global losses times W: normalised by the global count over W, so
    that the mean of the ranks' gradients is the global loss's gradient.

    ``head_outs`` as :class:`Anchor3DHead` returns them; ``gt_boxes (B, G,
    7)``, ``gt_labels (B, G)``, ``gt_mask (B, G)`` padded GT.  The targets
    carry no gradient; nothing here waits for the device.
    """
    cls_score, bbox_pred, dir_pred = head_outs
    b, h, w, _ = cls_score.shape
    anchors = head_anchors((h, w), cfg, device=cls_score.device)
    with span('targets'):
        targets = target_assign.anchor_targets(
            anchors, gt_boxes, gt_labels, gt_mask, cfg.assigner,
            cfg.num_classes, cfg.dir_offset)
    num_total = targets['n_pos'].sum().float()
    world = mesh.world_size()
    if world > 1:
        num_total = mesh.all_reduce_sum(num_total) / world

    loss_cls = loss_ops.sigmoid_focal_loss(
        cls_score.reshape(-1, cfg.num_classes), targets['labels'].reshape(-1),
        weight=targets['label_weights'].reshape(-1), avg_factor=num_total,
        loss_weight=cfg.loss_cls_weight)

    pred = bbox_pred.reshape(b, -1, cfg.box_code_size)
    tgt = targets['bbox_targets']
    if cfg.diff_rad_by_sin:
        sp, st = add_sin_difference(pred[..., 6], tgt[..., 6])
        pred = torch.cat([pred[..., :6], sp[..., None], pred[..., 7:]], -1)
        tgt = torch.cat([tgt[..., :6], st[..., None], tgt[..., 7:]], -1)
    loss_bbox = loss_ops.smooth_l1_loss(
        pred, tgt, weight=targets['bbox_weights'][..., None], beta=1.0 / 9.0,
        avg_factor=num_total, loss_weight=cfg.loss_bbox_weight)

    losses = dict(loss_cls=loss_cls, loss_bbox=loss_bbox)
    if cfg.use_direction_classifier:
        losses['loss_dir'] = loss_ops.softmax_cross_entropy(
            dir_pred.reshape(-1, 2), targets['dir_targets'].reshape(-1),
            weight=targets['dir_weights'].reshape(-1), avg_factor=num_total,
            loss_weight=cfg.loss_dir_weight)
    return losses


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
        iou_thr=cfg.iou_thr, use_rotate_nms=cfg.use_rotate_nms, pre_nms_k=k,
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
