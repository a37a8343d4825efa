"""Anchor-free FCOS-style indoor 3D head (SUN RGB-D with yaw, ScanNet
axis-aligned; v1 and v2), its training targets and loss, and its
fixed-shape inference.

Counterpart of ``imvoxelnet_tpu/models/heads/imvoxel_heads.py``
(``IndoorHeadConfig``, ``Scale``, ``IndoorHead``, ``compute_centerness``,
``sunrgbd_bbox_pred_to_bbox``, ``scannet_bbox_pred_to_bbox``,
``mlvl_points``, ``indoor_targets``,
``resize_valid_to_levels``, ``_flatten_levels``, ``indoor_head_loss``,
``indoor_head_get_bboxes``).  The JAX package ``vmap``s the targets and the
losses over samples; here they carry the batch as a leading dim, with the
same dense ``(B, P, G)`` tensors over the padded GT axis and no host read.
The head keeps the reference's three separate prediction convs
(``centerness_conv``, ``reg_conv``, ``cls_conv``); the JAX package fuses
the first two into one conv only to fill the TPU's lanes, and each output
channel's arithmetic is the same either way.

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
from ...ops import losses as loss_ops
from ...ops import nms as nms_ops
from ...parallel import mesh
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
    iou_thr: float = 0.15           # rotated (sunrgbd) / aligned (scannet)
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

def _centerness(d):
    """:func:`compute_centerness` of the six face distances ``d`` given as
    separate tensors."""
    c = (torch.minimum(d[0], d[1]) / torch.maximum(d[0], d[1]).clamp(min=1e-12)
         * torch.minimum(d[2], d[3])
         / torch.maximum(d[2], d[3]).clamp(min=1e-12)
         * torch.minimum(d[4], d[5])
         / torch.maximum(d[4], d[5]).clamp(min=1e-12))
    return torch.sqrt(c.clamp(min=0.0))


def compute_centerness(bbox_targets):
    """sqrt of the per-axis min/max products of ``(..., 6+)`` face distances
    (``imvoxel_head.py:563-571``)."""
    return _centerness(bbox_targets[..., :6].unbind(-1))


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


def scannet_bbox_pred_to_bbox(points, bbox_pred):
    """Face distances -> axis-aligned corner boxes ``(x1, y1, z1, x2, y2,
    z2)`` (``imvoxel_head.py:552-560``): points ``(..., 3)``, distances
    ``(..., 6)`` -> ``(..., 6)``."""
    d = bbox_pred
    return torch.stack(
        [points[..., 0] - d[..., 0], points[..., 1] - d[..., 2],
         points[..., 2] - d[..., 4], points[..., 0] + d[..., 1],
         points[..., 1] + d[..., 3], points[..., 2] + d[..., 5]], dim=-1)


# the box decode of each dataset: distances (and yaw) -> the loss's boxes
BBOX_PRED_TO_BBOX = {'sunrgbd': sunrgbd_bbox_pred_to_bbox,
                     'scannet': scannet_bbox_pred_to_bbox}


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
# Training targets and loss
# ---------------------------------------------------------------------------

@torch.no_grad()
def indoor_targets(points, scales, regress_ranges, gt_boxes, gt_labels,
                   gt_mask, cfg: IndoorHeadConfig):
    """FCOS-style 3D target assignment, v1 and v2, all samples at once
    (``ImVoxelHead._get_target_single``, ``imvoxel_head_v2.py:357-374``).

    Every point gets the smallest-volume GT box among those that contain it
    (in the box's frame, turned by its yaw, for SUN RGB-D; axis-aligned for
    ScanNet) and that the version's rule allows: v1 keeps boxes whose
    largest face distance lies in the point's level's regress range; v2
    keeps the
    coarsest level that still holds ``limit`` points of the box.  With
    ``centerness_topk > 0`` only the points whose centerness is strictly
    above the box's k-th value (v1) or (k+1)-th value (v2) stay.  Ties of
    volume go to the first box, as ``jnp.argmin`` gives them: a padded box
    and a point inside no box both have volume ``INF``, so such a point
    takes box 0's targets (and label -1).

    Args:
      points: ``(B, P, 3)`` all-level voxel centers (concatenated).
      scales: ``(P,)`` int level of each point.
      regress_ranges: ``(P, 2)`` per-point regress range (v1 only).
      gt_boxes: ``(B, G, 7)`` bottom-center padded GT; ``gt_labels (B, G)``
        int, ``gt_mask (B, G)`` bool.
    Returns:
      ``centerness_t (B, P)``, ``bbox_t`` (SUN RGB-D: ``(B, P, 7)``
      gravity-center boxes; ScanNet: ``(B, P, 6)`` the assigned box's face
      distances as corners around the point) and ``labels (B, P)`` with -1
      as background.
    """
    # every (B, P, G) quantity is its own tensor: stacking the face
    # distances into one (B, P, G, 7) tensor, as the JAX package does, costs
    # a strided copy of some 1.7 GB a step at b=4 for the v1 presets
    b, n_points = points.shape[:2]
    centers = box_ops.gravity_center(gt_boxes)                 # (B, G, 3)
    vols = box_ops.volume(gt_boxes)                            # (B, G)

    dx, dy, dz = (points[:, :, None, i] - centers[:, None, :, i]
                  for i in range(3))                           # (B, P, G)
    rx, ry = dx, dy
    if cfg.with_yaw:
        # into each box's frame: the offset rotated by -yaw about z (the
        # arithmetic of ops/boxes.py:rotation_3d_in_axis)
        c = torch.cos(-gt_boxes[..., 6])[:, None, :]
        s = torch.sin(-gt_boxes[..., 6])[:, None, :]
        rx, ry = dx * c + dy * s, dy * c - dx * s
    hx, hy, hz = (gt_boxes[:, None, :, 3 + i] / 2.0 for i in range(3))
    # to the min and max faces, x, y, z: (B, P, G) each
    dist = (rx + hx, hx - rx, ry + hy, hy - ry, dz + hz, hz - dz)

    def fold(fn):
        out = dist[0]
        for d in dist[1:]:
            out = fn(out, d)
        return out
    inside = (fold(torch.minimum) > 0) & gt_mask[:, None, :]
    inf = torch.full((), INF, device=points.device)
    volumes = torch.where(inside, vols[:, None, :], inf)       # (B, P, G)

    if cfg.version == 1:
        max_dist = fold(torch.maximum)
        in_range = ((max_dist >= regress_ranges[None, :, None, 0])
                    & (max_dist <= regress_ranges[None, :, None, 1]))
        volumes = torch.where(in_range, volumes, inf)
        cond_mask = inside & in_range
        kth = cfg.centerness_topk            # v1: k-th value, strictly above
    else:
        # the coarsest level holding >= limit points of the box
        per_scale = torch.stack([
            (inside & (scales[None, :, None] == i)).sum(1)
            for i in range(cfg.n_scales)], dim=1)              # (B, S, G)
        under = per_scale < cfg.limit
        first_under = torch.argmax(under.to(torch.int32), dim=1)   # first
        best = torch.where(under.any(1), (first_under - 1).clamp(min=0),
                           cfg.n_scales - 1)                   # (B, G)
        in_best = scales[None, :, None] == best[:, None, :]
        volumes = torch.where(in_best, volumes, inf)
        cond_mask = inside & in_best
        kth = cfg.centerness_topk + 1        # v2: (k+1)-th value
    if cfg.centerness_topk > 0:
        cness = torch.where(cond_mask, _centerness(dist),
                            torch.full((), -1.0, device=points.device))
        # only the k-th value is used, so the order among ties is moot
        top = torch.topk(cness, min(kth, n_points), dim=1).values[:, -1]
        volumes = torch.where(cness > top[:, None, :], volumes, inf)

    # first minimum, as jnp.argmin
    min_inds = torch.argmin(volumes, dim=2)                    # (B, P)
    min_vol = torch.gather(volumes, 2, min_inds[..., None])[..., 0]
    labels = torch.where(min_vol < INF, torch.gather(gt_labels, 1, min_inds),
                         -1)
    assigned = [torch.gather(d, 2, min_inds[..., None])[..., 0] for d in dist]
    if cfg.dataset == 'sunrgbd':
        gc_boxes = torch.cat([centers, gt_boxes[..., 3:]], dim=-1)
        bbox_t = torch.gather(gc_boxes, 1, min_inds[..., None].expand(
            b, n_points, gc_boxes.shape[-1]))
    else:
        bbox_t = scannet_bbox_pred_to_bbox(points,
                                           torch.stack(assigned, dim=-1))
    return _centerness(assigned), bbox_t, labels


def _flatten_levels(levels):
    """``[(B, nx, ny, nz, C)]`` -> ``(B, P, C)`` concatenated in level
    order."""
    return torch.cat([lv.reshape(lv.shape[0], -1, lv.shape[-1])
                      for lv in levels], dim=1)


def _level_constants(level_sizes, regress_ranges, device):
    """``scales (P,)`` and ``regress_ranges (P, 2)`` of the concatenated
    levels, filled on the device (a tensor made from a list would be a copy
    from the host)."""
    scales = torch.cat([torch.full((n,), i, dtype=torch.int32, device=device)
                        for i, n in enumerate(level_sizes)])
    rr = torch.cat([torch.stack([torch.full((n,), float(lo), device=device),
                                 torch.full((n,), float(hi), device=device)],
                                dim=-1)
                    for n, (lo, hi) in zip(level_sizes, regress_ranges)])
    return scales, rr


def indoor_head_loss(head_outs, valid, origins, gt_boxes, gt_labels, gt_mask,
                     cfg: IndoorHeadConfig, batch_mean: bool = False):
    """The batch loss (``ImVoxelHead.loss/_loss_single``,
    ``imvoxel_head.py:86-224``) with each image normalized by its own
    positive count, the reference's ``reduce_mean`` on one card
    (``dp_loss_norm='per_image'``), or with ``batch_mean`` by the mean
    count of the global batch (JAX ``imvoxel_heads.py:430-441``, the
    multi-device ``'batch_mean'``): under a process group of several ranks
    the counts and the images are summed over the ranks.  The losses are
    means over the rank's images; with every rank holding as many images,
    the mean of the ranks' gradients is the global batch's.

    Per image: the focal loss over the seen voxels, the centerness BCE over
    the positives, and the box loss weighted by the centerness target (SUN
    RGB-D: the rotated IoU-3D loss, which clips every voxel of every level
    and image in one call; ScanNet: the axis-aligned IoU loss on corner
    boxes); each is then averaged over the images.

    Args:
      head_outs: ``(centernesses, bbox_preds, cls_scores)`` level lists,
        channel-last ``(B, nx, ny, nz, C)``.
      valid: ``(B, nx, ny, nz)`` bool seen mask (level-0 resolution).
      origins: ``(B, 3)`` voxel grid origins.
      gt_boxes: ``(B, G, 7)`` padded bottom-center boxes; ``gt_labels (B,
        G)``; ``gt_mask (B, G)`` bool.
    Returns:
      dict of ``loss_centerness``, ``loss_bbox`` and ``loss_cls`` scalars.
    """
    centernesses, bbox_preds, cls_scores = head_outs
    b = valid.shape[0]
    featmap_sizes = [tuple(x.shape[1:4]) for x in centernesses]
    valids = resize_valid_to_levels(valid, featmap_sizes)
    flat_center = _flatten_levels(centernesses)[..., 0]        # (B, P)
    flat_bbox = _flatten_levels(bbox_preds)                    # (B, P, 7)
    flat_cls = _flatten_levels(cls_scores)                     # (B, P, C)
    flat_valid = torch.cat([v.reshape(b, -1) for v in valids], dim=1)

    scales, rr = _level_constants([s[0] * s[1] * s[2] for s in featmap_sizes],
                                  cfg.regress_ranges, valid.device)
    points = torch.cat(mlvl_points(featmap_sizes, cfg.voxel_size, origins),
                       dim=1)                                  # (B, P, 3)
    centerness_t, bbox_t, labels_t = indoor_targets(
        points, scales, rr, gt_boxes, gt_labels, gt_mask, cfg)
    pos = (labels_t >= 0) & flat_valid
    pred_boxes = BBOX_PRED_TO_BBOX[cfg.dataset](points, flat_bbox)

    n_pos = pos.sum(1).float()                                  # (B,)
    if batch_mean:
        total = torch.stack([n_pos.sum(), torch.full_like(n_pos[0], b)])
        if mesh.world_size() > 1:
            total = mesh.all_reduce_sum(total)
        n_pos = (total[0] / total[1]).expand(b)
    n_pos = n_pos.clamp(min=1.0)
    cls_labels = torch.where(labels_t >= 0, labels_t, cfg.n_classes)
    loss_cls = loss_ops.sigmoid_focal_loss(
        flat_cls, cls_labels, weight=flat_valid.float(), avg_factor=n_pos)
    posf = pos.float()
    loss_center = loss_ops.binary_cross_entropy(
        flat_center, centerness_t, weight=posf, avg_factor=n_pos)
    w = centerness_t * posf
    box_loss = (loss_ops.iou_3d_loss if cfg.dataset == 'sunrgbd'
                else loss_ops.axis_aligned_iou_loss)
    loss_bbox = box_loss(pred_boxes, bbox_t, weight=w, avg_factor=w.sum(1))
    return dict(loss_centerness=loss_center.mean(),
                loss_bbox=loss_bbox.mean(), loss_cls=loss_cls.mean())


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
    first) become candidates.  SUN RGB-D: the levels' candidates go through
    one batched per-class rotated NMS, over each class's ``pre_nms_k`` best
    or, with ``pre_nms_k <= 0``, over all of them
    (``ops/nms.py:multiclass_nms_3d_exact``).  ScanNet (``_nms``,
    ``imvoxel_head.py:533-550``): each candidate takes its best class and
    score, those above ``score_thr`` go through one batched class-aware
    axis-aligned NMS, and the ``max_out`` best kept ones (ties lowest index
    first) are the detections, as centre-size boxes with yaw 0.  On CUDA
    tensors nothing here waits for the device.

    Returns a dict of ``boxes (B, max_out, 7)`` bottom-center, ``scores``,
    ``labels`` and ``valid`` (``(B, max_out)``).
    """
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
        cand_boxes.append(BBOX_PRED_TO_BBOX[cfg.dataset](
            nms_ops.take_per_sample(pts, ids),
            nms_ops.take_per_sample(
                bbox_pred.reshape(b, -1, bbox_pred.shape[-1]), ids)))
        cand_scores.append(nms_ops.take_per_sample(s, ids))
    boxes = torch.cat(cand_boxes, dim=1)                         # (B, N, 7|6)
    scores = torch.cat(cand_scores, dim=1)                       # (B, N, C)
    if cfg.dataset != 'sunrgbd':
        return _scannet_nms(boxes, scores, cfg)

    ones = torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    if cfg.pre_nms_k <= 0:
        out = nms_ops.multiclass_nms_3d_exact(
            boxes, box_ops.bev(boxes), scores, ones, score_thr=cfg.score_thr,
            max_num=cfg.max_out, iou_thr=cfg.iou_thr)
    else:
        out = nms_ops.multiclass_nms_3d(
            boxes, box_ops.bev(boxes), scores, ones, score_thr=cfg.score_thr,
            max_num=cfg.max_out, iou_thr=cfg.iou_thr,
            pre_nms_k=cfg.pre_nms_k)
    return dict(boxes=box_ops.to_bottom_center(out['boxes']),
                scores=out['scores'], labels=out['labels'],
                valid=out['valid'])


def _scannet_nms(boxes, scores, cfg: IndoorHeadConfig):
    """The ScanNet decode's NMS and output (``imvoxel_heads.py:529-546`` of
    the JAX package): ``boxes (B, N, 6)`` corners, ``scores (B, N, C)``."""
    s = scores.max(dim=-1).values
    lab = torch.argmax(scores, dim=-1)                 # the first maximum
    keep = nms_ops.aligned_3d_nms(boxes, s, lab, s > cfg.score_thr,
                                  cfg.iou_thr)
    masked = torch.where(keep, s, torch.full((), -1.0, device=s.device))
    top_s, idx = nms_ops.top_k(masked, cfg.max_out)
    corner = nms_ops.take_per_sample(boxes, idx)
    center_size = torch.stack([
        (corner[..., 0] + corner[..., 3]) / 2,
        (corner[..., 1] + corner[..., 4]) / 2,
        corner[..., 2],                                # bottom z
        corner[..., 3] - corner[..., 0],
        corner[..., 4] - corner[..., 1],
        corner[..., 5] - corner[..., 2],
        torch.zeros_like(corner[..., 0])], dim=-1)
    return dict(boxes=center_size, scores=top_s.clamp(min=0.0),
                labels=nms_ops.take_per_sample(lab, idx).to(torch.int32),
                valid=top_s > 0)
