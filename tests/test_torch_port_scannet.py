"""The multi-view ScanNet slice of the PyTorch port against the JAX package,
on the CPU.

Module by module (``scannet_bbox_pred_to_bbox``, the axis-aligned 3D IoU in
both modes, the axis-aligned IoU loss and its gradient, the class-aware
axis-aligned NMS with forced score ties, the ScanNet targets, head loss
and decode) and then the slice as a whole on a tiny ``imvoxelnet_scannet``
configuration with 3 views (``tests/_torch_port_fixtures.py:
tiny_scannet_cfgs``): the JAX ``ImVoxelNet`` + ``imvoxelnet_predict`` and the
port's, and ``make_train_step`` for 3 steps against ``jax.jit`` of the JAX
step, from the same weights (``from_jax_variables``) and the same numpy
batch (``utils/synthetic.py:scannet_train_batch`` at 128x96).

Order of ties: the JAX NMS ranks by a stable ascending sort reversed, so
equal scores go highest index first; its decode's ``lax.top_k`` takes the
lowest index first.  The port reproduces both (``ops/nms.py``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models.heads import imvoxel_heads as jax_ivh
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops import losses as jax_losses
from imvoxelnet_tpu.ops import nms as jax_nms
from imvoxelnet_tpu.parallel import train as jax_train

from imvoxelnet_tpu_torch.models import detector
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import losses
from imvoxelnet_tpu_torch.ops import nms as nms_ops
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import synthetic
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

from _torch_port_fixtures import (jax_variables, port_model,
                                  projection_margin, recording,
                                  tiny_scannet_cfgs, to_torch)
from test_torch_port_indoor import _gaps
from test_torch_port_indoor_train import (GEOM_MARGIN, _level_inputs,
                                          _margins, biases_before_bn)

TOL = 2e-3                 # the cross-framework slice tolerance
MODULE_TOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-5
GRAD_TOL = 2e-2
STATS_TOL = 1e-3
PIXEL_MARGIN = 1e-4
MARGIN = 1e-5
STEPS = 3
MAX_GT = 12
VIEWS = 3
TARGETS_SEED = 0           # GT whose geometric margins hold (asserted)
SLICE_SEED = 104           # the slice batch; its margins are asserted too


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _corners(rng, n, spread=2.0):
    lo = rng.uniform(-spread, spread, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(0.2, 1.5, (n, 3))],
                          -1).astype(np.float32)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_scannet_bbox_pred_to_bbox_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.randn(40, 3).astype(np.float32)
    pred = rng.uniform(0.05, 2.0, (40, 6)).astype(np.float32)
    want = np.asarray(jax_ivh.scannet_bbox_pred_to_bbox(_j(pts), _j(pred)))
    got = ivh.scannet_bbox_pred_to_bbox(_t(pts), _t(pred)).numpy()
    np.testing.assert_array_equal(got, want)
    got3 = ivh.scannet_bbox_pred_to_bbox(_t(pts).reshape(4, 10, 3),
                                         _t(pred).reshape(4, 10, 6))
    np.testing.assert_array_equal(got3.reshape(40, 6).numpy(), got)


@pytest.mark.parametrize('is_aligned', [False, True],
                         ids=['pairwise', 'aligned'])
def test_axis_aligned_overlaps_match_jax(is_aligned):
    rng = np.random.RandomState(1)
    a, b = _corners(rng, 30), _corners(rng, 30 if is_aligned else 20)
    b[:5] = a[:5]                        # identical
    b[5:8] = a[5:8] + 10.0               # disjoint
    want = np.asarray(jax_iou.axis_aligned_bbox_overlaps_3d(
        _j(a), _j(b), is_aligned=is_aligned))
    got = iou_ops.axis_aligned_bbox_overlaps_3d(_t(a), _t(b),
                                                is_aligned=is_aligned)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert 0 < (want > 0).mean() < 1


def test_axis_aligned_iou_loss_and_gradient_match_jax():
    rng = np.random.RandomState(2)
    target = _corners(rng, 50)
    pred = target + 0.2 * rng.randn(50, 6).astype(np.float32)
    w = rng.uniform(0, 1, 50).astype(np.float32)

    def jax_loss(p):
        return jax_losses.axis_aligned_iou_loss(p, _j(target), weight=_j(w),
                                                avg_factor=float(w.sum()))
    want, want_g = jax.value_and_grad(jax_loss)(_j(pred))
    p = _t(pred).requires_grad_()
    got = losses.axis_aligned_iou_loss(p, _t(target), weight=_t(w),
                                       avg_factor=_t(w.sum()))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=MODULE_TOL)
    scale = np.abs(np.asarray(want_g)).max()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=MODULE_TOL * scale)


def _nms_inputs(rng, b, n):
    """``b`` samples of ``n`` clustered corner boxes over 3 classes with
    forced exact score ties (scores from 7 values; pairs of identical boxes
    with equal scores), some rows invalid."""
    centers = rng.uniform(-1.5, 1.5, (b, n, 3))
    size = rng.uniform(0.4, 1.2, (b, n, 3))
    boxes = np.concatenate([centers - size / 2, centers + size / 2], -1)
    boxes[:, 1::7] = boxes[:, ::7][:, :boxes[:, 1::7].shape[1]]
    scores = rng.choice(np.linspace(0.1, 0.7, 7), (b, n))
    scores[:, 1::7] = scores[:, ::7][:, :scores[:, 1::7].shape[1]]
    classes = rng.randint(0, 3, (b, n))
    classes[:, 1::7] = classes[:, ::7][:, :classes[:, 1::7].shape[1]]
    valid = rng.uniform(size=(b, n)) > 0.15
    return (boxes.astype(np.float32), scores.astype(np.float32),
            classes.astype(np.int32), valid)


def test_aligned_nms_with_score_ties_matches_jax():
    """The batched port against ``aligned_3d_nms`` per sample: equal scores
    rank highest index first, so of two identical boxes with one score the
    later one is kept; the dominance mask walked by the scan's plain version
    gives the fixpoint's answer."""
    boxes, scores, classes, valid = _nms_inputs(np.random.RandomState(3), 3,
                                                60)
    thr = 0.25
    want = np.stack([np.asarray(jax_nms.aligned_3d_nms(
        _j(boxes[i]), _j(scores[i]), _j(classes[i]), _j(valid[i]), thr))
        for i in range(3)])
    got = nms_ops.aligned_3d_nms(_t(boxes), _t(scores), _t(classes),
                                 _t(valid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < valid.sum()
    # a tied identical pair, both valid: the higher index survives
    pairs = [(s, i) for s in range(3) for i in range(0, 59, 7)
             if valid[s, i] and valid[s, i + 1]]
    assert pairs
    assert not any(got[s, i] for s, i in pairs)
    assert any(got[s, i + 1] for s, i in pairs)
    # one sample alone, unbatched
    np.testing.assert_array_equal(nms_ops.aligned_3d_nms(
        _t(boxes[1]), _t(scores[1]), _t(classes[1]), _t(valid[1]),
        thr).numpy(), want[1])
    # the kernel path's algorithm: mask in rank order, then the scan
    order = torch.argsort(torch.where(_t(valid), _t(scores),
                                      torch.tensor(-1e10)), dim=-1,
                          stable=True).flip(-1)
    sb, sc, sv = (torch.take_along_dim(_t(x), order[..., None] if x.ndim == 3
                                       else order, dim=1)
                  for x in (boxes, classes, valid))
    mask = nms_ops.aligned_dominance_mask(sb, sc, thr)
    assert mask.shape == (3, 60, 2) and mask.dtype == torch.int32
    np.testing.assert_array_equal(
        nms_ops.nms_scan_plain(mask, sv).numpy(),
        nms_ops.aligned_nms_presorted_plain(sb, sc, sv, thr).numpy())


KINDS = ('v1', 'v2')


def _cfgs(kind):
    return tiny_scannet_cfgs(fast=kind == 'v2')


def _targets_gt(seed):
    """Padded GT of 3 rooms at the tiny grid: two furnished, one empty."""
    boxes, labels, mask = synthetic.room_boxes(np.random.RandomState(seed), 3,
                                               MAX_GT, n_classes=3)
    boxes[2], mask[2] = 0.0, False
    return boxes, labels, mask


def test_targets_fixture_keeps_its_margins():
    for kind in KINDS:
        _, cfg = _cfgs(kind)
        boxes, _, mask = _targets_gt(TARGETS_SEED)
        points, _, _ = _level_inputs(cfg, torch.tensor(
            [synthetic.SCANNET_ORIGIN] * 3))
        for s in (0, 1):
            assert min(_margins(points[s], boxes[s], mask[s], cfg)) \
                > GEOM_MARGIN, (kind, s)


@pytest.mark.parametrize('kind', KINDS)
def test_indoor_targets_match_jax(kind):
    """Labels exact; centerness and corner targets within 1e-5; positives
    on more than one level in the furnished rooms, none in the empty one;
    no (B, P, G, 6) tensor is stacked (the six face distances stay apart)."""
    jcfg, cfg = _cfgs(kind)
    boxes, labels, mask = _targets_gt(TARGETS_SEED)
    origins = torch.tensor([synthetic.SCANNET_ORIGIN] * 3)
    points, scales, rr = _level_inputs(cfg, origins)
    got = ivh.indoor_targets(points, scales, rr, _t(boxes), _t(labels),
                             _t(mask), cfg.indoor_head)
    fn = jax.vmap(lambda p, b, l, m: jax_ivh.indoor_targets(
        p, _j(scales), _j(rr), b, l, m, jcfg.indoor_head))
    ref = [np.asarray(x) for x in fn(_j(points), _j(boxes), _j(labels),
                                     _j(mask))]
    assert got[1].shape == ref[1].shape == (3, points.shape[1], 6)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), r, rtol=MODULE_TOL,
                                   atol=MODULE_TOL)
    lab, level = got[2].numpy(), scales.numpy()
    for s in (0, 1):
        assert len(np.unique(level[lab[s] >= 0])) >= 2, s
    assert (lab[2] == -1).all()


def _head_outs(rng, b, cfg, shift=-2.0):
    sizes = [tuple(n // 2 ** i for n in cfg.n_voxels) for i in range(3)]
    c = cfg.indoor_head.n_classes
    cen = [rng.randn(b, *s, 1).astype(np.float32) for s in sizes]
    box = [np.exp(0.3 * rng.randn(b, *s, 6)).astype(np.float32)
           for s in sizes]
    cls = [rng.randn(b, *s, c).astype(np.float32) + shift for s in sizes]
    return cen, box, cls


@pytest.mark.parametrize('kind', KINDS)
def test_indoor_head_loss_matches_jax(kind):
    jcfg, cfg = _cfgs(kind)
    batch = synthetic.scannet_train_batch(2, VIEWS, 'cpu', seed=SLICE_SEED,
                                          size=(128, 96), max_gt=MAX_GT,
                                          n_classes=3)
    rng = np.random.RandomState(7)
    heads = _head_outs(rng, 2, cfg)
    valid = rng.uniform(size=(2, *cfg.n_voxels)) > 0.3
    args = (valid, batch['origins'], batch['gt_boxes'], batch['gt_labels'],
            batch['gt_mask'])
    ref = jax_ivh.indoor_head_loss(
        tuple([_j(x) for x in lv] for lv in heads), *map(_j, args),
        jcfg.indoor_head)
    got = ivh.indoor_head_loss(tuple([_t(x) for x in lv] for lv in heads),
                               *map(_t, args), cfg.indoor_head)
    assert set(got) == set(ref) == {'loss_centerness', 'loss_bbox',
                                    'loss_cls'}
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=key)
        assert float(got[key]) > 0, key


def test_decode_matches_jax_at_b2_with_ties():
    """The batched ScanNet decode against the JAX ``vmap``: two samples
    that see different parts of the grid keep different numbers of boxes;
    exact score ties (copied logits) are broken as the JAX package breaks
    them."""
    jcfg, cfg = (dataclasses.replace(c, indoor_head=dataclasses.replace(
        c.indoor_head, max_out=120, score_thr=0.05)) for c in _cfgs('v1'))
    rng = np.random.RandomState(5)
    cen, box, cls = _head_outs(rng, 2, cfg, shift=0.0)
    for lv in range(3):
        n = cen[lv][0].size
        src, dst = rng.choice(n, 10, replace=False), rng.choice(n, 10,
                                                                replace=False)
        for t in (cen[lv], cls[lv], box[lv]):
            flat = t.reshape(2, n, -1)
            flat[:, dst] = flat[:, src]
    valid = np.zeros((2, *cfg.n_voxels), bool)
    valid[0] = True
    valid[1, 3:12, 2:9, 1:7] = True
    origins = np.array([synthetic.SCANNET_ORIGIN] * 2, np.float32)
    heads = (cen, box, cls)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda h, v, o: jax_ivh.indoor_head_get_bboxes(
            h, v, o, jcfg.indoor_head))(
        [[_j(x) for x in lv] for lv in heads], _j(valid), _j(origins)))
    got = ivh.indoor_head_get_bboxes([[_t(x) for x in lv] for lv in heads],
                                     _t(valid), _t(origins), cfg.indoor_head)
    got = {k: v.numpy() for k, v in got.items()}
    assert got['boxes'].shape == (2, 120, 7)
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=1e-5,
                               atol=1e-5)
    n_kept = got['valid'].sum(1)
    assert n_kept[0] != n_kept[1] and n_kept.min() > 0 and \
        n_kept.max() < 120, n_kept
    assert (got['boxes'][..., 6] == 0).all()


# --------------------------------------------------------------------------
# the slice: 3 views, forward + decode, and 3 training steps
# --------------------------------------------------------------------------

def _batch_np(b=2):
    batch = synthetic.scannet_train_batch(b, VIEWS, 'cpu', seed=SLICE_SEED,
                                          size=(128, 96), max_gt=MAX_GT,
                                          n_classes=3)
    return {k: v.numpy() for k, v in batch.items()}


def _variables(jcfg, batch_np, seed, cls_bias=None):
    variables = jax_variables(jcfg, batch_np, seed=seed, cls_bias=cls_bias)
    variables['params']['bbox_head']['reg_conv']['kernel'] *= 0.1
    return variables


def _candidates(cfg, head, valid, origins):
    """The port's NMS candidates (plain path): each level's best voxel
    scores, every candidate's class scores, corner boxes and validity."""
    hc = cfg.indoor_head
    b = valid.shape[0]
    sizes = [tuple(x.shape[1:4]) for x in head[0]]
    valids = ivh.resize_valid_to_levels(valid, sizes)
    pts = ivh.mlvl_points(sizes, hc.voxel_size, origins)
    boxes, scores, level_scores = [], [], []
    for c, bp, cls, v, p in zip(*head, valids, pts):
        s = (torch.sigmoid(cls.reshape(b, -1, hc.n_classes))
             * torch.sigmoid(c.reshape(b, -1, 1)) * v.reshape(b, -1, 1))
        level_scores.append(s.max(-1).values)
        _, ids = nms_ops.top_k(s.max(-1).values, hc.nms_pre)
        rows = torch.arange(b)[:, None]
        boxes.append(ivh.scannet_bbox_pred_to_bbox(
            p[rows, ids], bp.reshape(b, -1, 6)[rows, ids]))
        scores.append(s[rows, ids])
    return level_scores, torch.cat(scores, 1), torch.cat(boxes, 1)


@pytest.fixture(scope='module')
def serving():
    jcfg, cfg = _cfgs('v1')
    batch_np = _batch_np()
    variables = _variables(jcfg, batch_np, seed=6, cls_bias=0.0)
    model = jax_det.ImVoxelNet(jcfg)

    @jax.jit
    def forward(variables, batch):
        head_outs, valid, f2d = model.apply(variables, batch, train=False)
        return head_outs, valid, jax_det.imvoxelnet_predict(
            jcfg, head_outs, valid, f2d, batch)

    head, valid, res = jax.tree_util.tree_map(np.asarray, forward(
        variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    tmodel = port_model(cfg, variables)
    tbatch = to_torch(batch_np)
    with torch.no_grad():
        outs = tmodel(tbatch)
        t_res = detector.imvoxelnet_predict(cfg, outs[0], outs[1],
                                            tbatch['origins'])
    return dict(cfg=cfg, batch_np=batch_np, jax_head=head, jax_valid=valid,
                jax_res=res, outs=outs, origins=tbatch['origins'],
                res={k: v.numpy() for k, v in t_res.items()})


def test_slice_fixture_keeps_its_margins(serving):
    """Pixel rounding in all 3 views and the GT's geometry (training), and
    for the decode: the candidate cut per level, each candidate's best
    class, the score threshold, the ranking, and the IoUs that decide a
    suppression stay clear of float noise; NMS keeps some candidates and
    suppresses others."""
    cfg, batch_np = serving['cfg'], serving['batch_np']
    hc = cfg.indoor_head
    assert batch_np['extrinsics'].shape[1] == VIEWS
    assert projection_margin(cfg.n_voxels, cfg.voxel_size,
                             batch_np) > PIXEL_MARGIN
    points, _, _ = _level_inputs(cfg, torch.from_numpy(batch_np['origins']))
    for s in range(2):
        assert min(_margins(points[s], batch_np['gt_boxes'][s],
                            batch_np['gt_mask'][s], cfg)) > GEOM_MARGIN, s
    head, valid = serving['outs']
    level_scores, scores, boxes = _candidates(cfg, head, valid,
                                              serving['origins'])
    for s in level_scores:
        r = np.sort(s.numpy(), -1)[:, ::-1]
        if hc.nms_pre < r.shape[1]:
            assert ((r[:, hc.nms_pre - 1] - r[:, hc.nms_pre] > MARGIN)
                    | (r[:, hc.nms_pre] == 0)).all()
    top2 = torch.topk(scores, 2, dim=-1).values
    s = top2[..., 0]
    # (a voxel no view sees scores exactly 0 in every class: label 0 in both)
    assert ((top2[..., 0] - top2[..., 1] > MARGIN) | (s == 0)).all()
    assert (s - hc.score_thr).abs().min() > MARGIN
    lab = scores.argmax(-1)
    offered = s > hc.score_thr
    keep = nms_ops.aligned_3d_nms(boxes, s, lab, offered, hc.iou_thr)
    iou = iou_ops.axis_aligned_bbox_overlaps_3d(boxes, boxes)
    same = (lab[..., :, None] == lab[..., None, :]) & offered[..., :, None] \
        & offered[..., None, :]
    deciding = iou[keep[..., :, None] & same
                   & (s[..., :, None] > s[..., None, :])]
    assert (deciding - hc.iou_thr).abs().min() > MARGIN
    # the rank between candidates that may suppress one another, and among
    # the max_out + 1 best kept ones
    rivals = same & (iou > hc.iou_thr) & ~torch.eye(s.shape[1], dtype=bool)
    assert (s[..., :, None] - s[..., None, :]).abs()[rivals].min() > MARGIN
    kept = torch.where(keep, s, torch.zeros(()))
    assert _gaps(kept.numpy(), hc.max_out).min() > MARGIN
    assert 0 < int(keep.sum()) < int(offered.sum())


def test_slice_matches_jax(serving):
    """Seen voxels (3 views), labels and valid exact; head outputs, boxes and
    scores within 2e-3; yaw 0."""
    head, valid = serving['outs']
    np.testing.assert_array_equal(valid.numpy(), serving['jax_valid'])
    assert 0 < serving['jax_valid'].mean() < 1
    for i in range(3):
        for g, w in zip(head[i], serving['jax_head'][i]):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    got, want = serving['res'], serving['jax_res']
    assert set(got) == set(want) == {'boxes', 'scores', 'labels', 'valid'}
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    assert got['valid'].sum(1).min() > 0
    for key in ('scores', 'boxes'):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)


SPE, LR_STEPS = 1, (1, 2)


@pytest.fixture(scope='module')
def slice_run():
    from imvoxelnet_tpu.configs import presets as jax_presets

    jcfg, cfg = _cfgs('v1')
    preset = jax_presets.get_preset('imvoxelnet_scannet')
    batch_np = _batch_np()
    variables = _variables(jcfg, batch_np, seed=9)
    lr = preset.lr * 0.1
    opt_args = (lr, preset.weight_decay, preset.backbone_lr_mult,
                preset.grad_clip_norm)
    model = jax_det.ImVoxelNet(jcfg)
    tx = recording(jax_train.make_optimizer(*opt_args, steps_per_epoch=SPE,
                                            lr_steps=LR_STEPS))
    train_step = jax.jit(jax_train.make_train_step(model, tx))
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jax_losses_, jax_grads = [], None
    for _ in range(STEPS):
        state, metrics = train_step(state, batch)
        jax_losses_.append({k: float(v) for k, v in metrics.items()})
        jax_grads = state.opt_state[0] if jax_grads is None else jax_grads
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731

    tmodel = port_model(cfg, variables)
    opt, sched = train.make_optimizer(tmodel, *opt_args, steps_per_epoch=SPE,
                                      lr_steps=LR_STEPS)
    step = train.make_train_step(tmodel, opt, sched)
    tbatch = to_torch(batch_np)
    probe = port_model(cfg, variables).train()
    for name, p in probe.named_parameters():
        p.requires_grad_(train.param_label(name) != 'frozen')
    head_outs, valid = probe(tbatch)
    sum(detector.imvoxelnet_loss(cfg, head_outs, tbatch,
                                 valid).values()).backward()
    port_grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in probe.named_parameters() if p.requires_grad}
    port_losses = [{k: float(v) for k, v in step(tbatch).items()}
                   for _ in range(STEPS)]
    return dict(cfg=cfg, variables=variables, jax_losses=jax_losses_,
                port_losses=port_losses, port_grads=port_grads,
                jax_grads=from_jax_variables(
                    {'params': to_np(jax_grads),
                     'batch_stats': variables['batch_stats']}, cfg),
                jax_after=from_jax_variables(
                    {'params': to_np(state.params),
                     'batch_stats': to_np(state.batch_stats)}, cfg),
                port_after=tmodel.state_dict(), lr=lr)


def test_slice_losses_match_jax_every_step(slice_run):
    jl, pl = slice_run['jax_losses'], slice_run['port_losses']
    assert len(jl) == len(pl) == STEPS
    for i, (j, p) in enumerate(zip(jl, pl)):
        assert set(j) == set(p) == {'loss_centerness', 'loss_bbox',
                                    'loss_cls', 'loss'}
        for key in j:
            np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f'step {i} {key}')
    assert pl[0]['loss_bbox'] > 0 and pl[-1]['loss'] < pl[0]['loss']


def test_slice_first_step_gradients_match_jax(slice_run):
    jg, pg = slice_run['jax_grads'], slice_run['port_grads']
    noise = biases_before_bn(port_model(slice_run['cfg'],
                                        slice_run['variables']))
    nonzero = set()
    for name, got in pg.items():
        want = jg[name].numpy()
        if name in noise:
            scale = np.abs(jg[name.replace('bias', 'weight')].numpy()).max()
            assert np.abs(want).max() < 1e-4 * scale, name
            assert got.abs().max() < 1e-4 * scale, name
            continue
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)
        if scale > 0:
            nonzero.add(name)
    for name in ('backbone.layer2.0.conv1.weight',
                 'neck.lateral_convs.0.conv.weight',
                 'bbox_head.centerness_conv.weight',
                 'bbox_head.reg_conv.weight', 'bbox_head.cls_conv.weight'):
        assert name in nonzero, name


def test_slice_state_matches_jax_after_the_steps(slice_run):
    ja, pa, lr = slice_run['jax_after'], slice_run['port_after'], \
        slice_run['lr']
    for key, got in pa.items():
        if key.startswith('neck_3d.') and key.endswith(('running_mean',
                                                        'running_var')):
            np.testing.assert_allclose(got.numpy(), ja[key].numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=key)
    atol = 2 * lr * sum(0.1 ** i for i in range(STEPS))
    for key, got in pa.items():
        if key.endswith(('weight', 'bias')):
            np.testing.assert_allclose(got.numpy(), ja[key].numpy(), rtol=0,
                                       atol=atol, err_msg=key)
