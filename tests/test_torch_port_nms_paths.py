"""The NMS and loss paths that no preset takes, against the JAX package on
the CPU: ``rotated_nms_bev``, ``normal_nms_bev`` and
``multiclass_nms_3d_exact`` (rotated and axis-aligned) on boxes with
deliberate score ties, the heads' decode with ``pre_nms_k=0`` and
``use_rotate_nms=False``, and ``giou_3d_loss`` with its gradients.  Also the
card's route of the exact NMS (over-threshold bits, their gather into each
group's rank order, the scan), emulated here with the kernels' plain
versions.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.models.heads import anchor3d_head as jax_a3d
from imvoxelnet_tpu.models.heads import imvoxel_heads as jax_ivh
from imvoxelnet_tpu.ops import losses as jax_losses
from imvoxelnet_tpu.ops import nms as jax_nms
from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import losses as loss_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops

from _torch_port_fixtures import tiny_indoor_cfgs
from test_torch_port_indoor import _head_outs_with_ties
from test_torch_port_nms import _head_outs

N = 48
# the JAX references compiled without LLVM's optimizations: the same
# results, in half the compile time of the clip's gradient
FAST_COMPILE = {'xla_backend_optimization_level': 0}


def _jax_call(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def _t(a):
    return torch.from_numpy(np.array(a))


def _candidates(seed, n=N, n_classes=3):
    """Overlapping BEV boxes, their 7-dof boxes, scores on a grid of 1/8
    (many exact ties, some between overlapping boxes) and a validity mask."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 5, (n, 2))
    wh = rng.uniform(0.5, 2.0, (n, 2))
    yaw = rng.uniform(-np.pi, np.pi, (n, 1))
    bev = np.concatenate([xy, wh, yaw], -1).astype(np.float32)
    bev[1] = bev[0]                                  # identical pair
    boxes = np.concatenate([xy, rng.uniform(-1, 0, (n, 1)), wh,
                            rng.uniform(0.5, 2, (n, 1)), yaw],
                           -1).astype(np.float32)
    scores = (rng.randint(0, 9, (n, n_classes)) / 8).astype(np.float32)
    scores[1] = scores[0]
    valid = rng.uniform(size=n) > 0.15
    return bev, boxes, scores, valid


def _assert_tied(scores, valid):
    kept = scores[valid]
    assert len(np.unique(kept)) < len(kept) // 2   # the ties are many


@pytest.mark.parametrize('name', ['rotated_nms_bev', 'normal_nms_bev'])
def test_bev_nms_matches_jax_with_ties(name):
    bev, _, scores, valid = _candidates(0)
    _assert_tied(scores[:, 0], valid)
    args = (jnp.asarray(bev), jnp.asarray(scores[:, 0]), jnp.asarray(valid))
    jax_fn = jax.jit(getattr(jax_nms, name)).lower(
        *args, 0.0).compile(FAST_COMPILE)      # one compile, both thresholds
    for thr in (0.05, 0.3):
        want = np.asarray(jax_fn(*args, thr))
        got = getattr(nms_ops, name)(_t(bev), _t(scores[:, 0]), _t(valid),
                                     thr).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize('use_rotate_nms', [True, False])
def test_multiclass_nms_exact_matches_jax_with_ties(use_rotate_nms):
    out = {}
    for seed in (1, 2):
        bev, boxes, scores, valid = _candidates(seed)
        dirs = np.random.RandomState(seed).randint(0, 2, N).astype(
            np.float32)
        kw = dict(score_thr=0.2, max_num=160, iou_thr=0.1,
                  use_rotate_nms=use_rotate_nms)
        want = jax_nms.multiclass_nms_3d_exact.lower(
            jnp.asarray(boxes), jnp.asarray(bev), jnp.asarray(scores),
            jnp.asarray(valid), mlvl_dir_scores=jnp.asarray(dirs),
            **kw).compile(FAST_COMPILE)(
                jnp.asarray(boxes), jnp.asarray(bev), jnp.asarray(scores),
                jnp.asarray(valid), mlvl_dir_scores=jnp.asarray(dirs))
        got = nms_ops.multiclass_nms_3d_exact(
            _t(boxes), _t(bev), _t(scores), _t(valid),
            mlvl_dir_scores=_t(dirs), **kw)
        for key, val in want.items():
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(val),
                                          err_msg=key)
        out[seed] = got
        assert 0 < int(got["valid"].sum()) < 100
    # batched: two samples at once equal the two alone
    b = [_candidates(s) for s in (1, 2)]
    dirs = [np.random.RandomState(s).randint(0, 2, N).astype(np.float32)
            for s in (1, 2)]
    both = nms_ops.multiclass_nms_3d_exact(
        *[_t(np.stack([x[i] for x in b])) for i in (1, 0, 2, 3)],
        mlvl_dir_scores=_t(np.stack(dirs)), score_thr=0.2, max_num=160,
        iou_thr=0.1, use_rotate_nms=use_rotate_nms)
    for i, seed in enumerate((1, 2)):
        for key, val in out[seed].items():
            assert torch.equal(both[key][i], val), key


def _ranking(rng, shape, n_levels=6):
    """Scores on a grid (many exact ties), validity, and the rank order and
    validity in it that :func:`nms_ops._greedy` makes of them."""
    scores = _t(rng.randint(0, n_levels, shape).astype(np.float32))
    valid = _t(rng.uniform(size=shape) > 0.2)
    order = torch.argsort(torch.where(valid, scores, -1e10), dim=-1,
                          stable=True).flip(-1)
    return valid, order, torch.take_along_dim(valid, order, dim=-1)


def _packed_gather(iou, order, iou_thr):
    """The rank-order dominance mask as the card's route built it before the
    gather kernel: every group's thresholded IoU gathered into its rank
    order, above the diagonal, packed."""
    n = order.shape[-1]
    over = (iou > iou_thr).expand(order.shape[:-1] + (n, n))
    ranked = torch.take_along_dim(
        torch.take_along_dim(over, order[..., :, None], dim=-2),
        order[..., None, :], dim=-1)
    idx = torch.arange(n)
    return iou_ops.pack_mask(ranked & (idx[:, None] < idx[None, :])).reshape(
        -1, n, (n + 31) // 32)


@pytest.mark.parametrize('shared', [True, False],
                         ids=['matrix_per_sample', 'matrix_per_group'])
@pytest.mark.parametrize('n', [33, 40])
def test_rank_order_mask_and_scan_equal_the_fixpoint(monkeypatch, n, shared):
    """The card's route of ``nms_in_rank_order``: each IoU matrix's bits
    thresholded and packed once, gathered into each group's rank order and
    scanned over all groups (the gather and the scan by their plain
    versions); one matrix per sample serving its 3 classes, or one per
    group.  Exact score ties, and IoUs equal to the threshold."""
    rng = np.random.RandomState(3)
    iou = rng.uniform(size=(2, 1 if shared else 3, n, n)).astype(np.float32)
    iou = (iou + iou.transpose(0, 1, 3, 2)) / 2
    iou[rng.uniform(size=iou.shape) < 0.1] = 0.6
    iou = _t(iou)
    valid, order, valid_sorted = _ranking(rng, (2, 3, n))
    monkeypatch.setattr(clip_kernel, 'nms_rank_op',
                        nms_ops.nms_rank_mask_plain)
    monkeypatch.setattr(clip_kernel, 'nms_scan_op', nms_ops.nms_scan_plain)
    keep = nms_ops.ranked_nms_scan(iou_ops.pack_mask(iou > 0.6), order,
                                   valid_sorted)
    want = nms_ops.nms_in_rank_order_plain(iou, order, valid_sorted, 0.6)
    assert torch.equal(keep, want)
    assert 0 < int(want.sum()) < int(valid.sum())
    assert bool((iou == 0.6).any())


@pytest.mark.parametrize('shared', [True, False],
                         ids=['matrix_per_sample', 'matrix_per_group'])
@pytest.mark.parametrize('n', [33, 40])
def test_exact_nms_entries_plain_equal_the_packed_gather(n, shared):
    """The plain versions of the two exact-NMS kernels: the over-threshold
    bits of rotated boxes equal the packed ``rotated_iou_bev > thr`` (the
    threshold is one of the IoUs, and boxes 0 and 1 are identical), and
    their gather into each group's rank order equals the packed gather of
    the thresholded IoU.  Through the scan they give the fixpoint's keep."""
    rng = np.random.RandomState(n)
    groups = 1 if shared else 3
    bev, _, _, _ = _candidates(n, n)
    boxes = _t(np.stack([bev] + [_candidates(n + k, n)[0]
                                  for k in (1, 2)]))[:, None].expand(
        3, groups, n, 5).clone()
    if not shared:
        boxes[:, 1:, :, :2] += _t(rng.uniform(-0.3, 0.3, (3, 2, n, 2))
                                  .astype(np.float32))
    iou = iou_ops.rotated_iou_bev(boxes, boxes)
    thr = float(iou[0, 0][(iou[0, 0] > 0.1) & (iou[0, 0] < 0.5)][0])
    corners = box_ops.bev_corners(boxes).reshape(-1, n, 4, 2)
    areas = (boxes[..., 2] * boxes[..., 3]).reshape(-1, n)
    over = iou_ops.nms_over_bits_plain(corners, areas, thr)
    assert torch.equal(over, iou_ops.pack_mask(iou > thr).reshape(over.shape))
    valid, order, valid_sorted = _ranking(rng, (3, 3, n))
    src = torch.arange(3 * groups).reshape(3, groups).expand(3, 3).reshape(-1)
    mask = nms_ops.nms_rank_mask_plain(over, order.reshape(-1, n), src)
    assert torch.equal(mask, _packed_gather(iou, order, thr))
    keep = nms_ops.nms_scan_plain(mask, valid_sorted.reshape(-1, n))
    want = nms_ops.nms_in_rank_order_plain(iou, order, valid_sorted, thr)
    assert torch.equal(keep.reshape(3, 3, n), want)
    assert 0 < int(want.sum()) < int(valid.sum())
    assert bool((iou == thr).any())


def test_indoor_decode_untruncated_matches_jax():
    """``pre_nms_k <= 0``: every level's candidates (N = 3 x 64) go through
    the exact NMS, in both packages, on maps with exact score ties."""
    jcfg, cfg = tiny_indoor_cfgs()
    jhead = dataclasses.replace(jcfg.indoor_head, pre_nms_k=0)
    head = dataclasses.replace(cfg.indoor_head, pre_nms_k=0)
    rng = np.random.RandomState(5)
    sizes = [(16, 16, 8), (8, 8, 4), (4, 4, 2)]
    outs = _head_outs_with_ties(rng, 2, head.n_classes, sizes)
    valid = np.zeros((2, 16, 16, 8), bool)
    valid[0] = True
    valid[1, 2:10, 4:10, 1:5] = True
    origins = np.array([[0.0, 3.0, -1.0]] * 2, np.float32)
    want = _jax_call(lambda h, v, o: jax_ivh.indoor_head_get_bboxes(
        h, v, o, jhead), [[jnp.asarray(x) for x in lv] for lv in outs],
        jnp.asarray(valid), jnp.asarray(origins))
    got = ivh.indoor_head_get_bboxes(
        [[_t(x) for x in lv] for lv in outs], _t(valid), _t(origins), head)
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(want['valid']))
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(want['labels']))
    np.testing.assert_allclose(got['scores'].numpy(),
                               np.asarray(want['scores']), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got['boxes'].numpy(),
                               np.asarray(want['boxes']), rtol=1e-5,
                               atol=1e-5)
    trunc = ivh.indoor_head_get_bboxes(
        [[_t(x) for x in lv] for lv in outs], _t(valid), _t(origins),
        cfg.indoor_head)
    assert int(got['valid'].sum()) > 0
    assert not torch.equal(got['boxes'], trunc['boxes'])


def test_anchor_decode_without_rotation_matches_jax():
    """``use_rotate_nms=False``: the axis-aligned BEV NMS of each class's
    candidates, on maps with exact ties and samples of many, few and no
    detections."""
    outs = _head_outs()
    jcfg = dataclasses.replace(
        jax_presets.get_preset('tiny_kitti_test').model.anchor_head,
        use_rotate_nms=False)
    cfg = dataclasses.replace(
        presets.get_preset('tiny_kitti_test').model.anchor_head,
        use_rotate_nms=False)
    want = jax_a3d.anchor3d_head_get_bboxes(
        tuple(jnp.asarray(o) for o in outs), jcfg)
    got = a3d.anchor3d_head_get_bboxes(tuple(_t(o) for o in outs), cfg)
    for key in ('valid', 'labels'):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    for key in ('boxes', 'scores'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5)
    n_det = got['valid'].sum(1)
    assert n_det[0] > 0 and n_det[2] == 0


def test_giou_3d_loss_and_gradients_match_jax():
    rng = np.random.RandomState(7)
    n = 64
    target = np.concatenate([rng.uniform(-2, 2, (n, 3)),
                             rng.uniform(0.3, 2, (n, 3)),
                             rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    pred = target + np.concatenate([0.2 * rng.randn(n, 3),
                                    0.1 * rng.randn(n, 3),
                                    0.3 * rng.randn(n, 1)], -1)
    pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.05
    pred[:4, :2] += 10.0                             # disjoint pairs
    pred, target = pred.astype(np.float32), target.astype(np.float32)
    weight = rng.uniform(size=n).astype(np.float32)

    def jloss(p, t):
        return jax_losses.giou_3d_loss(p, t, jnp.asarray(weight),
                                       avg_factor=9.0, loss_weight=2.0)
    want, (gp, gt) = _jax_call(jax.value_and_grad(jloss, argnums=(0, 1)),
                               jnp.asarray(pred), jnp.asarray(target))
    p, t = _t(pred).requires_grad_(True), _t(target).requires_grad_(True)
    got = loss_ops.giou_3d_loss(p, t, _t(weight), avg_factor=9.0,
                                loss_weight=2.0)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for g, w in ((p.grad, gp), (t.grad, gt)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # the enclosing box of a pair that overlaps nothing spans both boxes
    area = loss_ops._smallest_enclosing_area(_t(np.array(
        [[[0, 0], [1, 0], [1, 1], [0, 1], [3, 0], [4, 0], [4, 1], [3, 1]]],
        np.float32)))
    np.testing.assert_allclose(area.numpy(), [4.0], rtol=1e-6)
