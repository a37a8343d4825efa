"""The SUN RGB-D serving slice of the PyTorch port against the JAX package,
on the CPU.

Module by module (ImVoxelNeck, FastIndoorImVoxelNeck, IndoorHead v1 and v2,
the geometry helpers, the batched decode + NMS) and then the slice as a
whole: the JAX ``ImVoxelNet`` + ``imvoxelnet_predict`` and the port's on a
tiny ``imvoxelnet_sunrgbd`` (v1) and ``_fast`` configuration, with the same
weights (through ``from_jax_variables``) and the same numpy batch.  On CPU
tensors the port runs every kernel's plain version; the JAX side runs its
XLA path, whose rotated clip on the CPU is the jnp one that the port's plain
clip matches bit for bit.

The weights are random draws, not the reference's init: the encoder-decoder
blocks' ``bn2`` scales, zero at init, are drawn away from zero (asserted),
so that every block's second conv counts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models.heads import imvoxel_heads as jax_ivh
from imvoxelnet_tpu.ops import boxes as jax_boxes

from imvoxelnet_tpu_torch.models import detector
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops
from imvoxelnet_tpu_torch.utils import checkpoint

from _torch_port_fixtures import (jax_neck, jax_variables, port_model,
                                  projection_margin, random_tree,
                                  tiny_indoor_cfgs, tiny_sunrgbd_batch_np,
                                  to_torch)

# rtol/atol of the cross-framework full-detector tests
# (tests/test_full_detector_parity.py): f32 convs summed in another order
TOL = 2e-3
# pixel rounding: 25x the float32 rounding of a 32-pixel coordinate
PIXEL_MARGIN = 1e-4
# scores and IoUs that decide a ranking, a threshold or a suppression
MARGIN = 1e-5
SLICE_SEED = 39            # a geometry whose projection margin is 3.4e-4
KINDS = ('v1', 'fast')


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module', params=KINDS)
def setup(request):
    """Configs of both packages, a b=2 numpy batch and random weights with
    the cls bias at 0 (scores near 0.5 x centerness, above ``score_thr``)
    and the reg conv scaled down (boxes of about 2 m, as at the reference's
    init, so that boxes overlap and NMS suppresses)."""
    jcfg, cfg = tiny_indoor_cfgs(fast=request.param == 'fast')
    batch_np = tiny_sunrgbd_batch_np(2, seed=SLICE_SEED)
    variables = jax_variables(jcfg, batch_np, seed=6, cls_bias=0.0)
    variables['params']['bbox_head']['reg_conv']['kernel'] *= 0.1
    return request.param, jcfg, cfg, batch_np, variables


@pytest.fixture(scope='module')
def slice_outputs(setup):
    kind, jcfg, cfg, batch_np, variables = setup
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    model = jax_det.ImVoxelNet(jcfg)

    @jax.jit
    def forward(variables, batch):
        head_outs, valid, f2d = model.apply(variables, batch, train=False)
        return head_outs, valid, jax_det.imvoxelnet_predict(
            jcfg, head_outs, valid, f2d, batch)

    head_outs, valid, res = _np(forward(variables, batch))
    tmodel = port_model(cfg, variables)
    tbatch = to_torch(batch_np)
    with torch.no_grad():
        t_head, t_valid = tmodel(tbatch)
        t_res = detector.imvoxelnet_predict(cfg, t_head, t_valid,
                                            tbatch['origins'])
    port_out = dict(valid=t_valid.numpy(),
                    head=[[lv.numpy() for lv in o] for o in t_head],
                    res={k: v.numpy() for k, v in t_res.items()},
                    t_head=t_head, t_valid=t_valid, origins=tbatch['origins'])
    jax_out = dict(valid=valid, head=head_outs, res=res)
    return kind, jcfg, cfg, batch_np, jax_out, port_out


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_neck_matches_jax(setup):
    kind, jcfg, cfg, _, variables = setup
    neck_vars = {'params': variables['params']['neck_3d'],
                 'batch_stats': variables['batch_stats']['neck_3d']}
    rng = np.random.RandomState(1)
    cin = cfg.neck.channels[0] if kind == 'v1' else cfg.neck.in_channels
    x = rng.randn(2, *cfg.n_voxels, cin).astype(np.float32)
    want = jax_neck(jcfg).apply(neck_vars, jnp.asarray(x), train=False)

    neck = detector.build_neck(cfg.neck)
    neck.load_state_dict({k[len('neck_3d.'):]: v for k, v in
                          checkpoint.neck_state_dict(
                              cfg.neck, neck_vars['params'],
                              neck_vars['batch_stats']).items()},
                         strict=True)
    bn2 = [m.bn2.weight for m in neck.modules()
           if hasattr(m, 'zero_init_bn2') and m.zero_init_bn2]
    assert (kind == 'fast') != bool(bn2)
    assert all(bool((w.abs() > 0.1).all()) for w in bn2)
    with torch.no_grad():
        got = neck.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert len(got) == len(want) == 3
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape[2:] == tuple(s >> lvl for s in cfg.n_voxels)
        np.testing.assert_allclose(g.permute(0, 2, 3, 4, 1).numpy(),
                                   np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f'level {lvl}')


@pytest.mark.parametrize('version,n_convs', [(1, 0), (1, 2), (2, 0)],
                         ids=['v1', 'v1-towers', 'v2'])
def test_head_matches_jax(version, n_convs):
    jcfg, cfg = tiny_indoor_cfgs(version=version, n_convs=n_convs)
    rng = np.random.RandomState(2)
    xs = [rng.randn(2, 16 >> i, 16 >> i, 8 >> i, 16).astype(np.float32)
          for i in range(3)]
    jxs = [jnp.asarray(x) for x in xs]
    jhead = jax_ivh.IndoorHead(jcfg.indoor_head)
    shapes = jax.eval_shape(
        lambda x: jhead.init(jax.random.PRNGKey(0), x, train=False), jxs)
    variables = random_tree(shapes, rng)
    want = _np(jhead.apply(variables, jxs, train=False))

    head = ivh.IndoorHead(cfg.indoor_head, 16)
    sd = checkpoint.head_state_dict(cfg, variables['params'],
                                    variables.get('batch_stats', {}))
    head.load_state_dict({k[len('bbox_head.'):]: v for k, v in sd.items()},
                         strict=True)
    assert len(head.reg_convs) == (n_convs if version == 1 else 0)
    with torch.no_grad():
        got = head.eval()([torch.from_numpy(x).permute(0, 4, 1, 2, 3)
                           for x in xs])
    for name, g_levels, w_levels in zip(('centerness', 'bbox', 'cls'), got,
                                        want):
        for lvl, (g, w) in enumerate(zip(g_levels, w_levels)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                       err_msg=f'{name} level {lvl}')


def test_box_geometry_matches_jax():
    rng = np.random.RandomState(3)
    pts = rng.randn(50, 3).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.1, 2.0, (50, 6)),
                           rng.uniform(-np.pi, np.pi, (50, 1))],
                          -1).astype(np.float32)
    want = np.asarray(jax_ivh.sunrgbd_bbox_pred_to_bbox(
        jnp.asarray(pts), jnp.asarray(pred)))
    got = ivh.sunrgbd_bbox_pred_to_bbox(torch.from_numpy(pts),
                                        torch.from_numpy(pred)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # with leading batch dims
    got3 = ivh.sunrgbd_bbox_pred_to_bbox(
        torch.from_numpy(pts).reshape(5, 10, 3),
        torch.from_numpy(pred).reshape(5, 10, 7)).reshape(50, 7).numpy()
    np.testing.assert_array_equal(got3, got)

    v = rng.randn(4, 6, 3).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    np.testing.assert_allclose(
        box_ops.rotation_3d_in_axis(torch.from_numpy(v),
                                    torch.from_numpy(ang)).numpy(),
        np.asarray(jax_boxes.rotation_3d_in_axis(
            jnp.asarray(v), jnp.asarray(ang), axis=2)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        box_ops.to_bottom_center(torch.tensor(want)).numpy(),
        np.asarray(jax_boxes.to_bottom_center(jnp.asarray(want))))


def test_mlvl_points_match_jax():
    sizes = [(16, 16, 8), (8, 8, 4), (4, 4, 2)]
    origins = np.array([[0.0, 3.0, -1.0], [0.1137, 2.9, -0.95]], np.float32)
    got = ivh.mlvl_points(sizes, (0.4, 0.4, 0.4), torch.from_numpy(origins))
    for i, o in enumerate(origins):
        want = jax_ivh.mlvl_points(sizes, (0.4, 0.4, 0.4), jnp.asarray(o))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)


def test_resize_valid_to_levels_matches_jax_exactly():
    """Blocks, islands and half-covered cells: rounding half to even and
    the half-pixel sampling positions must agree voxel for voxel."""
    rng = np.random.RandomState(4)
    mask = rng.rand(3, 16, 16, 8) > 0.6
    mask[1] = False
    mask[1, 3:11, 2:9, 1:6] = True
    mask[2, ::2] = True
    sizes = [(16, 16, 8), (8, 8, 4), (4, 4, 2)]
    want = jax_ivh.resize_valid_to_levels(jnp.asarray(mask), sizes)
    got = ivh.resize_valid_to_levels(torch.from_numpy(mask), sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[1].float().mean() < 1
    np.testing.assert_array_equal(got[0].numpy(), mask)


def _head_outs_with_ties(rng, b, n_classes, sizes):
    """Random head maps with exact score ties: every level copies its
    logits and centerness at 20 voxels from 20 others."""
    cents, bboxes, clss = [], [], []
    for size in sizes:
        n = int(np.prod(size))
        cent = rng.randn(b, n, 1).astype(np.float32)
        cls = rng.randn(b, n, n_classes).astype(np.float32)
        src, dst = rng.choice(n, 20, replace=False), rng.choice(n, 20,
                                                                replace=False)
        cent[:, dst], cls[:, dst] = cent[:, src], cls[:, src]
        bbox = np.concatenate([np.exp(0.3 * rng.randn(b, n, 6)),
                               rng.uniform(-np.pi, np.pi, (b, n, 1))], -1)
        cents.append(cent.reshape(b, *size, 1))
        clss.append(cls.reshape(b, *size, n_classes))
        bboxes.append(bbox.astype(np.float32).reshape(b, *size, 7))
    return cents, bboxes, clss


def test_get_bboxes_matches_jax_with_ties_at_b3():
    """The batched decode + NMS against the JAX ``vmap``: three samples
    that see different parts of the grid, so that each keeps a different
    number of boxes, with exact score ties (broken lowest index first in
    both) and exact zeros (unseen voxels)."""
    jcfg, cfg = tiny_indoor_cfgs()
    head_cfg = cfg.indoor_head
    rng = np.random.RandomState(5)
    sizes = [(16, 16, 8), (8, 8, 4), (4, 4, 2)]
    head = _head_outs_with_ties(rng, 3, head_cfg.n_classes, sizes)
    valid = np.zeros((3, 16, 16, 8), bool)
    valid[0] = True
    valid[1, 2:10, 4:10, 1:5] = True
    valid[2, 6:9, 5:9, 2:6] = True
    origins = np.array([[0.0, 3.0, -1.0]] * 3, np.float32)
    want = _np(jax.jit(lambda h, v, o: jax_ivh.indoor_head_get_bboxes(
        h, v, o, jcfg.indoor_head))(
            [[jnp.asarray(x) for x in lv] for lv in head],
            jnp.asarray(valid), jnp.asarray(origins)))
    got = ivh.indoor_head_get_bboxes(
        [[torch.from_numpy(x) for x in lv] for lv in head],
        torch.from_numpy(valid), torch.from_numpy(origins), head_cfg)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=1e-5,
                               atol=1e-5)
    n_kept = got['valid'].sum(1)
    assert len(set(n_kept.tolist())) == 3 and n_kept.min() > 0, n_kept


# --------------------------------------------------------------------------
# the slice
# --------------------------------------------------------------------------

def _gaps(scores, k):
    """Gaps between the distinct nonzero values among the ``k + 1`` largest
    of each row of ``scores (..., N)``."""
    rows = np.sort(scores.reshape(-1, scores.shape[-1]), -1)[:, ::-1]
    return np.concatenate([np.diff(np.unique(r[:k + 1][r[:k + 1] > 0]))
                           for r in rows])


def _candidates(cfg, head, valid, origins):
    """The port's NMS candidates (plain path): each level's best voxel
    scores, every candidate's class scores, and per sample and class the
    ``pre_nms_k`` best scores and their BEV boxes."""
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
        boxes.append(ivh.sunrgbd_bbox_pred_to_bbox(
            p[rows, ids], bp.reshape(b, -1, 7)[rows, ids]))
        scores.append(s[rows, ids])
    boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1).transpose(1, 2)
    top, idx = nms_ops.top_k(scores, hc.pre_nms_k)
    bev = box_ops.bev(boxes)[torch.arange(b)[:, None, None], idx]
    return level_scores, scores, top, bev


def test_slice_fixture_keeps_its_margins(slice_outputs):
    """Pixel rounding, the ranking of the candidates, the score threshold
    and the IoUs that decide a suppression stay clear of float noise; NMS
    keeps some candidates of every class list and suppresses others."""
    kind, jcfg, cfg, batch_np, _, port_out = slice_outputs
    hc = cfg.indoor_head
    assert projection_margin(jcfg.n_voxels, jcfg.voxel_size,
                             batch_np) > PIXEL_MARGIN
    level_scores, scores, top, bev = _candidates(
        cfg, port_out['t_head'], port_out['t_valid'], port_out['origins'])
    for s in level_scores:      # the cut between candidates and the rest
        r = np.sort(s.numpy(), -1)[:, ::-1]
        k = hc.nms_pre
        if k < r.shape[1]:
            assert ((r[:, k - 1] - r[:, k] > MARGIN) | (r[:, k] == 0)).all()
    assert _gaps(scores.numpy(), hc.pre_nms_k).min() > MARGIN
    top = top.numpy()
    assert np.abs(top - hc.score_thr).min() > MARGIN
    iou = iou_ops.rotated_iou_bev(bev, bev)
    offered = torch.from_numpy(top > hc.score_thr)
    keep = nms_ops.greedy_nms_from_iou_batched(iou, torch.zeros_like(
        offered, dtype=torch.float32), offered, hc.iou_thr, presorted=True)
    later = torch.ones(iou.shape[-2:], dtype=torch.bool).triu(1)
    deciding = iou[keep[..., :, None] & later]
    assert (deciding - hc.iou_thr).abs().min() > MARGIN
    assert bool((keep.sum(-1) > 0).all())
    assert int(keep.sum()) < int(offered.sum())


def test_slice_valid_mask_exact(slice_outputs):
    _, _, _, _, jax_out, port_out = slice_outputs
    np.testing.assert_array_equal(port_out['valid'], jax_out['valid'])
    assert 0 < port_out['valid'].mean() < 1


@pytest.mark.parametrize('i', [0, 1, 2], ids=['centerness', 'bbox', 'cls'])
def test_slice_head_outputs_match(slice_outputs, i):
    _, _, _, _, jax_out, port_out = slice_outputs
    assert len(port_out['head'][i]) == len(jax_out['head'][i]) == 3
    for lvl, (g, w) in enumerate(zip(port_out['head'][i],
                                     jax_out['head'][i])):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f'level {lvl}')


def test_slice_detections_match(slice_outputs):
    _, _, cfg, _, jax_out, port_out = slice_outputs
    want, got = jax_out['res'], port_out['res']
    assert got['boxes'].shape == (2, cfg.indoor_head.max_out, 7)
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    assert got['valid'].sum(1).min() > 0
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=TOL,
                               atol=TOL)


def test_state_dict_keys_are_the_reference_names():
    """The indoor necks' and head's names are those of the reference's
    modules (the torch replicas of ``tests/test_torch_parity.py`` and
    ``tests/test_full_detector_parity.py``), less the encoder-decoder's
    unused ``conv_blocks.3``."""
    from test_full_detector_parity import TorchIndoorHeadV2
    from test_torch_parity import TorchFastNeck, TorchImVoxelNeck

    from imvoxelnet_tpu_torch.models import necks3d

    ref = set(TorchImVoxelNeck(channels=(8, 12, 16, 24), out=8).state_dict())
    got = set(necks3d.ImVoxelNeck((8, 12, 16, 24), 8, (1, 1, 1, 1),
                                  (1, 1, 1)).state_dict())
    assert got == {k for k in ref if not k.startswith('conv_blocks.3.')}
    assert set(necks3d.FastIndoorImVoxelNeck(8, (1, 1, 1), 8).state_dict()) \
        == set(TorchFastNeck(cin=8, out=8).state_dict())
    _, cfg = tiny_indoor_cfgs(fast=True)
    assert set(ivh.IndoorHead(cfg.indoor_head, 16).state_dict()) == set(
        TorchIndoorHeadV2(16, 3, 7, 3).state_dict())
