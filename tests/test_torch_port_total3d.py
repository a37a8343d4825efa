"""The Total3D slice of the PyTorch port against the JAX package, on the CPU.

Module by module (``with_gravity_center``, the layout head, its loss and
the loss's gradient, ``predicted_extrinsics``, the ``head_2d`` weight
bridge) and then the slice as a whole on a tiny ``imvoxelnet_total_sunrgbd``
configuration (``tests/_torch_port_fixtures.py:tiny_total3d_cfgs``: the tiny
SUN RGB-D v1 model with the presets' layout head): the JAX ``ImVoxelNet`` +
``imvoxelnet_predict`` with ``use_predicted_extrinsics`` and the port's, and
``make_train_step`` for 3 steps against ``jax.jit`` of the JAX step, from the
same weights (``from_jax_variables``) and the same numpy batch
(``utils/synthetic.py:sunrgbd_train_batch(layout=True)`` at 128x96).  On CPU
tensors the port runs every kernel's plain version.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models.heads import layout_head as jax_lh
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.parallel import train as jax_train
from imvoxelnet_tpu.utils.checkpoint import convert_layout_head

from imvoxelnet_tpu_torch.models import detector
from imvoxelnet_tpu_torch.models.heads import layout_head as lh
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import synthetic
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

from _torch_port_fixtures import (jax_variables, port_model,
                                  projection_margin, random_tree, recording,
                                  tiny_total3d_cfgs, to_torch)
from test_torch_port_indoor import _candidates, _gaps

TOL = 2e-3                 # the cross-framework slice tolerance
MODULE_TOL = 1e-5          # module parity (float32, another op order)
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-5
GRAD_TOL = 2e-2
STATS_TOL = 1e-3
PIXEL_MARGIN = 1e-4
MARGIN = 1e-5
STEPS = 3
MAX_GT = 12
SLICE_SEED = 51            # a batch whose margins hold (asserted)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _layout_pairs(rng, b):
    """Predicted and GT layouts near each other (IoU well inside (0, 1)),
    angles within a few tenths of a radian."""
    gt = np.concatenate([rng.uniform(-0.5, 0.5, (b, 2)),
                         rng.uniform(-1.8, -1.6, (b, 1)),
                         rng.uniform(4.0, 7.0, (b, 3)),
                         rng.uniform(-0.2, 0.2, (b, 1))], -1)
    pred = gt + np.concatenate([0.3 * rng.randn(b, 3), 0.4 * rng.randn(b, 3),
                                0.1 * rng.randn(b, 1)], -1)
    pred[:, 2] += gt[:, 5] / 2                  # gravity center
    angles = rng.uniform(-0.3, 0.3, (b, 2))
    gt_angles = angles + 0.1 * rng.randn(b, 2)
    return [x.astype(np.float32) for x in (angles, pred, gt_angles, gt)]


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

def test_with_gravity_center_matches_jax():
    boxes = np.random.RandomState(0).randn(9, 7).astype(np.float32)
    np.testing.assert_array_equal(
        box_ops.with_gravity_center(_t(boxes)).numpy(),
        np.asarray(jax_boxes.with_gravity_center(_j(boxes))))


def _jax_layout_head(rng):
    head = jax_lh.LayoutHead(jax_lh.LayoutHeadConfig())
    x = rng.randn(3, 4, 5, 2048).astype(np.float32)
    shapes = jax.eval_shape(
        lambda a: head.init(jax.random.PRNGKey(0), a), _j(x))
    return head, random_tree(shapes, rng), x


def test_layout_head_matches_jax():
    """The two MLPs on the float32 C5 mean (bfloat16 C5 in, as the backbone
    gives it in bfloat16 runs), period-limited angles, exponentiated
    sizes."""
    rng = np.random.RandomState(1)
    head, variables, x = _jax_layout_head(rng)
    want = jax.tree_util.tree_map(
        np.asarray, head.apply(variables, _j(x).astype(jnp.float32)))
    sd = {}
    from imvoxelnet_tpu_torch.utils import checkpoint
    checkpoint._layout_head(sd, variables['params'])
    port = lh.LayoutHead(lh.LayoutHeadConfig())
    port.load_state_dict({k[len('head_2d.'):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2))
        got16 = port(_t(x).permute(0, 3, 1, 2).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=MODULE_TOL,
                                   atol=MODULE_TOL)
    assert (np.abs(want[0]) < np.pi / 2).all() and (want[1][:, 3:6] > 0).all()
    assert got16[0].dtype == torch.float32


@pytest.mark.parametrize('angles', [
    [[0.0, 0.0]], [[0.1, -0.05]], [[-0.3, 0.2], [0.7, -0.6]],
    [[np.pi / 4, np.pi / 4], [-np.pi / 2, 0.0], [1.2, -1.5]]],
    ids=['zero', 'small', 'two', 'large'])
def test_predicted_extrinsics_match_jax(angles):
    a = np.asarray(angles, np.float32)
    want = np.asarray(jax_lh.predicted_extrinsics(_j(a)))
    got = lh.predicted_extrinsics(_t(a)).numpy()
    assert got.shape == (len(a), 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # a rotation: orthonormal 3x3 block, [0, 0, 0, 1] last row
    r = got[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), r.shape), atol=1e-6)
    np.testing.assert_array_equal(got[:, 3], [[0, 0, 0, 1]] * len(a))


def test_predicted_extrinsics_rebuild_the_synthetic_cameras():
    """``gt_angles`` of the synthetic Total3D batch are the cameras' (pitch,
    roll): Total3D's rotation from them is the batch's extrinsic."""
    batch = synthetic.sunrgbd_train_batch(4, 'cpu', seed=3, size=(128, 96),
                                          max_gt=MAX_GT, layout=True)
    got = lh.predicted_extrinsics(batch['gt_angles'])
    np.testing.assert_allclose(got.numpy(), batch['extrinsics'][:, 0].numpy(),
                               atol=1e-6)
    # the room holds every box's bottom center
    room, boxes = batch['gt_layout'], batch['gt_boxes']
    for s in range(4):
        m = batch['gt_mask'][s]
        half = room[s, 3:5] / 2 + 0.1
        assert bool((boxes[s, m, :2] - room[s, :2]).abs().lt(half).all())


def test_layout_head_loss_matches_jax():
    angles, pred, gt_angles, gt = _layout_pairs(np.random.RandomState(2), 6)
    cfg = lh.LayoutHeadConfig()
    want = jax.jit(lambda *a: jax_lh.layout_head_loss(
        *a, jax_lh.LayoutHeadConfig()))(_j(angles), _j(pred), _j(gt_angles),
                                        _j(gt))
    got = lh.layout_head_loss(_t(angles), _t(pred), _t(gt_angles), _t(gt),
                              cfg)
    assert set(got) == set(want) == {'angle_loss', 'layout_loss'}
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=MODULE_TOL, atol=MODULE_TOL)
        assert 0 < float(got[key])
    assert float(got['layout_loss']) < 0.9


def test_layout_head_loss_gradient_matches_jax_vjp():
    """The gradient of ``angle_loss + layout_loss`` with respect to the
    angles and the layouts (the layout IoU through the clip) against
    ``jax.vjp``, within 1e-5 of each gradient's max-abs."""
    angles, pred, gt_angles, gt = _layout_pairs(np.random.RandomState(3), 6)
    cfg = lh.LayoutHeadConfig()

    def jax_total(a, p):
        out = jax_lh.layout_head_loss(a, p, _j(gt_angles), _j(gt),
                                      jax_lh.LayoutHeadConfig())
        return out['angle_loss'] + out['layout_loss']
    @jax.jit
    def jax_vjp(a, p):
        total, vjp = jax.vjp(jax_total, a, p)
        return vjp(jnp.ones_like(total))
    want = [np.asarray(g) for g in jax_vjp(_j(angles), _j(pred))]

    a, p = _t(angles).requires_grad_(), _t(pred).requires_grad_()
    out = lh.layout_head_loss(a, p, _t(gt_angles), _t(gt), cfg)
    (out['angle_loss'] + out['layout_loss']).backward()
    for g, w in zip((a.grad.numpy(), p.grad.numpy()), want):
        scale = np.abs(w).max()
        assert scale > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=MODULE_TOL * scale)
    # every sample's layout reaches the loss through the clip
    assert (np.abs(want[1]).max(1) > 0).all()


def test_head_2d_round_trips_through_the_jax_converter():
    """port ``state_dict`` -> the JAX package's ``convert_layout_head`` ->
    ``from_jax_variables`` gives ``head_2d`` back bit for bit, and the
    names are the reference's ``head_2d.{angle,layout}_mlp.{0,3,6}``.
    (``tests/test_torch_port_package.py`` runs the whole strict converter
    on the full-size ``imvoxelnet_total_sunrgbd``.)"""
    jcfg, cfg = tiny_total3d_cfgs()
    sd = detector.build_model(cfg, device='cpu', seed=4).state_dict()
    names = {k for k in sd if k.startswith('head_2d.')}
    assert names == {f'head_2d.{h}_mlp.{i}.{w}' for h in ('angle', 'layout')
                     for i in (0, 3, 6) for w in ('weight', 'bias')}
    variables = jax_variables(jcfg, _batch_np(1), seed=0)
    variables['params']['head_2d'], _ = convert_layout_head(
        {k: v.numpy() for k, v in sd.items()})
    back = from_jax_variables(variables, cfg)
    assert {k for k in back if k.startswith('head_2d.')} == names
    for key in names:
        assert back[key].dtype == sd[key].dtype
        assert torch.equal(back[key], sd[key]), key


# --------------------------------------------------------------------------
# the slice: forward + decode with predicted extrinsics
# --------------------------------------------------------------------------

def _batch_np(b=2):
    batch = synthetic.sunrgbd_train_batch(b, 'cpu', seed=SLICE_SEED,
                                          size=(128, 96), max_gt=MAX_GT,
                                          n_classes=3, layout=True)
    return {k: v.numpy() for k, v in batch.items()}


def _variables(jcfg, batch_np, seed, cls_bias=None):
    """Random weights with the reg conv scaled down (boxes of about 2 m)
    and the angle MLP's last layer scaled down, so that the predicted
    cameras tilt by tenths of a radian, as trained ones do."""
    variables = jax_variables(jcfg, batch_np, seed=seed, cls_bias=cls_bias)
    params = variables['params']
    params['bbox_head']['reg_conv']['kernel'] *= 0.1
    params['head_2d']['angle_fc3']['kernel'] *= 0.01
    return variables


@pytest.fixture(scope='module')
def serving():
    jcfg, cfg = tiny_total3d_cfgs()
    batch_np = _batch_np()
    variables = _variables(jcfg, batch_np, seed=6, cls_bias=0.0)
    model = jax_det.ImVoxelNet(jcfg)

    @jax.jit
    def forward(variables, batch):
        head_outs, valid, f2d = model.apply(variables, batch, train=False,
                                            use_predicted_extrinsics=True)
        return head_outs, valid, jax_det.imvoxelnet_predict(
            jcfg, head_outs, valid, f2d, batch)

    head, valid, res = jax.tree_util.tree_map(np.asarray, forward(
        variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    tmodel = port_model(cfg, variables)
    tbatch = to_torch(batch_np)
    with torch.no_grad():
        t_head, t_valid, f2d = tmodel(tbatch, use_predicted_extrinsics=True)
        t_res = detector.imvoxelnet_predict(cfg, t_head, t_valid,
                                            tbatch['origins'], f2d)
    return dict(cfg=cfg, batch_np=batch_np, jax_head=head, jax_valid=valid,
                jax_res=res, t_head=t_head, t_valid=t_valid, f2d=f2d,
                origins=tbatch['origins'],
                res={k: v.numpy() for k, v in t_res.items()})


def test_serving_fixture_keeps_its_margins(serving):
    """Pixel rounding under the predicted extrinsics, the candidates'
    ranking, the score threshold and the deciding IoUs stay clear of float
    noise; NMS suppresses; the predicted cameras differ from the batch's."""
    from test_torch_port_indoor_train import GEOM_MARGIN, _level_inputs, \
        _margins

    cfg, batch_np = serving['cfg'], serving['batch_np']
    hc = cfg.indoor_head
    # the training steps' GT and cameras (the batch's own extrinsics)
    assert projection_margin(cfg.n_voxels, cfg.voxel_size,
                             batch_np) > PIXEL_MARGIN
    points, _, _ = _level_inputs(cfg, torch.from_numpy(batch_np['origins']))
    for s in range(2):
        assert min(_margins(points[s], batch_np['gt_boxes'][s],
                            batch_np['gt_mask'][s], cfg)) > GEOM_MARGIN, s
    pred_ext = lh.predicted_extrinsics(serving['f2d'][0]).numpy()
    assert np.abs(pred_ext - batch_np['extrinsics'][:, 0]).max() > 1e-2
    assert projection_margin(cfg.n_voxels, cfg.voxel_size, dict(
        batch_np, extrinsics=pred_ext[:, None])) > PIXEL_MARGIN
    level_scores, scores, top, bev = _candidates(
        cfg, serving['t_head'], serving['t_valid'], serving['origins'])
    for s in level_scores:
        r = np.sort(s.numpy(), -1)[:, ::-1]
        if hc.nms_pre < r.shape[1]:
            assert ((r[:, hc.nms_pre - 1] - r[:, hc.nms_pre] > MARGIN)
                    | (r[:, hc.nms_pre] == 0)).all()
    assert _gaps(scores.numpy(), hc.pre_nms_k).min() > MARGIN
    assert np.abs(top.numpy() - hc.score_thr).min() > MARGIN
    iou = iou_ops.rotated_iou_bev(bev, bev)
    offered = torch.from_numpy(top.numpy() > hc.score_thr)
    keep = nms_ops.greedy_nms_from_iou_batched(
        iou, torch.zeros(offered.shape), offered, hc.iou_thr, presorted=True)
    later = torch.ones(iou.shape[-2:], dtype=torch.bool).triu(1)
    assert (iou[keep[..., :, None] & later] - hc.iou_thr).abs().min() > MARGIN
    assert int(keep.sum()) < int(offered.sum())


def test_serving_matches_jax(serving):
    """Seen voxels, labels and valid exact; head outputs, angles, layout,
    boxes and scores within 2e-3."""
    np.testing.assert_array_equal(serving['t_valid'].numpy(),
                                  serving['jax_valid'])
    assert 0 < serving['jax_valid'].mean() < 1
    for i in range(3):
        for g, w in zip(serving['t_head'][i], serving['jax_head'][i]):
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    got, want = serving['res'], serving['jax_res']
    assert set(got) == set(want) == {'boxes', 'scores', 'labels', 'valid',
                                     'angles', 'layout'}
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    assert got['valid'].sum(1).min() > 0
    for key in ('scores', 'boxes', 'angles', 'layout'):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)


# --------------------------------------------------------------------------
# the slice: 3 training steps
# --------------------------------------------------------------------------

SPE, LR_STEPS = 1, (1, 2)             # both LR boundaries inside 3 steps

LOSSES = {'loss_centerness', 'loss_bbox', 'loss_cls', 'angle_loss',
          'layout_loss', 'loss'}


@pytest.fixture(scope='module')
def slice_run():
    from imvoxelnet_tpu.configs import presets as jax_presets

    jcfg, cfg = tiny_total3d_cfgs()
    preset = jax_presets.get_preset('imvoxelnet_total_sunrgbd')
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
    jax_losses, jax_grads = [], None
    for _ in range(STEPS):
        state, metrics = train_step(state, batch)
        jax_losses.append({k: float(v) for k, v in metrics.items()})
        jax_grads = state.opt_state[0] if jax_grads is None else jax_grads
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
    jax_after = from_jax_variables({'params': to_np(state.params),
                                    'batch_stats': to_np(state.batch_stats)},
                                   cfg)

    tmodel = port_model(cfg, variables)
    opt, sched = train.make_optimizer(tmodel, *opt_args, steps_per_epoch=SPE,
                                      lr_steps=LR_STEPS)
    step = train.make_train_step(tmodel, opt, sched)
    tbatch = to_torch(batch_np)
    probe = port_model(cfg, variables).train()
    for name, p in probe.named_parameters():
        p.requires_grad_(train.param_label(name) != 'frozen')
    head_outs, valid, f2d = probe(tbatch)
    sum(detector.imvoxelnet_loss(cfg, head_outs, tbatch, valid,
                                 f2d).values()).backward()
    port_grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in probe.named_parameters() if p.requires_grad}
    port_losses = [{k: float(v) for k, v in step(tbatch).items()}
                   for _ in range(STEPS)]
    return dict(cfg=cfg, variables=variables, jax_losses=jax_losses,
                port_losses=port_losses, port_grads=port_grads,
                jax_grads=from_jax_variables(
                    {'params': to_np(jax_grads),
                     'batch_stats': variables['batch_stats']}, cfg),
                jax_after=jax_after, port_after=tmodel.state_dict(), lr=lr,
                groups={id(p): i for i, g in enumerate(opt.param_groups)
                        for p in g['params']},
                names={n: id(p) for n, p in tmodel.named_parameters()})


def test_slice_losses_match_jax_every_step(slice_run):
    jl, pl = slice_run['jax_losses'], slice_run['port_losses']
    assert len(jl) == len(pl) == STEPS
    for i, (j, p) in enumerate(zip(jl, pl)):
        assert set(j) == set(p) == LOSSES
        for key in j:
            np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f'step {i} {key}')
    assert pl[0]['loss_bbox'] > 0 and 0 < pl[0]['layout_loss'] < 1
    assert pl[-1]['loss'] < pl[0]['loss']


def test_slice_first_step_gradients_match_jax(slice_run):
    """Every trainable gradient, ``head_2d``'s included, within 2e-2 of its
    max-abs; the conv biases right before a batch-statistics BN (true
    gradient 0) are float noise in both."""
    from test_torch_port_indoor_train import biases_before_bn

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
    for name in ('head_2d.angle_mlp.0.weight', 'head_2d.angle_mlp.6.weight',
                 'head_2d.layout_mlp.0.weight', 'head_2d.layout_mlp.6.weight',
                 'backbone.layer4.0.conv1.weight',
                 'bbox_head.reg_conv.weight', 'bbox_head.cls_conv.weight'):
        assert name in nonzero, name


def test_slice_state_matches_jax_after_the_steps(slice_run):
    """The neck's BN statistics within 1e-3 and every weight within the
    steps' largest update, ``head_2d`` in the default LR group."""
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
    groups, names = slice_run['groups'], slice_run['names']
    assert groups[names['head_2d.angle_mlp.0.weight']] == \
        groups[names['bbox_head.cls_conv.weight']] == 1
    assert train.param_label('head_2d.layout_mlp.6.bias') == 'rest'


def test_loss_without_features_2d_leaves_the_layout_out():
    """A layout config given no ``features_2d`` (as the JAX package given
    ``None``) returns the indoor losses alone; the forward of a config
    without a layout head keeps its 2-tuple."""
    _, cfg = tiny_total3d_cfgs()
    assert dataclasses.replace(cfg, layout_head=None).layout_head is None
    batch_np = _batch_np(1)
    model = detector.build_model(dataclasses.replace(cfg, layout_head=None),
                                 device='cpu', seed=0)
    with torch.no_grad():
        outs = model(to_torch(batch_np))
    assert len(outs) == 2
    losses = detector.imvoxelnet_loss(cfg, outs[0], to_torch(batch_np),
                                      outs[1])
    assert set(losses) == {'loss_centerness', 'loss_bbox', 'loss_cls'}
