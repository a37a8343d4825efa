"""The training slice of the PyTorch port against the JAX package, on the CPU.

Module by module (box coder, nearest-BEV IoU, target assignment, losses, the
anchor head's loss, the backward of kernels B1 and B3, the optimizer) and
then the slice as a whole: ``make_train_step`` for 3 steps against
``jax.jit`` of the JAX ``make_train_step`` on ``tiny_kitti_test``, from the
same weights (``from_jax_variables``) and the same numpy batch.

The necks' batch norms update ``running_var`` with the biased batch
variance, as flax does (``models/layers.py:BatchNorm3d``; torch's own rule,
the reference's, takes the unbiased one): after one train-mode forward the
running statistics equal the JAX package's to float rounding.

Known gaps, which the tolerances allow for:

* Adam's first update is about ``lr * sign(g)``, so a gradient entry near
  zero can flip an entry by ``2 * lr``: parameters after the steps are
  compared with ``atol = 2 * lr`` per step, not tighter.
* The bias of a conv directly before a batch-statistics BN (the 3D neck's
  ``model.{1,3,5}.0.bias``) has a true gradient of 0, which both packages
  give as float noise: those are held to be noise-sized in both.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.core import coder as jax_coder
from imvoxelnet_tpu.core import target_assign as jax_ta
from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models.heads import anchor3d_head as jax_a3d
from imvoxelnet_tpu.ops import backproject as jax_bp
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import conv3z_pallas
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops import losses as jax_losses
from imvoxelnet_tpu.parallel import train as jax_train

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.core import coder, target_assign
from imvoxelnet_tpu_torch.kernels import conv3x3x3 as conv_kernel
from imvoxelnet_tpu_torch.models.detector import build_neck, imvoxelnet_loss
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import losses
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import synthetic
from imvoxelnet_tpu_torch.utils.checkpoint import (from_jax_variables,
                                                   neck_state_dict)

from _torch_port_fixtures import (K_TINY, W, jax_neck, jax_variables,
                                  port_model, random_tree, tiny_batch_np,
                                  tiny_indoor_cfgs, to_torch)

PRESET = 'tiny_kitti_test'
LOSS_RTOL, LOSS_ATOL = 5e-3, 1e-5     # test_full_train_loss_parity.py:121
GRAD_TOL = 2e-2                       # test_full_train_loss_parity.py:205
# BN statistics after 3 steps: the first step's match to float rounding
# (the test below), the later ones drift with Adam's sign flips, at most
# 4.9e-4 x (1 + |x|) (block0.bn1's running variance)
STATS_TOL = 1e-3
IOU_MARGIN = 1e-4
STEPS = 3
# Adam's sign flips (first known gap) move the next steps' batch statistics
# in proportion to the LR: at the preset's 1e-4 block0's running variance
# drifts 4x past STATS_TOL by step 3, at 1e-5 to half of it
SLICE_LR_MULT = 0.1
SPE, LR_STEPS = 1, (1, 2)             # both LR boundaries inside 3 steps


def _t(x):
    return torch.from_numpy(np.array(x))


def _tiny_gt(rng, b):
    max_gt = jax_presets.get_preset(PRESET).data.max_gt
    fx, cx = K_TINY[0, 0], K_TINY[0, 2]
    return synthetic.car_boxes(
        rng, b, max_gt, x_range=(3.0, 23.0),
        y_per_x=(-0.8 * (W - cx) / fx, 0.8 * cx / fx), y_range=(-11.0, 11.0))


@pytest.fixture(scope='module')
def head_setup():
    """Anchors of the tiny map, padded GT and random head maps (numpy)."""
    cfg = jax_presets.get_preset(PRESET).model.anchor_head
    h, w = 38, 30
    anchors = np.asarray(jax_a3d.head_anchors((h, w), cfg))
    rng = np.random.RandomState(5)
    gt = _tiny_gt(rng, 3)
    a = cfg.num_anchors
    head = (rng.randn(3, h, w, a * cfg.num_classes).astype(np.float32),
            (0.3 * rng.randn(3, h, w, a * cfg.box_code_size))
            .astype(np.float32),
            rng.randn(3, h, w, a * 2).astype(np.float32))
    return cfg, anchors, gt, head


SLICE_GT_SEED = 8


@pytest.mark.parametrize('which', ['modules', 'slice'])
def test_fixture_keeps_its_margins(head_setup, which):
    """No IoU sits within 1e-4 of a threshold and no yaw near the extent
    swap or a direction bin edge, so that float rounding cannot flip an
    assignment, a swap or a bin: in the GT of the module tests and in that
    of the slice test (same anchors)."""
    cfg, anchors, (boxes, _, mask), _ = head_setup
    if which == 'slice':
        boxes, _, mask = _tiny_gt(np.random.RandomState(SLICE_GT_SEED), 2)
    thr = np.array([cfg.assigner.pos_iou_thr, cfg.assigner.neg_iou_thr,
                    cfg.assigner.min_pos_iou])
    for s in range(boxes.shape[0]):
        iou = np.asarray(jax_iou.bbox_overlaps_nearest_3d(
            jnp.asarray(anchors), jnp.asarray(boxes[s][mask[s]])))
        assert np.abs(iou[..., None] - thr).min() > IOU_MARGIN
        yaw = boxes[s][mask[s]][:, 6]
        assert np.abs(yaw[:, None] - synthetic.YAW_KNIFE_EDGES[
            [0, 1, 3, 4, 5, 7, 8]]).min() >= synthetic.YAW_MARGIN
    # the anchors' own yaws (0, 1.57) keep clear of the swap at pi/4
    assert np.abs(np.abs(anchors[:, 6]) - np.pi / 4).min() > 0.5


def test_encode_matches_jax():
    rng = np.random.RandomState(0)
    anchors = np.concatenate([rng.randn(50, 3), rng.uniform(0.5, 4, (50, 3)),
                              rng.randn(50, 1)], -1).astype(np.float32)
    boxes = anchors + (0.2 * rng.randn(50, 7)).astype(np.float32)
    ref = np.asarray(jax_coder.encode(jnp.asarray(anchors),
                                      jnp.asarray(boxes)))
    got = coder.encode(_t(anchors), _t(boxes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # decode inverts encode
    np.testing.assert_allclose(coder.decode(_t(anchors), _t(got)).numpy(),
                               boxes, rtol=1e-5, atol=1e-5)


def test_nearest_bev_matches_jax():
    rng = np.random.RandomState(1)
    boxes = np.concatenate([rng.randn(200, 3) * 10,
                            rng.uniform(0.5, 4, (200, 3)),
                            rng.uniform(-7, 7, (200, 1))], -1)
    boxes = boxes.astype(np.float32)
    # away from the swap at |yaw| = pi/4 (mod pi/2 multiples of it)
    rot = np.abs((boxes[:, 6] + np.pi / 2) % np.pi - np.pi / 2)
    keep = np.abs(rot - np.pi / 4) > 1e-3
    ref = np.asarray(jax_boxes.nearest_bev(jnp.asarray(boxes[keep])))
    got = box_ops.nearest_bev(_t(boxes[keep])).numpy()
    np.testing.assert_array_equal(got, ref)


def test_bbox_overlaps_nearest_3d_matches_jax(head_setup):
    _, anchors, (boxes, _, _), _ = head_setup
    got = iou_ops.bbox_overlaps_nearest_3d(_t(anchors), _t(boxes)).numpy()
    assert got.shape == (boxes.shape[0], anchors.shape[0], boxes.shape[1])
    for s in range(boxes.shape[0]):
        ref = np.asarray(jax_iou.bbox_overlaps_nearest_3d(
            jnp.asarray(anchors), jnp.asarray(boxes[s])))
        np.testing.assert_allclose(got[s], ref, rtol=1e-6, atol=1e-7)
    assert got.max() > 0.6


def test_max_iou_assign_matches_jax_exactly(head_setup):
    cfg, anchors, (boxes, _, mask), _ = head_setup
    got = target_assign.max_iou_assign(_t(anchors), _t(boxes), _t(mask),
                                       cfg.assigner).numpy()
    for s in range(boxes.shape[0]):
        ref = np.asarray(jax_ta.max_iou_assign(
            jnp.asarray(anchors), jnp.asarray(boxes[s]),
            jnp.asarray(mask[s]), cfg.assigner))
        np.testing.assert_array_equal(got[s], ref)
        # positives, negatives, ignores and low-quality claims all occur
        assert (ref >= 0).sum() > mask[s].sum() and (ref == -1).any()
        assert (ref == -2).any()


def test_anchor_targets_match_jax(head_setup):
    cfg, anchors, (boxes, labels, mask), _ = head_setup
    got = target_assign.anchor_targets(
        _t(anchors), _t(boxes), _t(labels), _t(mask), cfg.assigner,
        cfg.num_classes, cfg.dir_offset)
    ref = jax.vmap(lambda b, l, m: jax_ta.anchor_targets_single(
        jnp.asarray(anchors), b, l, m, cfg.assigner, cfg.num_classes,
        cfg.dir_offset))(jnp.asarray(boxes), jnp.asarray(labels),
                         jnp.asarray(mask))
    for key in ('labels', 'label_weights', 'bbox_weights', 'dir_targets',
                'dir_weights', 'n_pos'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got['bbox_targets'].numpy(),
                               np.asarray(ref['bbox_targets']),
                               rtol=1e-5, atol=1e-6)
    # both direction bins occur among the positives
    pos = got['bbox_weights'].numpy() > 0
    assert set(np.unique(got['dir_targets'].numpy()[pos])) == {0, 1}


@pytest.mark.parametrize('name', ['sigmoid_focal_loss', 'smooth_l1_loss',
                                  'softmax_cross_entropy'])
def test_loss_matches_jax(name):
    rng = np.random.RandomState(2)
    n = 300
    weight = (rng.uniform(size=n) > 0.3).astype(np.float32)
    if name == 'sigmoid_focal_loss':
        args = (rng.randn(n, 3).astype(np.float32) * 3,
                rng.randint(0, 4, n).astype(np.int32))   # 3 = background
        kw = dict(avg_factor=17.0, loss_weight=1.0)
    elif name == 'smooth_l1_loss':
        args = ((rng.randn(n, 7) * 0.3).astype(np.float32),
                (rng.randn(n, 7) * 0.3).astype(np.float32))
        weight = weight[:, None]
        kw = dict(beta=1.0 / 9.0, avg_factor=17.0, loss_weight=2.0)
    else:
        args = (rng.randn(n, 2).astype(np.float32) * 2,
                rng.randint(0, 2, n).astype(np.int32))
        kw = dict(avg_factor=17.0, loss_weight=0.2)
    ref = getattr(jax_losses, name)(*map(jnp.asarray, args),
                                    weight=jnp.asarray(weight), **kw)
    got = getattr(losses, name)(*map(_t, args), weight=_t(weight), **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # a tensor avg_factor (the head's positive count) gives the same value
    kw['avg_factor'] = torch.tensor(17.0)
    got_t = getattr(losses, name)(*map(_t, args), weight=_t(weight), **kw)
    assert float(got_t) == float(got)


def test_anchor3d_head_loss_matches_jax(head_setup):
    cfg, _, (boxes, labels, mask), head = head_setup
    ref = jax_a3d.anchor3d_head_loss(
        tuple(map(jnp.asarray, head)), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(mask), cfg)
    port_cfg = presets.get_preset(PRESET).model.anchor_head
    got = a3d.anchor3d_head_loss(tuple(map(_t, head)), _t(boxes),
                                 _t(labels), _t(mask), port_cfg)
    assert set(got) == set(ref) == {'loss_cls', 'loss_bbox', 'loss_dir'}
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=key)


def _bp_inputs(b=2, v=3, hf=12, wf=16, c=8, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, v, hf, wf, c).astype(np.float32)
    k = np.array([[20.0, 0, 8.037], [0, 20.0, 5.971], [0, 0, 1]], np.float32)
    proj = np.zeros((b, v, 3, 4), np.float32)
    for s in range(b):
        for i in range(v):
            e = np.eye(4, dtype=np.float32)[:3]
            e[0, 3] = 0.2 * i + 0.05 * s
            proj[s, i] = k @ e
    origins = torch.tensor([[0.0137, -0.0213, 2.0071]] * b)
    points = bp.get_points((7, 6, 5), (0.3, 0.3, 0.3), origins).reshape(
        b, -1, 3).numpy()
    hw = np.array([(9, 13)] * b, np.int32)
    return feats, points, proj, hw


def test_backproject_grad_plain_matches_jax_vjp():
    feats, points, proj, hw = _bp_inputs()
    b, v, hf, wf, c = feats.shape
    acc, vjp = jax.vjp(lambda f: jax_bp.backproject_batch(
        f, jnp.asarray(points), jnp.asarray(proj), jnp.asarray(hw))[0],
        jnp.asarray(feats))
    g = np.random.RandomState(1).randn(*acc.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    got = bp.backproject_batch_grad_plain(_t(g), _t(points), _t(proj),
                                          _t(hw), hf, wf)
    assert got.shape == feats.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # pixels several voxels share, and pixels no voxel reads
    n_read = bp.backproject_batch_grad_plain(
        torch.ones(g.shape), _t(points), _t(proj), _t(hw), hf, wf)
    assert n_read.max() > 1 and (n_read == 0).any()


def test_backproject_function_plain_form_gradcheck():
    feats, points, proj, hw = _bp_inputs(b=2, v=2, hf=6, wf=8, c=2)
    x = _t(feats).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda f: bp.BackprojectFunction.apply(f, _t(points), _t(proj),
                                               _t(hw), True)[0], (x,))


def test_conv3x3x3_backward_matches_jax_vjp():
    """``dx`` as the conv with the transposed kernel, through the plain conv
    and through the kernel's rows algorithm, and ``dk`` from
    ``convolution_backward``, against ``jax.vjp`` of the reference conv."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 7, 6, 64).astype(np.float32)
    k = (rng.randn(3, 3, 3, 64, 64) / np.sqrt(27 * 64)).astype(np.float32)
    g = rng.randn(2, 5, 7, 6, 64).astype(np.float32)
    _, vjp = jax.vjp(conv3z_pallas._conv_ref, jnp.asarray(x), jnp.asarray(k))
    ref_dx, ref_dk = (np.asarray(r) for r in vjp(jnp.asarray(g)))
    kt = conv3z.transpose_kernel(_t(k))
    dx_plain = conv3z.conv3x3x3_plain(_t(g), kt).numpy()
    dx_rows = conv_kernel.conv3x3x3_rows_plain(
        _t(g), conv_kernel.pack_weights(kt)).numpy()
    dk = conv3z.kernel_grad(_t(x), _t(g), _t(k)).numpy()
    for got, ref in ((dx_plain, ref_dx), (dx_rows, ref_dx), (dk, ref_dk)):
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_conv3x3x3_function_plain_form_gradcheck():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 4, 5, 3, 2)).requires_grad_()
    k = torch.from_numpy(rng.randn(3, 3, 3, 2, 3)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, w: conv3z.Conv3x3x3Function.apply(a, w, True), (x, k))


def _jax_state(variables, tx):
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    return jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params))


def _as_port(tree, variables, cfg):
    """A JAX params-shaped tree under the port's names and layouts."""
    return from_jax_variables(
        {'params': jax.tree_util.tree_map(np.array, tree),
         'batch_stats': variables['batch_stats']}, cfg)


LABELS_INDEX = {'frozen': 0, 'backbone': 1, 'rest': 2}


# the necks' batch norms after one train-mode forward, at b=2: block0 of the
# tiny KITTI neck holds N = 30,720 values a channel, the coarsest BNs of the
# tiny ImVoxelNeck N = 8, where the unbiased rule's gap 1/(N-1) is 14%
BN_RTOL = 1e-6


@pytest.mark.parametrize('which', ['kitti', 'imvoxel', 'fast'])
def test_neck_bn_running_stats_match_jax_after_one_train_forward(which):
    if which == 'kitti':
        jcfg = jax_presets.get_preset(PRESET).model
        cfg = presets.get_preset(PRESET).model
        cin = cfg.neck.in_channels
    else:
        jcfg, cfg = tiny_indoor_cfgs(fast=which == 'fast')
        cin = (cfg.neck.channels[0] if which == 'imvoxel'
               else cfg.neck.in_channels)
    rng = np.random.RandomState(6)
    x = rng.randn(2, *cfg.n_voxels, cin).astype(np.float32)
    jneck = jax_neck(jcfg)
    shapes = jax.eval_shape(lambda v: jneck.init(jax.random.PRNGKey(0), v,
                                                 train=False), x)
    variables = random_tree(shapes, rng)
    _, updated = jneck.apply(variables, jnp.asarray(x), train=True,
                             mutable=['batch_stats'])
    want = neck_state_dict(cfg.neck, variables['params'],
                           jax.tree_util.tree_map(np.asarray,
                                                  updated['batch_stats']))

    neck = build_neck(cfg.neck)
    neck.load_state_dict({k[len('neck_3d.'):]: v for k, v in neck_state_dict(
        cfg.neck, variables['params'], variables['batch_stats']).items()})
    with torch.no_grad():
        neck.train()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    got = neck.state_dict()
    n_compared = 0
    for key, ref in want.items():
        if key.endswith(('running_var', 'running_mean')):
            ref_np = ref.numpy()
            np.testing.assert_allclose(
                got[key[len('neck_3d.'):]].numpy(), ref_np, rtol=BN_RTOL,
                atol=BN_RTOL * np.abs(ref_np).max(), err_msg=key)
            n_compared += 1
    assert n_compared == 2 * sum(isinstance(m, torch.nn.BatchNorm3d)
                                 for m in neck.modules())


def test_param_labels_match_jax():
    jcfg = jax_presets.get_preset(PRESET).model
    cfg = presets.get_preset(PRESET).model
    variables = jax_variables(jcfg, tiny_batch_np(1), seed=0)
    ref = _as_port(jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, LABELS_INDEX[lab], np.float32),
        jax_train.param_labels(variables['params']), variables['params']),
        variables, cfg)
    got = train.param_labels(port_model(cfg, variables))
    assert got and set(got.values()) == set(LABELS_INDEX)
    for name, label in got.items():
        assert LABELS_INDEX[label] == int(ref[name].reshape(-1)[0]), name


def test_optimizer_matches_jax():
    """3 updates from identical gradients: the joint clip acts on the first
    and third (norm 50 and 80 > 35), not the second; the LR drops to 0.1x
    and 0.01x at updates 1 and 2."""
    preset = jax_presets.get_preset(PRESET)
    jcfg, cfg = preset.model, presets.get_preset(PRESET).model
    variables = jax_variables(jcfg, tiny_batch_np(1), seed=0)
    tx = jax_train.make_optimizer(preset.lr, preset.weight_decay,
                                  preset.backbone_lr_mult,
                                  preset.grad_clip_norm, steps_per_epoch=SPE,
                                  lr_steps=LR_STEPS)
    state = _jax_state(variables, tx)
    labels = jax_train.param_labels(state.params)
    update = jax.jit(tx.update)
    model = port_model(cfg, variables)
    opt, sched = train.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch=SPE, lr_steps=LR_STEPS)
    named = dict(model.named_parameters())
    rng = np.random.RandomState(6)
    for norm in (50.0, 10.0, 80.0):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), state.params)
        trainable = [g for g, lab in zip(jax.tree_util.tree_leaves(grads),
                                         jax.tree_util.tree_leaves(labels))
                     if lab != 'frozen']
        scale = norm / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                   for g in trainable))
        grads = jax.tree_util.tree_map(lambda g: g * np.float32(scale), grads)
        updates, opt_state = update(
            jax.tree_util.tree_map(jnp.asarray, grads), state.opt_state,
            state.params)
        state = state.replace(params=jax.tree_util.tree_map(
            lambda p, u: p + u, state.params, updates), opt_state=opt_state)
        port_grads = _as_port(grads, variables, cfg)
        for name, p in named.items():
            if p.requires_grad:
                p.grad = port_grads[name].clone()
        opt.step()
        sched.step()
    want = _as_port(state.params, variables, cfg)
    before = from_jax_variables(variables, cfg)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        # trainable parameters moved, frozen ones did not
        assert torch.equal(p.detach(), before[name]) != p.requires_grad, name
    assert [g['lr'] for g in opt.param_groups] == pytest.approx(
        [preset.lr * preset.backbone_lr_mult * 1e-2, preset.lr * 1e-2])


@pytest.fixture(scope='module')
def slice_run():
    """3 training steps of both packages from the same weights and batch,
    and the first step's gradients."""
    preset = jax_presets.get_preset(PRESET)
    jcfg, cfg = preset.model, presets.get_preset(PRESET).model
    batch_np = tiny_batch_np(2, seed=4)
    gt = _tiny_gt(np.random.RandomState(SLICE_GT_SEED), 2)
    batch_np.update(gt_boxes=gt[0], gt_labels=gt[1], gt_mask=gt[2])
    variables = jax_variables(jcfg, batch_np, seed=9)
    lr = preset.lr * SLICE_LR_MULT
    opt_args = (lr, preset.weight_decay, preset.backbone_lr_mult,
                preset.grad_clip_norm)

    model = jax_det.ImVoxelNet(jcfg)
    tx = jax_train.make_optimizer(*opt_args, steps_per_epoch=SPE,
                                  lr_steps=LR_STEPS)
    train_step = jax_train.make_train_step(model, tx)

    def total_loss(params, stats, batch):
        outs, _ = model.apply({'params': params, 'batch_stats': stats},
                              batch, train=True, mutable=['batch_stats'])
        return sum(jax_det.imvoxelnet_loss(jcfg, *outs, batch).values())

    @jax.jit
    def step_and_grads(state, batch):
        grads = jax.grad(total_loss)(state.params, state.batch_stats, batch)
        return train_step(state, batch) + (grads,)

    state = _jax_state(variables, tx)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jax_losses_, jax_grads = [], None
    for _ in range(STEPS):
        state, metrics, grads = step_and_grads(state, batch)
        jax_losses_.append({k: float(v) for k, v in metrics.items()})
        jax_grads = grads if jax_grads is None else jax_grads
    jax_after = from_jax_variables(
        {'params': jax.tree_util.tree_map(np.array, state.params),
         'batch_stats': jax.tree_util.tree_map(np.array,
                                               state.batch_stats)}, cfg)

    tmodel = port_model(cfg, variables)
    opt, sched = train.make_optimizer(tmodel, *opt_args, steps_per_epoch=SPE,
                                      lr_steps=LR_STEPS)
    step = train.make_train_step(tmodel, opt, sched)
    tbatch = to_torch(batch_np)
    # the first step's gradients, before the optimizer clips them in place
    probe = copy.deepcopy(tmodel).train()
    head_outs, _ = probe(tbatch)
    sum(imvoxelnet_loss(cfg, head_outs, tbatch).values()).backward()
    port_grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in probe.named_parameters() if p.requires_grad}
    port_losses = [{k: float(v) for k, v in step(tbatch).items()}
                   for _ in range(STEPS)]
    return dict(cfg=cfg, variables=variables, jax_losses=jax_losses_,
                port_losses=port_losses,
                jax_grads=_as_port(jax_grads, variables, cfg),
                port_grads=port_grads, jax_after=jax_after,
                port_after=tmodel.state_dict(), lr=lr)


def test_slice_losses_match_jax_every_step(slice_run):
    jl, pl = slice_run['jax_losses'], slice_run['port_losses']
    assert len(jl) == len(pl) == STEPS
    for i, (j, p) in enumerate(zip(jl, pl)):
        assert set(j) == set(p) == {'loss_cls', 'loss_bbox', 'loss_dir',
                                    'loss'}
        for key in j:
            np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f'step {i} {key}')
    assert pl[0]['loss_bbox'] > 0 and pl[-1]['loss'] < pl[0]['loss']


BIASES_BEFORE_BN = tuple(f'neck_3d.model.{i}.0.bias' for i in (1, 3, 5))


def test_slice_first_step_gradients_match_jax(slice_run):
    jg, pg = slice_run['jax_grads'], slice_run['port_grads']
    nonzero = set()
    for name, got in pg.items():
        want = jg[name].numpy()
        if name in BIASES_BEFORE_BN:
            scale = np.abs(jg[name.replace('bias', 'weight')].numpy()).max()
            assert np.abs(want).max() < 1e-4 * scale, name
            assert got.abs().max() < 1e-4 * scale, name
            continue
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)
        if scale > 0:
            nonzero.add(name)
    # the gradient reaches the backbone, the FPN and the 3D neck's block0
    for name in ('backbone.layer2.0.conv1.weight',
                 'backbone.layer4.2.conv3.weight',
                 'neck.lateral_convs.0.conv.weight',
                 'neck.fpn_convs.0.conv.weight',
                 'neck_3d.model.0.conv1.weight',
                 'neck_3d.model.0.conv2.weight',
                 'bbox_head.conv_reg.weight'):
        assert name in nonzero, name


def test_slice_bn_stats_match_jax_after_the_steps(slice_run):
    ja, pa = slice_run['jax_after'], slice_run['port_after']
    keys = [k for k in pa if k.startswith('neck_3d.')
            and k.endswith(('running_mean', 'running_var'))]
    assert len(keys) == 2 * 9
    for key in keys:
        np.testing.assert_allclose(pa[key].numpy(), ja[key].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=key)
        # and they moved away from the loaded statistics
        assert not torch.equal(pa[key], from_jax_variables(
                    slice_run['variables'], slice_run['cfg'])[key])


def test_slice_params_match_jax_after_the_steps(slice_run):
    ja, pa, lr = slice_run['jax_after'], slice_run['port_after'], \
        slice_run['lr']
    atol = 2 * lr * sum(0.1 ** i for i in range(STEPS))
    for key, got in pa.items():
        if key.endswith(('weight', 'bias')):
            np.testing.assert_allclose(got.numpy(), ja[key].numpy(), rtol=0,
                                       atol=atol, err_msg=key)
