"""The nuScenes slice of the PyTorch port against the JAX package, on the CPU.

Module by module (``bilinear_sample`` at integer, half-pixel and off-map
coordinates, ``DeformConv2d`` at stride 1 and 2 with its gradients, the DCN
backbone's stage outputs, the weight bridge for the DCN and the nuScenes
neck, the anchor targets and the decode at the preset's 156x156 map) and
then the slice as a whole on a tiny ``imvoxelnet_nuscenes`` configuration
with six views (``tests/_torch_port_fixtures.py:tiny_nuscenes_cfgs``): the
JAX ``ImVoxelNet`` + ``imvoxelnet_predict`` and the port's, and
``make_train_step`` for 3 steps against ``jax.jit`` of the JAX step, from the
same weights (``from_jax_variables``) and the same numpy batch
(``utils/synthetic.py:nuscenes_train_batch`` at 96x64).

The DCN's ``conv_offset`` weights are random here (``random_tree``), not
the zeros of the init: with zeros every offset is 0 and every mask 0.5, and
the DCN would be half a plain conv.  The tests assert that the offsets are
nonzero and that some sampled corners fall off the map.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.core import coder as jax_coder
from imvoxelnet_tpu.core import target_assign as jax_ta
from imvoxelnet_tpu.models import dcn as jax_dcn
from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models import resnet as jax_resnet
from imvoxelnet_tpu.models.heads import anchor3d_head as jax_a3d
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops import nms as jax_nms
from imvoxelnet_tpu.parallel import train as jax_train

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.core import target_assign
from imvoxelnet_tpu_torch.models import dcn, detector
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import synthetic
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

from _torch_port_fixtures import (jax_variables, port_model,
                                  projection_margin, recording,
                                  tiny_nuscenes_cfgs, to_torch)
from test_torch_port_indoor_train import biases_before_bn

TOL = 2e-3                 # the cross-framework slice tolerance
DCN_TOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-5
GRAD_TOL = 2e-2
STATS_TOL = 1e-3
PIXEL_MARGIN = 1e-4
IOU_MARGIN = 1e-4
MARGIN = 1e-3
TIE_MARGIN = 1e-5
STEPS = 3
SIZE = (96, 64)            # padded (W, H): frames of 96x54, 3 rows padded
MAX_GT = 8
EXTENT = 11.0              # cars within the tiny grid's +-12.8 m
SLICE_SEED = 54            # the slice batch; its margins are asserted
WEIGHT_SEED = 6


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# the DCN
# --------------------------------------------------------------------------

FH, FW, FC = 5, 7, 4


def _coords(case, rng, n=64):
    """Sample points of one kind on the 5x7 map."""
    ys = rng.uniform(0, FH - 1, n)
    xs = rng.uniform(0, FW - 1, n)
    if case == 'integer':
        ys, xs = rng.randint(0, FH, n), rng.randint(0, FW, n)
    elif case == 'half':
        ys, xs = rng.randint(-1, FH, n) + 0.5, rng.randint(-1, FW, n) + 0.5
    elif case == 'left':
        xs = -np.r_[1e-3, 1.0, 1.5, rng.uniform(1e-4, 1.0, n - 3)]
    elif case == 'right':
        xs = FW - 1 + np.r_[1e-3, 1.0, 1.5, rng.uniform(1e-4, 1.0, n - 3)]
    elif case == 'top':
        ys = -np.r_[1e-3, 1.0, 1.5, rng.uniform(1e-4, 1.0, n - 3)]
    elif case == 'bottom':
        ys = FH - 1 + np.r_[1e-3, 1.0, 1.5, rng.uniform(1e-4, 1.0, n - 3)]
    else:
        ys, xs = rng.uniform(-2, FH + 1, n), rng.uniform(-2, FW + 1, n)
    return xs.astype(np.float32), ys.astype(np.float32)


def test_taps_are_tap_major():
    dy, dx = dcn.taps()
    assert dy.tolist() == [-1, -1, -1, 0, 0, 0, 1, 1, 1]
    assert dx.tolist() == [-1, 0, 1, -1, 0, 1, -1, 0, 1]


@pytest.mark.parametrize('case', ['integer', 'half', 'left', 'right', 'top',
                                  'bottom', 'anywhere'])
def test_bilinear_sample_matches_jax_bits(case):
    """float32: the same bits as the JAX package's default row gathers."""
    rng = np.random.RandomState(1)
    feat = rng.randn(FH, FW, FC).astype(np.float32)
    x, y = _coords(case, rng)
    ref = np.asarray(jax_dcn.bilinear_sample(jnp.asarray(feat), jnp.asarray(x),
                                             jnp.asarray(y), window=False))
    got = dcn.bilinear_sample(_t(feat)[None], _t(x)[None], _t(y)[None])[0]
    np.testing.assert_array_equal(got.numpy(), ref)
    if case in ('left', 'right', 'top', 'bottom'):
        # partly on the map (a corner inside), and wholly off it
        assert (np.abs(ref).max(-1) > 0).any() and (ref == 0).all(-1).any()


def _dcn_weights(rng, c, f, pixels=3.0):
    """JAX ``DeformConv2d`` params: a he-normal kernel and a ``conv_offset``
    whose offsets are within about ``pixels`` of 0 and vary with the input,
    and whose masks spread around 0.5."""
    bias = np.r_[rng.uniform(-pixels, pixels, 18), rng.randn(9)]
    return {'kernel': (rng.randn(3, 3, c, f) * np.sqrt(2 / (9 * c))).astype(
        np.float32),
            'conv_offset': {
                'kernel': (rng.randn(3, 3, c, 27) * 0.5 / np.sqrt(9 * c))
                .astype(np.float32),
                'bias': bias.astype(np.float32)}}


def _conv(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _port_dcn(params, c, f, stride):
    mod = dcn.DeformConv2d(c, f, stride)
    mod.load_state_dict({
        'weight': _conv(params['kernel']),
        'conv_offset.weight': _conv(params['conv_offset']['kernel']),
        'conv_offset.bias': _t(params['conv_offset']['bias'])})
    return mod


def _sample_stats(mod, x):
    """Of a ``DeformConv2d``'s bilinear corners on input ``x`` (NCHW): the
    largest offset and the share of corners that fall off the map."""
    with torch.no_grad():
        offset, _ = mod.offsets_and_masks(x)
    oh, ow = offset.shape[1:3]
    h, w = x.shape[2:]
    s = mod.stride
    taps_dy, taps_dx = dcn.taps()
    ys = torch.arange(oh)[:, None, None] * s + taps_dy
    xs = torch.arange(ow)[None, :, None] * s + taps_dx
    y0 = torch.floor(ys + offset[..., 0])
    x0 = torch.floor(xs + offset[..., 1])
    off = torch.stack([(yy < 0) | (yy >= h) | (xx < 0) | (xx >= w)
                       for yy in (y0, y0 + 1) for xx in (x0, x0 + 1)])
    return float(offset.abs().max()), float(off.float().mean())


@pytest.mark.parametrize('stride', [1, 2])
def test_deform_conv_and_its_gradients_match_jax(stride):
    """Forward and the gradients of x, the kernel and ``conv_offset``
    against ``jax.vjp``, 1e-5 x max-abs; offsets of a few pixels, some
    corners off the map."""
    rng = np.random.RandomState(2 + stride)
    b, h, w, c, f = 2, 9, 11, 8, 6
    x = rng.randn(b, h, w, c).astype(np.float32)
    params = _dcn_weights(rng, c, f)
    jmod = jax_dcn.DeformConv2d(f, stride=stride)
    oh, ow = -(-h // stride), -(-w // stride)
    g = rng.randn(b, oh, ow, f).astype(np.float32)

    @jax.jit
    def forward_and_vjp(p, a, g):
        out, vjp = jax.vjp(lambda p, a: jmod.apply({'params': p}, a), p, a)
        return out, vjp(g)
    out, (dparams, dx) = forward_and_vjp(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(g))

    mod = _port_dcn(params, c, f, stride)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    got = mod(xt)
    got.backward(_t(g).permute(0, 3, 1, 2))
    largest, off_map = _sample_stats(mod, xt.detach())
    assert 1.0 < largest < 6.0 and 0.05 < off_map < 0.9
    pairs = [(got.detach().permute(0, 2, 3, 1), out),
             (xt.grad.permute(0, 2, 3, 1), dx),
             (mod.weight.grad, _conv(dparams['kernel'])),
             (mod.conv_offset.weight.grad,
              _conv(dparams['conv_offset']['kernel'])),
             (mod.conv_offset.bias.grad, dparams['conv_offset']['bias'])]
    for i, (port, ref) in enumerate(pairs):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0, i
        np.testing.assert_allclose(port.numpy(), ref, rtol=DCN_TOL,
                                   atol=DCN_TOL * np.abs(ref).max(),
                                   err_msg=str(i))


# --------------------------------------------------------------------------
# the synthetic batch
# --------------------------------------------------------------------------

PUBLISHED_YAWS = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)


def test_synthetic_batch_follows_the_dataset_rules():
    """Six cameras at the published yaws (within the 1 degree jitter) and
    1.5-1.6 m above the ground, their intrinsic folded into lidar2img with
    an identity intrinsic, frames of 1600x900 padded to 928 (here scaled to
    400x225 in 232), ratio 4, origin (0, 0, -1); most of the preset's
    312x312x12 voxels in view, by one or two views.  The training GT: 8-32
    cars of about the anchor size inside the point-cloud range, yaws within
    0.3 of a multiple of pi/2."""
    from imvoxelnet_tpu_torch.ops import backproject as bp

    batch = synthetic.nuscenes_batch(1, 'cpu', seed=0, size=(400, 232))
    assert batch['images'].shape == (1, 6, 232, 400, 3)
    assert not batch['images'][:, :, 225:].any()
    assert batch['img_shape'].tolist() == [[225, 400]]
    assert torch.equal(batch['intrinsics'], torch.eye(3)[None])
    assert batch['ratios'].tolist() == [4.0]
    assert batch['origins'].tolist() == [[0.0, 0.0, -1.0]]
    for v, m in enumerate(batch['extrinsics'][0].double().numpy()):
        ahead = m[2, :3]
        yaw = np.degrees(np.arctan2(ahead[1], ahead[0]))
        assert abs((yaw - PUBLISHED_YAWS[v] + 180) % 360 - 180) < 1.01, v
        # the camera centre: the point every row of the 3x4 matrix maps to
        # 0 (its null vector)
        centre = np.linalg.solve(m[:3, :3], -m[:3, 3])
        assert 1.45 < centre[2] + synthetic.LIDAR_HEIGHT < 1.6, v
        assert np.hypot(*centre[:2]) < 1.8, v
    cfg = presets.get_preset('imvoxelnet_nuscenes').model
    proj = bp.compute_projection(batch['intrinsics'], batch['extrinsics'],
                                 batch['ratios'])
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                           batch['origins']).reshape(1, -1, 3)
    _, valid = bp._view_indices(points, proj, batch['img_shape'] // 4, 58,
                                100)
    views = valid.sum(1)
    assert 0.85 < float((views > 0).float().mean()) < 1.0
    assert int(views.max()) == 2
    boxes, labels, mask = synthetic.nuscenes_cars(np.random.RandomState(0),
                                                  3, 64)
    assert ((mask.sum(1) >= 8) & (mask.sum(1) <= 32)).all()
    real = boxes[mask]
    assert (np.abs(real[:, :2]) < 45.0).all() and not labels.any()
    assert (np.abs(real[:, 3:6] / synthetic.NUSCENES_CAR - 1) < 0.25).all()
    rem = np.abs((real[:, 6] + np.pi / 4) % (np.pi / 2) - np.pi / 4)
    assert (rem <= 0.3).all()


# --------------------------------------------------------------------------
# the tiny model
# --------------------------------------------------------------------------

def _batch_np(b=2, seed=SLICE_SEED):
    batch = synthetic.nuscenes_train_batch(b, 'cpu', seed=seed, size=SIZE,
                                           max_gt=MAX_GT, extent=EXTENT)
    return {k: v.numpy() for k, v in batch.items()}


@pytest.fixture(scope='module')
def tiny():
    jcfg, cfg = tiny_nuscenes_cfgs()
    batch_np = _batch_np()
    # cls bias 0: scores near 0.5, so detections pass score_thr 0.05; the
    # cls kernel spread so that no two NMS candidates nearly tie
    variables = jax_variables(jcfg, batch_np, seed=WEIGHT_SEED, cls_bias=0.0)
    variables['params']['bbox_head']['conv_cls']['kernel'] *= 10.0
    return jcfg, cfg, batch_np, variables


def test_backbone_stage_outputs_match_jax(tiny):
    """The DCN backbone (stages 3-4) of the tiny model, all four stage
    outputs, with ``random_tree``'s ``conv_offset`` weights: offsets
    nonzero, some corners off the map."""
    jcfg, cfg, batch_np, variables = tiny
    images = batch_np['images'].reshape((-1,) + batch_np['images'].shape[2:])
    jnet = jax_resnet.ResNet(stage_blocks=(1, 1, 1, 1),
                             stage_with_dcn=jcfg.stage_with_dcn)
    ref = jax.jit(jnet.apply)({'params': variables['params']['backbone']},
                              jnp.asarray(images))
    model = port_model(cfg, variables)
    x = _t(images).permute(0, 3, 1, 2)
    stats = {}

    def hook(name):
        def record(mod, args, out):
            stats[name] = _sample_stats(mod, args[0])
        return record
    for name, mod in model.backbone.named_modules():
        if isinstance(mod, dcn.DeformConv2d):
            mod.register_forward_hook(hook(name))
    with torch.no_grad():
        got = model.backbone(x)
    assert sorted(stats) == ['layer3.0.conv2', 'layer4.0.conv2']
    for largest, off_map in stats.values():
        assert largest > 0.5 and 0.0 < off_map < 1.0, stats
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r,
                                   rtol=DCN_TOL, atol=DCN_TOL * np.abs(r).max())


def test_weight_bridge_maps_the_dcn_and_the_nuscenes_neck(tiny):
    """``from_jax_variables`` gives every key of the port's model (strict
    load), ``conv2.conv_offset.{weight,bias}`` in the DCN stages only, and
    the neck as ``neck_3d.model.{0..5}``; the DCN tensors are the JAX ones
    in OIHW."""
    jcfg, cfg, _, variables = tiny
    sd = from_jax_variables(variables, cfg)
    model = detector.ImVoxelNet(cfg)
    model.load_state_dict(sd, strict=True)
    offsets = sorted(k for k in sd if 'conv_offset' in k)
    assert offsets == [f'backbone.layer{s}.0.conv2.conv_offset.{p}'
                       for s in (3, 4) for p in ('bias', 'weight')]
    assert {k.split('.')[2] for k in sd if k.startswith('neck_3d.')} == {
        str(i) for i in range(6)}
    jconv2 = variables['params']['backbone']['layer3_0']['conv2']
    assert torch.equal(sd['backbone.layer3.0.conv2.weight'],
                       _conv(jconv2['kernel']))
    assert torch.equal(sd['backbone.layer3.0.conv2.conv_offset.weight'],
                       _conv(jconv2['conv_offset']['kernel']))
    # the stride-2 down conv and the x/y-padded out conv of the neck
    neck = model.neck_3d.model
    assert neck[1][0].stride == (2, 2, 2)
    assert neck[5][0].padding == (1, 1, 0)


def test_init_zeroes_conv_offset():
    """Seeded init: every ``conv_offset`` zero (offsets 0, masks 0.5), the
    DCN kernels not."""
    _, cfg = tiny_nuscenes_cfgs()
    model = detector.build_model(cfg, device='cpu', seed=0)
    mods = [m for m in model.modules() if isinstance(m, dcn.DeformConv2d)]
    assert len(mods) == 2
    for m in mods:
        assert not m.conv_offset.weight.any()
        assert not m.conv_offset.bias.any()
        assert m.weight.std() > 0


def test_dcn_parameters_train_in_the_backbone_group(tiny):
    """``conv_offset`` and the DCN kernels take the backbone's LR (x0.1),
    as ``_param_label`` puts them in the JAX package."""
    jcfg, cfg, _, variables = tiny
    labels = jax_train.param_labels(variables['params'])
    index = {'frozen': 0.0, 'backbone': 1.0, 'rest': 2.0}
    ref = from_jax_variables({'params': jax.tree_util.tree_map(
        lambda lab, p: np.full(p.shape, index[lab], np.float32), labels,
        variables['params']), 'batch_stats': variables['batch_stats']}, cfg)
    got = train.param_labels(port_model(cfg, variables))
    for name, label in got.items():
        assert index[label] == float(ref[name].reshape(-1)[0]), name
    dcn_names = [n for n in got if 'conv2' in n and n.startswith(
        ('backbone.layer3', 'backbone.layer4'))]
    assert len(dcn_names) == 6
    assert {got[n] for n in dcn_names} == {'backbone'}


# --------------------------------------------------------------------------
# anchors, targets and decode at the preset's map
# --------------------------------------------------------------------------

def _preset_head():
    return (jax_presets.get_preset('imvoxelnet_nuscenes').model.anchor_head,
            presets.get_preset('imvoxelnet_nuscenes').model.anchor_head)


TARGETS_SEED = 0


def test_anchor_targets_match_jax_at_the_preset():
    """48,672 anchors of the 156x156 map, assigner 0.6/0.3/0.3 and
    ``dir_offset`` 0.7854: labels, weights, direction targets and counts
    exact, box targets 1e-5; the GT's IoUs keep 1e-4 from the thresholds
    and its yaws from the direction bins' edges."""
    jh, th = _preset_head()
    anchors = np.asarray(jax_a3d.head_anchors((156, 156), jh))
    assert anchors.shape == (48672, 7)
    np.testing.assert_allclose(a3d.head_anchors((156, 156), th).numpy(),
                               anchors, rtol=1e-6, atol=1e-5)
    boxes, labels, mask = synthetic.nuscenes_cars(
        np.random.RandomState(TARGETS_SEED), 2, 64)
    thr = np.array([jh.assigner.pos_iou_thr, jh.assigner.neg_iou_thr])
    iou = np.asarray(jax.jit(jax.vmap(jax_iou.bbox_overlaps_nearest_3d,
                                      (None, 0)))(
        jnp.asarray(anchors), jnp.asarray(boxes)))
    assert np.abs(iou[..., None] - thr)[np.broadcast_to(
        mask[:, None, :, None], iou.shape + (2,))].min() > IOU_MARGIN
    yaw = boxes[mask][:, 6]
    assert np.abs(yaw[:, None] - (jh.dir_offset + np.pi * np.arange(
        -2, 2))).min() > 0.4
    got = target_assign.anchor_targets(
        _t(anchors), _t(boxes), _t(labels), _t(mask), th.assigner,
        th.num_classes, th.dir_offset)
    ref = jax.jit(jax.vmap(lambda b, l, m: jax_ta.anchor_targets_single(
        jnp.asarray(anchors), b, l, m, jh.assigner, jh.num_classes,
        jh.dir_offset)))(jnp.asarray(boxes), jnp.asarray(labels),
                         jnp.asarray(mask))
    for key in ('labels', 'label_weights', 'bbox_weights', 'dir_targets',
                'dir_weights', 'n_pos'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got['bbox_targets'].numpy(),
                               np.asarray(ref['bbox_targets']),
                               rtol=1e-5, atol=1e-5)
    pos = got['bbox_weights'].numpy() > 0
    assert (got['n_pos'].numpy() > 0).all()
    assert set(np.unique(got['dir_targets'].numpy()[pos])) == {0, 1}


DECODE_SEED = 0


def _decode_margins(head, cfg):
    """The decode's knife edges on head maps ``head`` (numpy), with the JAX
    functions: the smallest of the top-k cut's gap, the score threshold's
    and the deciding IoUs' distances, and the smallest gap between two of
    the candidates' scores (exact ties rank by index in both packages;
    near-ties could swap)."""
    cls_score, bbox_pred, _ = head
    b = cls_score.shape[0]
    anchors = jax_a3d.head_anchors(cls_score.shape[1:3], cfg)

    @jax.jit
    def candidates(cls, reg):
        logits, ids = jax.lax.top_k(cls.reshape(-1), cfg.nms_pre)
        boxes = jax_coder.decode(anchors[ids], reg.reshape(
            -1, cfg.box_code_size)[ids])
        iou = jax_iou.rotated_iou_bev(jax_boxes.bev(boxes),
                                      jax_boxes.bev(boxes))
        return iou, jax_nms.greedy_nms_from_iou_batched(
            iou, logits, jax.nn.sigmoid(logits) > cfg.score_thr,
            cfg.iou_thr, presorted=True)
    edges, ties = [], []
    for i in range(b):
        s = np.sort(1 / (1 + np.exp(-cls_score[i].reshape(-1).astype(
            np.float64))))[::-1]
        top = s[:cfg.nms_pre]
        edges += [s[cfg.nms_pre - 1] - s[cfg.nms_pre],
                  np.abs(top - cfg.score_thr).min()]
        ties.append(np.diff(np.unique(top)).min())
        iou, keep = map(np.asarray, candidates(cls_score[i], bbox_pred[i]))
        later = np.triu(np.ones(iou.shape, bool), 1)
        deciding = iou[keep[:, None] & later]
        edges.append(np.abs(deciding - cfg.iou_thr).min())
        assert 0 < keep.sum() < cfg.nms_pre
    return min(edges), min(ties)


def test_decode_matches_jax_at_the_preset():
    """The decode of the 156x156 map: a stable top-k of 1000 of 48,672
    anchors, rotated NMS at 0.2, ``max_out`` 500 and the direction-bin yaw
    with ``dir_offset`` 0.7854, ``dir_limit_offset`` 0."""
    jh, th = _preset_head()
    rng = np.random.RandomState(DECODE_SEED)
    a = jh.num_anchors
    # scores from evenly spaced logits: no two of them within 1e-6
    logits = rng.permutation(np.linspace(-4.0, 4.0, 156 * 156 * a))
    head = (logits.reshape(1, 156, 156, a).astype(np.float32),
            (0.3 * rng.randn(1, 156, 156, a * 7)).astype(np.float32),
            rng.randn(1, 156, 156, a * 2).astype(np.float32))
    assert min(_decode_margins(head, jh)) > 1e-6
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda h: jax_a3d.anchor3d_head_get_bboxes(h, jh))(
            tuple(map(jnp.asarray, head))))
    got = a3d.anchor3d_head_get_bboxes(tuple(map(_t, head)), th)
    np.testing.assert_array_equal(got['valid'].numpy(), ref['valid'])
    np.testing.assert_array_equal(got['labels'].numpy(), ref['labels'])
    assert 0 < ref['valid'].sum() <= jh.max_out
    for key in ('scores', 'boxes'):
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


# --------------------------------------------------------------------------
# the slice: forward + decode, and 3 training steps
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def serving(tiny):
    jcfg, cfg, batch_np, variables = tiny
    model = jax_det.ImVoxelNet(jcfg)

    @jax.jit
    def forward(variables, batch):
        head_outs, valid, f2d = model.apply(variables, batch, train=False)
        return head_outs, valid, jax_det.imvoxelnet_predict(
            jcfg, head_outs, valid, f2d, batch)

    head, valid, res = jax.tree_util.tree_map(np.asarray, forward(
        variables, {k: jnp.asarray(v) for k, v in batch_np.items()}))
    tmodel = port_model(cfg, variables)
    with torch.no_grad():
        t_head, t_valid = tmodel(to_torch(batch_np))
        t_res = detector.imvoxelnet_predict(cfg, t_head)
    return dict(jax_head=head, jax_valid=valid, jax_res=res,
                head=[o.numpy() for o in t_head], valid=t_valid.numpy(),
                res={k: v.numpy() for k, v in t_res.items()})


def test_slice_fixture_keeps_its_margins(tiny, serving):
    """Six views of 96x54 padded to 64 (``valid_hw`` crops the padding),
    pixel rounding in every view, and the decode's knife edges (the top-k
    cut of 64 of 128 anchors, the score threshold, near-ties, the deciding
    IoUs) clear of float noise."""
    jcfg, _, batch_np, _ = tiny
    assert batch_np['images'].shape[1:] == (6, 64, 96, 3)
    assert (batch_np['img_shape'] == [54, 96]).all()
    assert projection_margin(jcfg.n_voxels, jcfg.voxel_size,
                             batch_np) > PIXEL_MARGIN
    edge, tie = _decode_margins(serving['jax_head'], jcfg.anchor_head)
    assert edge > MARGIN and tie > TIE_MARGIN


def test_slice_matches_jax(serving):
    """Seen voxels (six views) exact; head maps, boxes and scores 2e-3;
    labels and valid exact."""
    np.testing.assert_array_equal(serving['valid'], serving['jax_valid'])
    assert 0.5 < serving['jax_valid'].mean() < 1
    for got, want in zip(serving['head'], serving['jax_head']):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    got, want = serving['res'], serving['jax_res']
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    assert got['valid'].sum(1).min() > 0
    for key in ('scores', 'boxes'):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_slice_gt_keeps_its_margins(tiny):
    """The tiny map's anchors against the slice's GT: IoUs 1e-4 from the
    assigner's thresholds, so that float rounding cannot flip an
    assignment; positives in every sample."""
    jcfg, _, batch_np, _ = tiny
    hc = jcfg.anchor_head
    anchors = np.asarray(jax_a3d.head_anchors((8, 8), hc))
    thr = np.array([hc.assigner.pos_iou_thr, hc.assigner.neg_iou_thr])
    iou = np.asarray(jax.jit(jax.vmap(jax_iou.bbox_overlaps_nearest_3d,
                                      (None, 0)))(
        jnp.asarray(anchors), jnp.asarray(batch_np['gt_boxes'])))
    for s in range(2):
        real = iou[s][:, batch_np['gt_mask'][s]]
        assert np.abs(real[..., None] - thr).min() > IOU_MARGIN
        assert (real.max(0) > hc.assigner.min_pos_iou).any()


SPE, LR_STEPS = 1, (1, 2)


@pytest.fixture(scope='module')
def slice_run(tiny):
    jcfg, cfg, batch_np, variables = tiny
    preset = jax_presets.get_preset('imvoxelnet_nuscenes')
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
    head_outs, _ = probe(tbatch)
    sum(detector.imvoxelnet_loss(cfg, head_outs, tbatch).values()).backward()
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
        assert set(j) == set(p) == {'loss_cls', 'loss_bbox', 'loss_dir',
                                    'loss'}
        for key in j:
            np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f'step {i} {key}')
    assert pl[0]['loss_bbox'] > 0 and pl[-1]['loss'] < pl[0]['loss']


def test_slice_first_step_gradients_match_jax(slice_run):
    """Every trainable gradient, the DCN's kernels and ``conv_offset``
    among them, 2e-2 x its max-abs."""
    jg, pg = slice_run['jax_grads'], slice_run['port_grads']
    noise = biases_before_bn(port_model(slice_run['cfg'],
                                        slice_run['variables']))
    assert noise == {f'neck_3d.model.{i}.0.bias' for i in (1, 3, 5)}
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
                 'backbone.layer3.0.conv2.weight',
                 'backbone.layer3.0.conv2.conv_offset.weight',
                 'backbone.layer3.0.conv2.conv_offset.bias',
                 'backbone.layer4.0.conv2.weight',
                 'backbone.layer4.0.conv2.conv_offset.weight',
                 'neck.lateral_convs.0.conv.weight',
                 'neck_3d.model.0.conv1.weight',
                 'bbox_head.conv_reg.weight', 'bbox_head.conv_dir_cls.weight'):
        assert name in nonzero, name


def test_slice_state_matches_jax_after_the_steps(slice_run):
    """The neck's BN statistics 1e-3 and every weight within Adam's sign
    flips after 3 steps."""
    ja, pa, lr = slice_run['jax_after'], slice_run['port_after'], \
        slice_run['lr']
    keys = [k for k in pa if k.startswith('neck_3d.')
            and k.endswith(('running_mean', 'running_var'))]
    assert len(keys) == 2 * 9
    for key in keys:
        np.testing.assert_allclose(pa[key].numpy(), ja[key].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=key)
    atol = 2 * lr * sum(0.1 ** i for i in range(STEPS))
    for key, got in pa.items():
        if key.endswith(('weight', 'bias')):
            np.testing.assert_allclose(got.numpy(), ja[key].numpy(), rtol=0,
                                       atol=atol, err_msg=key)
