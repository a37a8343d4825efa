"""Module-by-module parity of the PyTorch port with the JAX package.

One random weight tree (shaped like the JAX ``ImVoxelNet`` of
``tiny_kitti_test``) feeds both packages; each JAX module runs on its own
subtree and the port's counterpart on the converted ``state_dict``.  All in
float32 on the CPU; the tolerance is the cross-framework one
(``tests/test_full_detector_parity.py``): convolutions sum in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.core import coder as jax_coder
from imvoxelnet_tpu.models import fpn as jax_fpn
from imvoxelnet_tpu.models import necks3d as jax_necks
from imvoxelnet_tpu.models import resnet as jax_resnet
from imvoxelnet_tpu.models.heads import anchor3d_head as jax_a3d
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import nms as jax_nms

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.core import anchors, coder
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import nms

from _torch_port_fixtures import jax_variables, port_model, tiny_batch_np

TOL = 2e-3


@pytest.fixture(scope='module')
def weights():
    jcfg = jax_presets.get_preset('tiny_kitti_test').model
    cfg = presets.get_preset('tiny_kitti_test').model
    variables = jax_variables(jcfg, tiny_batch_np(1), seed=2)
    return jcfg, cfg, variables, port_model(cfg, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_resnet_matches_jax(weights):
    jcfg, _, variables, model = weights
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    ref = jax_resnet.ResNet(stage_blocks=jcfg.backbone_stage_blocks).apply(
        {'params': variables['params']['backbone']}, jnp.asarray(x))
    with torch.no_grad():
        got = model.backbone(_nchw(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r,
                                   rtol=TOL, atol=TOL * np.abs(r).max())


def test_fpn_matches_jax(weights):
    jcfg, _, variables, model = weights
    rng = np.random.RandomState(1)
    # the stride-4..32 maps of a 48x160 image, one odd-sized level to take
    # the general (non-2x) upsample
    shapes = [(12, 40, 256), (6, 20, 512), (3, 10, 1024), (1, 5, 2048)]
    feats = [rng.randn(2, *s).astype(np.float32) for s in shapes]
    ref = jax_fpn.FPN(jcfg.fpn_out_channels).apply(
        {'params': variables['params']['neck']},
        [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = model.neck([_nchw(f) for f in feats])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=TOL, atol=TOL)


def test_kitti_neck_matches_jax(weights):
    jcfg, cfg, variables, model = weights
    nx, ny, nz = jcfg.n_voxels
    c = jcfg.neck.in_channels
    x = np.random.RandomState(2).randn(2, nx, ny, nz, c).astype(np.float32)
    x[0, :, :ny // 3] = 0.0                     # an unseen region
    ref = jax_necks.KittiImVoxelNeck(c, jcfg.neck.out_channels).apply(
        {'params': variables['params']['neck_3d'],
         'batch_stats': variables['batch_stats']['neck_3d']},
        jnp.asarray(x), train=False)[0]
    with torch.no_grad():
        got = model.neck_3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (2, jcfg.neck.out_channels, ny - 2, nx - 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=TOL, atol=TOL)


def test_anchor_head_matches_jax(weights):
    jcfg, _, variables, model = weights
    x = np.random.RandomState(3).randn(2, 7, 9, jcfg.neck.out_channels)
    x = x.astype(np.float32)
    ref = jax_a3d.Anchor3DHead(jcfg.anchor_head).apply(
        {'params': variables['params']['bbox_head']}, jnp.asarray(x))
    with torch.no_grad():
        got = model.bbox_head(_nchw(x))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize('name', ['imvoxelnet_kitti', 'tiny_kitti_test'])
def test_anchors_and_decode_match_jax(name):
    hcfg = presets.get_preset(name).model.anchor_head
    jh = jax_presets.get_preset(name).model.anchor_head
    got = a3d.head_anchors((7, 9), hcfg).numpy()
    ref = np.asarray(jax_a3d.head_anchors((7, 9), jh))
    np.testing.assert_array_equal(got, ref)
    deltas = np.random.RandomState(4).randn(*ref.shape).astype(np.float32)
    deltas *= 0.1
    np.testing.assert_allclose(
        coder.decode(torch.from_numpy(ref), torch.from_numpy(deltas)).numpy(),
        np.asarray(jax_coder.decode(jnp.asarray(ref), jnp.asarray(deltas))),
        rtol=1e-6, atol=1e-6)
    assert anchors.grid_anchors((7, 9), hcfg.anchor_ranges,
                                hcfg.anchor_sizes,
                                hcfg.anchor_rotations).shape == ref.shape


def test_limit_period_and_bev_match_jax():
    rng = np.random.RandomState(5)
    val = rng.uniform(-10, 10, 50).astype(np.float32)
    np.testing.assert_allclose(
        box_ops.limit_period(torch.from_numpy(val), 1.0, np.pi).numpy(),
        np.asarray(jax_boxes.limit_period(jnp.asarray(val), 1.0, np.pi)),
        rtol=1e-6, atol=1e-6)
    boxes = rng.randn(6, 7).astype(np.float32)
    np.testing.assert_array_equal(
        box_ops.bev(torch.from_numpy(boxes)).numpy(),
        np.asarray(jax_boxes.bev(jnp.asarray(boxes))))


def _nms_inputs(seed, n=40, n_classes=2, ties=False):
    """Car-sized boxes in a 12 m square, so that many overlap."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(0, 12, (n, 2)), rng.uniform(-1.5, -1.0, (n, 1)),
        rng.uniform(1.4, 1.8, (n, 1)), rng.uniform(3.4, 4.4, (n, 1)),
        rng.uniform(1.4, 1.7, (n, 1)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], axis=1).astype(np.float32)
    scores = rng.uniform(0, 1, (n, n_classes)).astype(np.float32)
    if ties:
        scores[5] = scores[3]
        scores[9] = scores[3]
    valid = rng.uniform(0, 1, n) > 0.1
    dirs = (rng.uniform(0, 1, n) > 0.5).astype(np.float32)
    return boxes, scores, valid, dirs


@pytest.mark.parametrize('seed,iou_thr,ties', [
    (0, 0.01, False), (1, 0.1, False), (2, 0.3, True)])
def test_multiclass_nms_3d_matches_jax(seed, iou_thr, ties):
    boxes, scores, valid, dirs = _nms_inputs(seed, ties=ties)
    kw = dict(score_thr=0.2, max_num=48, iou_thr=iou_thr)
    ref = jax_nms.multiclass_nms_3d(
        jnp.asarray(boxes), jax_boxes.bev(jnp.asarray(boxes)),
        jnp.asarray(scores), jnp.asarray(valid), pre_nms_k=24,
        mlvl_dir_scores=jnp.asarray(dirs), **kw)
    tb = torch.from_numpy(boxes)
    got = nms.multiclass_nms_3d(
        tb, box_ops.bev(tb), torch.from_numpy(scores),
        torch.from_numpy(valid), pre_nms_k=24,
        mlvl_dir_scores=torch.from_numpy(dirs), **kw)
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(ref['valid']))
    # some candidates survive and NMS suppresses some
    candidates = np.minimum(((scores > 0.2) & valid[:, None]).sum(0), 24)
    assert 0 < int(got['valid'].sum()) < candidates.sum()
    for key in ('labels', 'dir_scores', 'boxes', 'scores'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


def test_greedy_nms_unsorted_matches_jax():
    rng = np.random.RandomState(6)
    n = 30
    iou = rng.uniform(0, 0.6, (2, n, n)).astype(np.float32)
    iou = (iou + iou.transpose(0, 2, 1)) / 2
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    scores[0, 7] = scores[0, 3]                  # a tie
    valid = rng.uniform(0, 1, (2, n)) > 0.2
    ref = jax_nms.greedy_nms_from_iou_batched(
        jnp.asarray(iou), jnp.asarray(scores), jnp.asarray(valid), 0.3)
    got = nms.greedy_nms_from_iou_batched(
        torch.from_numpy(iou), torch.from_numpy(scores),
        torch.from_numpy(valid), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
