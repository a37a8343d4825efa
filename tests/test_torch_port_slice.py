"""The whole KITTI slice of the PyTorch port against the JAX package.

``tiny_kitti_test`` on the CPU: the JAX ``ImVoxelNet`` + ``imvoxelnet_predict``
and the port's, with the same weights (through ``from_jax_variables``) and
the same numpy batch.  On CPU tensors the port runs every kernel's plain
version; the JAX side runs its production (XLA) path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.core import coder as jax_coder
from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models.heads import anchor3d_head as jax_a3d
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import nms as jax_nms

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models import detector

from _torch_port_fixtures import (jax_variables, port_model,
                                  projection_margin, tiny_batch_np, to_torch)

# rtol/atol of the cross-framework full-detector tests
# (tests/test_full_detector_parity.py): f32 convs summed in another order
TOL = 2e-3
MARGIN = 1e-3


@pytest.fixture(scope='module')
def slice_outputs():
    jcfg = jax_presets.get_preset('tiny_kitti_test').model
    cfg = presets.get_preset('tiny_kitti_test').model
    batch_np = tiny_batch_np(2, seed=3)
    # cls bias 0: scores near 0.5, so detections pass score_thr 0.1
    variables = jax_variables(jcfg, batch_np, seed=7, cls_bias=0.0)
    # spread the scores so that no two NMS candidates nearly tie
    variables['params']['bbox_head']['conv_cls']['kernel'] *= 10.0

    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    model = jax_det.ImVoxelNet(jcfg)

    @jax.jit
    def forward(variables, batch):
        head_outs, valid, f2d = model.apply(variables, batch, train=False)
        return head_outs, valid, jax_det.imvoxelnet_predict(
            jcfg, head_outs, valid, f2d, batch)

    head_outs, valid, res = forward(variables, batch)
    jax_out = dict(valid=np.asarray(valid),
                   head=[np.asarray(o) for o in head_outs],
                   res={k: np.asarray(v) for k, v in res.items()})

    tmodel = port_model(cfg, variables)
    with torch.no_grad():
        t_head, t_valid = tmodel(to_torch(batch_np))
        t_res = detector.imvoxelnet_predict(cfg, t_head)
    port_out = dict(valid=t_valid.numpy(),
                    head=[o.numpy() for o in t_head],
                    res={k: v.numpy() for k, v in t_res.items()})
    return jcfg, batch_np, jax_out, port_out


def test_fixture_keeps_its_margins(slice_outputs):
    """The comparison is only meaningful away from knife edges: pixel
    rounding, the score threshold, the NMS IoU threshold and score ties
    among the NMS candidates."""
    jcfg, batch_np, jax_out, _ = slice_outputs
    head_cfg = jcfg.anchor_head
    assert projection_margin(jcfg.n_voxels, jcfg.voxel_size,
                             batch_np) > 5e-4
    cls_score, bbox_pred, _ = jax_out['head']
    scores = 1 / (1 + np.exp(-cls_score.astype(np.float64)))
    for i in range(scores.shape[0]):
        s = np.sort(scores[i].reshape(-1))[::-1]
        top = s[:head_cfg.nms_pre + 1]
        assert np.abs(top - head_cfg.score_thr).min() > MARGIN
        # exact ties rank by index in both packages; near-ties could swap
        assert np.diff(np.unique(top)).min() > 1e-5
    # every pair that decides a suppression (a kept NMS candidate and a
    # later one) keeps its IoU away from the threshold
    anchors = jax_a3d.head_anchors(cls_score.shape[1:3], head_cfg)
    for i in range(scores.shape[0]):
        logits, ids = jax.lax.top_k(jnp.asarray(cls_score[i].reshape(-1)),
                                    head_cfg.nms_pre)
        boxes = jax_coder.decode(anchors[ids], jnp.asarray(
            bbox_pred[i].reshape(-1, head_cfg.box_code_size))[ids])
        iou = jax_iou.rotated_iou_bev(jax_boxes.bev(boxes),
                                      jax_boxes.bev(boxes))
        keep = np.asarray(jax_nms.greedy_nms_from_iou_batched(
            iou, logits, jax.nn.sigmoid(logits) > head_cfg.score_thr,
            head_cfg.iou_thr, presorted=True))
        later = np.triu(np.ones(iou.shape, bool), 1)
        deciding = np.asarray(iou)[keep[:, None] & later]
        assert np.abs(deciding - head_cfg.iou_thr).min() > MARGIN


def test_slice_valid_mask_exact(slice_outputs):
    _, _, jax_out, port_out = slice_outputs
    np.testing.assert_array_equal(port_out['valid'], jax_out['valid'])
    assert 0 < port_out['valid'].mean() < 1


@pytest.mark.parametrize('i', [0, 1, 2], ids=['cls', 'reg', 'dir'])
def test_slice_head_maps_match(slice_outputs, i):
    _, _, jax_out, port_out = slice_outputs
    np.testing.assert_allclose(port_out['head'][i], jax_out['head'][i],
                               rtol=TOL, atol=TOL)


def test_slice_detections_match(slice_outputs):
    _, _, jax_out, port_out = slice_outputs
    want, got = jax_out['res'], port_out['res']
    np.testing.assert_array_equal(got['valid'], want['valid'])
    np.testing.assert_array_equal(got['labels'], want['labels'])
    assert got['valid'].sum() > 0
    np.testing.assert_allclose(got['scores'], want['scores'], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got['boxes'], want['boxes'], rtol=TOL,
                               atol=TOL)
