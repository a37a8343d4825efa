"""The port's ``apis.py`` against the JAX package's, on the CPU.

``init_detector`` + ``inference_detector`` on ``tests/test_apis.py``'s
scene, with the same weights in both packages (``from_jax_variables``):
``tiny_kitti_test`` with one-block ResNet stages, registered in both
packages' preset tables for the test (the JAX forward is compiled once).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imvoxelnet_tpu import apis as japis
from imvoxelnet_tpu.configs import presets as jax_presets

from imvoxelnet_tpu_torch import apis
from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models.detector import build_model
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt

from _torch_port_fixtures import jax_variables, shared_cores
from test_apis import _synthetic_scene

pytestmark = pytest.mark.usefixtures('shared_cores')

NAME = 'tiny_kitti_test_small_backbone'
TOL = 2e-3          # tests/test_full_detector_parity.py's rtol / atol
WEIGHT_SEED = 9


def _small(preset):
    return dataclasses.replace(preset, name=NAME, model=dataclasses.replace(
        preset.model, backbone_stage_blocks=(1, 1, 1, 1)))


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('apis')
    scene = _synthetic_scene()
    images, intrinsic, extrinsics, origin, ori_shape, img_shape = scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_presets.PRESETS, NAME,
                   _small(jax_presets.get_preset('tiny_kitti_test')))
        mp.setitem(presets.PRESETS, NAME,
                   _small(presets.get_preset('tiny_kitti_test')))
        jpreset, jmodel, _, jforward = japis.init_detector(NAME)
        batch_np = dict(
            images=images[None], intrinsics=intrinsic[None],
            extrinsics=extrinsics[None], origins=origin[None],
            img_shape=np.asarray(img_shape, np.int32)[None],
            ratios=np.asarray([ori_shape[0] / (img_shape[0] / 4.0)],
                              np.float32))
        variables = jax_variables(jpreset.model, batch_np, seed=WEIGHT_SEED,
                                  cls_bias=0.0)
        jres = japis.inference_detector(
            jpreset, jmodel, {k: jax_tree(v) for k, v in variables.items()},
            jforward, *scene)

        cfg = presets.get_preset(NAME).model
        pth = tmp / 'reference.pth'
        torch.save({'state_dict': ckpt.from_jax_variables(variables, cfg)},
                   pth)
        preset, model = apis.init_detector(NAME, torch_checkpoint=pth,
                                           device='cpu')
        tres = apis.inference_detector(preset, model, *scene)
        # the same weights as the port's train state
        opt, sched = train.make_optimizer(model, 1e-4, 1e-4, 0.1, 35.0, 1)
        state = tmp / 'latest.pth'
        ckpt.save_checkpoint(state, model, opt, sched, 0, dict(epoch=0))
        _, from_state = apis.init_detector(NAME, checkpoint=state,
                                           device='cpu')
        _, seeded = apis.init_detector(NAME, device='cpu')
    return dict(jres=jres, tres=tres, model=model, from_state=from_state,
                seeded=seeded, cfg=cfg)


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_inference_detector_equals_the_jax_api(served):
    """Counts and labels exact, boxes and scores within 2e-3."""
    jres, tres = served['jres'], served['tres']
    assert set(tres) == set(jres) == {'boxes', 'scores', 'labels'}
    assert 0 < len(tres['scores']) == len(jres['scores'])
    np.testing.assert_array_equal(tres['labels'], jres['labels'])
    for key in ('boxes', 'scores'):
        np.testing.assert_allclose(tres[key], jres[key], rtol=TOL, atol=TOL,
                                   err_msg=key)
    assert tres['boxes'].shape[1] == 7 and np.isfinite(tres['boxes']).all()


def test_checkpoint_and_torch_checkpoint_give_the_same_state_dict(served):
    a, b = served['model'].state_dict(), served['from_state'].state_dict()
    assert set(a) == set(b)
    for key, val in a.items():
        assert torch.equal(b[key], val), key
    assert not served['model'].training and not served['from_state'].training


def test_init_detector_without_a_checkpoint_seeds_from_0(served):
    want = build_model(served['cfg'], device='cpu', seed=0).state_dict()
    got = served['seeded'].state_dict()
    for key, val in want.items():
        assert torch.equal(got[key], val), key
