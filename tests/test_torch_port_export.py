"""The serving export of the port (``utils/export.py``, ``tools/export.py``)
on the CPU: programs of ``tiny_kitti_test`` (weights as inputs with a
symbolic batch, and baked) and of the tiny Total3D config, saved, loaded
and run, against the port's eager forward (exactly: on CPU tensors both
run the plain versions) and the JAX package's ``make_serving_fn`` (the
cross-framework tolerance of ``tests/test_full_detector_parity.py:253``).
A program exported from CPU tensors holds the kernels' plain versions; the
CUDA program, whose kernels are ``torch.ops.imvx`` operators, is run by
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.utils import export as jax_export
from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.eval import runner
from imvoxelnet_tpu_torch.models.detector import build_model
from imvoxelnet_tpu_torch.tools import export as export_tool
from imvoxelnet_tpu_torch.utils import export as export_lib

from _torch_port_fixtures import (jax_variables, port_model,
                                  tiny_batch_np, tiny_sunrgbd_batch_np,
                                  tiny_total3d_cfgs, to_torch)

TOL = 2e-3
# the JAX forwards compiled without LLVM's optimizations (half the time)
FAST_COMPILE = {'xla_backend_optimization_level': 0}


def _jax_serving(jcfg, variables, batch_np):
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    return jax.jit(jax_export.make_serving_fn(jcfg)).lower(
        variables, batch).compile(FAST_COMPILE)(variables, batch)


def _check_equal(got, want):
    assert set(got) == set(want)
    for key, val in want.items():
        assert torch.equal(got[key], val), key


def _check_close_to_jax(got, want):
    for key in ('valid', 'labels'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in set(want) - {'valid', 'labels', 'dir_scores'}:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


# ``tiny_kitti_test`` with one bottleneck a stage, as the other tiny configs
# (``_torch_port_fixtures.py``), and 16 NMS candidates: a program traced on
# the CPU holds every op of the model, and the plain NMS's fixpoint unrolled
# over its candidates
SHALLOW = 'model.backbone_stage_blocks=(1,1,1,1)'
FEW = 'model.anchor_head.nms_pre=16'


@pytest.fixture(scope='module')
def kitti():
    """Shallow ``tiny_kitti_test`` with the slice test's weight seed, cls
    bias and batch in both packages, and the port's program with a symbolic
    batch."""
    jcfg = jax_presets.apply_overrides(
        jax_presets.get_preset('tiny_kitti_test'), [SHALLOW, FEW]).model
    cfg = presets.apply_overrides(presets.get_preset('tiny_kitti_test'),
                                  [SHALLOW, FEW]).model
    batch_np = tiny_batch_np(2, seed=3)
    variables = jax_variables(jcfg, batch_np, seed=7, cls_bias=0.0)
    variables['params']['bbox_head']['conv_cls']['kernel'] *= 10.0
    want = _jax_serving(jcfg, variables, batch_np)
    model = port_model(cfg, variables)
    exported = export_lib.export_serving(cfg, model, to_torch(batch_np),
                                         batch_size=None)
    return dict(cfg=cfg, model=model, batch_np=batch_np, exported=exported,
                jax=want)


def test_program_with_weights_as_inputs_and_a_symbolic_batch(kitti,
                                                             tmp_path):
    path = str(tmp_path / 'kitti.pt2')
    size = export_lib.save_exported(kitti['exported'], path)
    state = kitti['model'].state_dict()
    weight_bytes = sum(t.numel() * t.element_size() for t in state.values())
    assert size < weight_bytes / 4            # the weights are not in it
    program = export_lib.load_exported(path).module()
    assert export_lib.output_shapes(kitti['exported'])['boxes'][1:] == [8, 7]
    for b, seed in ((1, 11), (2, 3)):
        batch = to_torch(tiny_batch_np(b, seed=seed))
        got = program(state, batch)
        want = runner.forward(kitti['model'], kitti['cfg'], batch)
        _check_equal(got, want)
        if seed == 3:
            assert int(got['valid'].sum()) > 0
            _check_close_to_jax(got, kitti['jax'])


def test_baked_program_from_the_tool(tmp_path, capsys):
    """``tools/export.py --bake-weights --verify`` (the weights of
    ``build_model``'s seed 0) at b=1: the tool loads the program it saved
    and holds it to the eager forward; its JSON line."""
    path = str(tmp_path / 'baked.pt2')
    summary = export_tool.main(['tiny_kitti_test', '--out', path,
                                '--bake-weights', '--verify', '--device',
                                'cpu', '--override', SHALLOW, '--override',
                                FEW])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == summary
    assert line['verified'] and line['weights'] == 'baked'
    assert line['bytes'] == os.path.getsize(path)
    assert line['outputs'] == {'boxes': [1, 8, 7], 'scores': [1, 8],
                               'labels': [1, 8], 'valid': [1, 8]}
    cfg = presets.apply_overrides(presets.get_preset('tiny_kitti_test'),
                                  [SHALLOW, FEW]).model
    weights = build_model(cfg, device='cpu', seed=0).state_dict()
    assert line['bytes'] > sum(t.numel() * t.element_size()
                               for t in weights.values())


def test_layout_head_program_serves_on_predicted_extrinsics():
    """The tiny Total3D config: ``angles`` and ``layout`` among the outputs,
    the views projected with the predicted extrinsics, as JAX
    ``utils/export.py:103-108`` serves it; equal to the eager forward
    (which ``test_torch_port_total3d.py`` holds to the JAX package's)."""
    _, cfg = tiny_total3d_cfgs()
    batch_np = tiny_sunrgbd_batch_np(1, seed=2)
    model = port_model(cfg, jax_variables(tiny_total3d_cfgs()[0], batch_np,
                                          seed=4))
    batch = to_torch(batch_np)
    exported = export_lib.export_serving(cfg, model, batch)
    got = exported.module()(model.state_dict(), batch)
    assert {'angles', 'layout'} <= set(got)
    assert export_lib.output_shapes(exported)['layout'] == [1, 7]
    _check_equal(got, runner.forward(model, cfg, batch))
    with torch.no_grad():
        *_, (angles, layout) = model(batch, use_predicted_extrinsics=True)
    assert torch.equal(got['angles'], angles)
    assert torch.equal(got['layout'], layout)


def test_batch_spec_and_example_batch():
    data = presets.get_preset('imvoxelnet_scannet').data
    spec = export_lib.serving_batch_spec(data, batch_size=None)
    assert spec['images'] == ((None, 50, 480, 640, 3), torch.float32)
    assert spec['img_shape'] == ((None, 2), torch.int32)
    batch = export_lib.example_batch(2, 3, 8, 12, device='cpu')
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: ((2,) + s[1:], d) for k, (s, d) in
        export_lib.serving_batch_spec(
            dataclasses.replace(data, n_images_test=3, test_size=(12, 8)),
            batch_size=2).items()}
    with pytest.raises(ValueError, match='at least 2'):
        export_lib.export_serving(
            presets.get_preset('tiny_kitti_test').model, None,
            export_lib.example_batch(1, 1, 96, 320, device='cpu'),
            batch_size=None)
