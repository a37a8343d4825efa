"""The PyTorch port as a package: import isolation, presets, weight bridge."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.utils.checkpoint import convert_reference_checkpoint

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models.detector import ImVoxelNet
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET_NAMES = ('imvoxelnet_kitti', 'tiny_kitti_test')


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """A tiny forward + decode and a training step in a fresh interpreter
    leave every ``jax*`` and ``flax*`` module and every
    ``imvoxelnet_tpu``/``imvoxelnet_tpu.*`` module out of ``sys.modules``
    (``imvoxelnet_tpu_torch`` shares the prefix, hence the exact-name
    test)."""
    code = textwrap.dedent('''
        import sys
        import numpy as np
        import torch
        import imvoxelnet_tpu_torch
        from imvoxelnet_tpu_torch.configs.presets import get_preset
        from imvoxelnet_tpu_torch.models.detector import (
            build_model, imvoxelnet_predict)
        cfg = get_preset('tiny_kitti_test').model
        model = build_model(cfg, device='cpu', seed=0)
        b, h, w = 1, 96, 320
        k = torch.tensor([[180., 0, 160.], [0, 180., 48.], [0, 0, 1]])
        ext = torch.tensor([[0., -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                            [0, 0, 0, 1]])
        batch = dict(images=torch.randn(b, 1, h, w, 3),
                     intrinsics=k[None], extrinsics=ext[None, None],
                     origins=torch.tensor([[12.8, 0.0, -1.0]]),
                     img_shape=torch.tensor([[h, w]], dtype=torch.int32),
                     ratios=torch.full((b,), 4.0))
        with torch.no_grad():
            head_outs, valid = model(batch)
            res = imvoxelnet_predict(cfg, head_outs)
        assert res['boxes'].shape == (1, cfg.anchor_head.max_out, 7)
        # and one training step: targets, losses, backward, optimizer
        from imvoxelnet_tpu_torch.parallel import train
        from imvoxelnet_tpu_torch.utils import synthetic
        gt = synthetic.car_boxes(np.random.RandomState(0), b, 8,
                                 (3.0, 23.0), (-0.5, 0.5), (-11.0, 11.0))
        batch.update(gt_boxes=torch.from_numpy(gt[0]),
                     gt_labels=torch.from_numpy(gt[1]),
                     gt_mask=torch.from_numpy(gt[2]))
        opt, sched = train.make_optimizer(model, 1e-4, 1e-4, 0.1, 35.0,
                                          steps_per_epoch=1)
        metrics = train.make_train_step(model, opt, sched)(batch)
        assert torch.isfinite(metrics['loss'])
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0].startswith(('jax', 'flax', 'optax'))
                     or m == 'imvoxelnet_tpu'
                     or m.startswith('imvoxelnet_tpu.'))
        print('LOADED', bad)
        sys.exit(1 if bad else 0)
    ''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


# JAX config fields the port leaves to later slices, with the values every
# ported preset must hold for them.
_JAX_ONLY = {
    'ImVoxelNetConfig': dict(indoor_head=None, layout_head=None,
                             axis_name=None, dp_loss_norm='per_image',
                             stage_with_dcn=(False,) * 4,
                             view_shard_axis=None),
    'NeckConfig': dict(channels=None, down_layers=None, up_layers=None,
                       n_blocks=None),      # indoor necks only: not read
}


def _assert_same(port, ref, path):
    if not dataclasses.is_dataclass(port):
        assert port == ref, (path, port, ref)
        return
    assert type(port).__name__ == type(ref).__name__, path
    port_fields = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name in port_fields:
            _assert_same(getattr(port, f.name), getattr(ref, f.name),
                         f'{path}.{f.name}')
            continue
        only = _JAX_ONLY.get(type(ref).__name__, {})
        assert f.name in only, f'{path}.{f.name} missing from the port'
        if only[f.name] is not None:
            assert getattr(ref, f.name) == only[f.name], (path, f.name)
    assert port_fields <= {f.name for f in dataclasses.fields(ref)}, path


@pytest.mark.parametrize('name', PRESET_NAMES)
def test_preset_equals_jax_field_for_field(name):
    port, ref = presets.get_preset(name), jax_presets.get_preset(name)
    _assert_same(port, ref, name)
    assert port.model.anchor_head.num_anchors == \
        ref.model.anchor_head.num_anchors
    assert port.model.anchor_head.box_code_size == \
        ref.model.anchor_head.box_code_size


def _randomize_bn(model, rng):
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(('running_mean', 'bias')):
                t.copy_(torch.from_numpy(
                    rng.randn(*t.shape).astype(np.float32) * 0.1))
            elif name.endswith('running_var') or (
                    name.endswith('weight') and t.dim() == 1):
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))


@pytest.mark.parametrize('name', PRESET_NAMES)
def test_state_dict_round_trip_through_the_jax_converter(name):
    """port state_dict -> convert_reference_checkpoint(strict) ->
    from_jax_variables gives the same state_dict back, key for key."""
    cfg = presets.get_preset(name).model
    jcfg = jax_presets.get_preset(name).model
    model = ImVoxelNet(cfg)
    _randomize_bn(model, np.random.RandomState(0))
    sd = model.state_dict()
    variables = convert_reference_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, jcfg, strict=True)
    back = from_jax_variables(variables, cfg)
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert back[key].dtype == val.dtype, key
        assert torch.equal(back[key], val), key


def test_state_dict_keys_are_the_reference_manifest():
    """The port's names are the released checkpoint's mmdet names."""
    from test_full_detector_parity import expected_kitti_state_dict_keys
    cfg = presets.get_preset('imvoxelnet_kitti').model
    assert set(ImVoxelNet(cfg).state_dict()) == set(
        expected_kitti_state_dict_keys())
