"""The port's float32 rule (``utils/precision.py``): float32 means TF32 off.

The ``allow_tf32`` flags are plain Python state, readable without a card, so
the rule is checked here on the CPU: inside a float32 training step and a
float32 profile run both flags are off, a bfloat16 run leaves them alone,
and the caller's flags come back afterwards.
"""

import contextlib
import dataclasses

import pytest
import torch

from imvoxelnet_tpu_torch.configs.presets import get_preset
from imvoxelnet_tpu_torch.models.detector import build_model
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.tools import profile_forward
from imvoxelnet_tpu_torch.utils import synthetic
from imvoxelnet_tpu_torch.utils.precision import compute_precision, tf32_flags

PRESET = 'tiny_kitti_test'


@contextlib.contextmanager
def caller_flags(cudnn, matmul):
    """Set the caller's TF32 flags for the block, then put back the
    process's own."""
    saved = tf32_flags()
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


def flags_during_forward(model):
    """Record the TF32 flags each time ``model`` runs a forward."""
    seen = []
    model.register_forward_pre_hook(lambda *_: seen.append(tf32_flags()))
    return seen


@pytest.mark.parametrize('caller', [(True, True), (True, False),
                                    (False, True)])
def test_float32_turns_tf32_off_and_restores_the_callers_flags(caller):
    with caller_flags(*caller):
        with compute_precision('float32'):
            assert tf32_flags() == (False, False)
        assert tf32_flags() == caller
        with pytest.raises(RuntimeError, match='inside'):
            with compute_precision('float32'):
                raise RuntimeError('inside')
        assert tf32_flags() == caller


@pytest.mark.parametrize('dtype', ['bfloat16', 'float64'])
def test_other_dtypes_leave_the_flags_alone(dtype):
    with caller_flags(True, True):
        with compute_precision(dtype):
            assert tf32_flags() == (True, True)
        assert tf32_flags() == (True, True)


@pytest.mark.parametrize('dtype,inside', [('float32', (False, False)),
                                          ('bfloat16', (True, True))])
def test_train_step_runs_at_its_compute_dtype(dtype, inside):
    """``make_train_step``'s step: the forward and backward of a float32
    model run with TF32 off; the caller's flags return after the step."""
    preset = get_preset(PRESET)
    cfg = dataclasses.replace(preset.model, compute_dtype=dtype)
    model = build_model(cfg, device='cpu', seed=0)
    opt, sched = train.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch=10, lr_steps=preset.lr_steps)
    step = train.make_train_step(model, opt, sched)
    seen = flags_during_forward(model)
    batch = synthetic.kitti_train_batch(1, 'cpu', seed=0,
                                        size=preset.data.train_size)
    with caller_flags(True, True):
        metrics = step(batch)
        assert tf32_flags() == (True, True)
    assert seen == [inside]
    assert torch.isfinite(metrics['loss'])


def test_profile_run_is_float32_without_tf32():
    """``profile_forward``'s forward run at ``--dtype float32`` (built on
    the CPU here; the tool itself needs a card)."""
    model, optimizer, run = profile_forward.make_run(PRESET, False, 1,
                                                     'float32', device='cpu')
    assert optimizer is None
    seen = flags_during_forward(model)
    with caller_flags(True, True):
        res = run()
        assert tf32_flags() == (True, True)
    assert seen == [(False, False)]
    assert res['boxes'].shape[0] == 1
