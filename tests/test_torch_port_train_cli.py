"""The port's training CLI (``imvoxelnet_tpu_torch.tools.train``) on a
written tiny KITTI split, on the CPU, against the JAX package.

One module-scoped run: the CLI for 2 epochs with validation from JAX
weights (``--resume-from`` a ``.pth`` of weights alone), the same CLI for 1
epoch and then for 2 (auto-resume), the test CLI on the last checkpoint,
and the JAX CLI's loop without its mesh (the JAX ``DataLoader`` epoch over
the same split and seed through ``jax.jit(make_train_step)``) from the same
weights.  ``tiny_kitti_test`` with one-block ResNet stages and
``--autoscale-lr`` (the LR / 8), so that Adam's sign flips (the known gap
of ``test_torch_port_train.py``) stay small over the epoch.
"""

import dataclasses
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.data.datasets import DATASETS as JAX_DATASETS
from imvoxelnet_tpu.data.loader import DataLoader as JaxDataLoader
from imvoxelnet_tpu.data.pipeline import (
    ImagePipelineConfig as JaxImagePipelineConfig)
from imvoxelnet_tpu.eval import runner as jrunner
from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.parallel import train as jax_train

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.tools import test as test_cli
from imvoxelnet_tpu_torch.tools import train as train_cli
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt
from imvoxelnet_tpu_torch.utils import synthetic_splits as splits

from _torch_port_fixtures import jax_variables, shared_cores

pytestmark = pytest.mark.usefixtures('shared_cores')

PRESET = 'tiny_kitti_test'
SMALL_BACKBONE = (1, 1, 1, 1)
SMALL = f'model.backbone_stage_blocks={SMALL_BACKBONE}'
# the split's cars as the one class of the tiny head (its preset lists
# Pedestrian first), so that they are the positives
CARS = "data.classes=('Car',)"
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-5
TRAIN_KEYS = {'epoch', 'iter', 'step', 'data_time', 'time', 'loss_cls',
              'loss_bbox', 'loss_dir', 'loss'}


class _Writer:
    """A stand-in ``SummaryWriter`` that keeps the scalars it is given."""

    scalars = []

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        pass


def _jax_preset():
    p = jax_presets.apply_overrides(jax_presets.get_preset(PRESET),
                                    [SMALL, CARS])
    return dataclasses.replace(p, lr=p.lr / 8)


def _jax_epoch(root, ann, variables, batch_size):
    """The JAX CLI's loop for one epoch (no mesh): its losses per step and
    the weights after it, under the port's names."""
    preset = _jax_preset()
    d = preset.data
    img_cfg = JaxImagePipelineConfig(
        test_scale=d.test_size, pad_size=(d.test_size[1], d.test_size[0]),
        train_pad_size=(d.train_size[1], d.train_size[0]),
        flip_ratio=d.flip_ratio, fixed_size_resize=False,
        train_scales=d.train_scales)
    dataset = JAX_DATASETS['kitti'](root, ann, d.classes, img_cfg,
                                    n_images=d.n_images_train,
                                    max_gt=d.max_gt, repeat=d.repeat_times)
    loader = JaxDataLoader(dataset, batch_size, train=True, seed=0,
                           num_workers=2)
    tx = jax_train.make_optimizer(
        preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, len(loader), preset.lr_steps,
        preset.total_epochs)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params))
    step = jax.jit(jax_train.make_train_step(
        jax_det.ImVoxelNet(preset.model), tx))
    losses = []
    for batch in loader.epoch(0):
        state, metrics = step(state, batch)
        losses.append({k: float(v) for k, v in metrics.items()})
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return losses, tree(state.params), tree(state.batch_stats), preset.lr


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('train_cli')
    root = str(tmp / 'kitti')
    ann = splits.kitti_split(root, 4, seed=13, frame_hw=(94, 310))
    jpreset = _jax_preset()
    # the JAX weights, shaped by a sample of the split, as the start
    _, vloader = jrunner.build_val_dataset(jpreset, PRESET, root, ann,
                                           num_workers=2, batch_size=2)
    variables = jax_variables(jpreset.model, {
        k: np.asarray(v) for k, v in next(iter(vloader.epoch(0))).items()},
        seed=9, cls_bias=0.0)
    cfg = presets.get_preset(PRESET).model
    cfg = dataclasses.replace(cfg, backbone_stage_blocks=SMALL_BACKBONE)
    start = str(tmp / 'start.pth')
    torch.save({'state_dict': ckpt.from_jax_variables(variables, cfg)},
               start)

    def cli(work, epochs, *extra):
        return train_cli.main([
            PRESET, '--data-root', root, '--ann-file', ann, '--work-dir',
            str(tmp / work), '--epochs', str(epochs), '--device', 'cpu',
            '--num-workers', '2', '--log-interval', '1', '--override', SMALL,
            '--override', CARS, '--autoscale-lr', '--val-ann-file', ann,
            '--val-batch-size', '2',
            *extra])

    with pytest.MonkeyPatch.context() as mp:
        writer = types.ModuleType('torch.utils.tensorboard')
        writer.SummaryWriter = _Writer
        mp.setitem(sys.modules, 'torch.utils.tensorboard', writer)
        straight = cli('straight', 2, '--resume-from', start)
        scalars = list(_Writer.scalars)
        # no TensorBoard here: the CLI writes its log without it
        mp.setitem(sys.modules, 'torch.utils.tensorboard', None)
        first = cli('resumed', 1, '--resume-from', start)
        first_ckpt = ckpt.load_checkpoint(first['latest'])
        second = cli('resumed', 2)
        tested = test_cli.main([
            PRESET, '--data-root', root, '--ann-file', ann, '--checkpoint',
            straight['latest'], '--device', 'cpu', '--batch-size', '2',
            '--num-workers', '2', '--override', SMALL, '--override', CARS])
    jax_losses, jax_params, jax_stats, lr = _jax_epoch(
        root, ann, variables, batch_size=jpreset.data.samples_per_device)
    jdataset, _ = jrunner.build_val_dataset(jpreset, PRESET, root, ann,
                                            num_workers=2, batch_size=2)
    return dict(straight=straight, first=first, first_ckpt=first_ckpt,
                second=second, tested=tested, scalars=scalars, cfg=cfg,
                jax_losses=jax_losses, jax_after=ckpt.from_jax_variables(
                    {'params': jax_params, 'batch_stats': jax_stats}, cfg),
                lr=lr, jax_metric_names=set(jrunner.evaluate_results(
                    jpreset, PRESET, jdataset, tested['results'])),
                work=tmp)


def test_cli_losses_and_weights_equal_the_jax_loop(runs):
    """Epoch 1 from the same weights over the same batches: every step's
    losses within 2e-3, the weights after it at ``2 * lr`` per step."""
    jl = runs['jax_losses']
    pl = [line for line in runs['straight']['train'] if line['epoch'] == 0]
    assert len(pl) == len(jl) == runs['straight']['steps_per_epoch'] == 4
    for i, (p, j) in enumerate(zip(pl, jl)):
        assert p['iter'] == i + 1 and p['step'] == i + 1
        for key, want in j.items():
            np.testing.assert_allclose(p[key], want, rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f'step {i} {key}')
    assert sum(p['loss_bbox'] > 0 for p in pl) >= 3     # positives
    atol = 2 * runs['lr'] * len(jl)
    got = runs['first_ckpt']['state_dict']
    n = 0
    for key, want in runs['jax_after'].items():
        if key.endswith(('weight', 'bias')):
            np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                       rtol=0, atol=atol, err_msg=key)
            n += 1
    assert n > 0


def test_cli_log_lines_carry_the_jax_keys(runs):
    """Train lines with the JAX CLI's keys, validation lines with ``mode:
    'val'`` and the protocol's metric names (the JAX runner's on the same
    results), the same lines in ``train_log.jsonl`` and on TensorBoard."""
    s = runs['straight']
    assert len(s['train']) == 8 and len(s['val']) == 2
    for line in s['train']:
        assert set(line) == TRAIN_KEYS
        assert line['data_time'] >= 0 and line['time'] >= line['data_time']
    for epoch, line in enumerate(s['val'], start=1):
        assert line['mode'] == 'val' and line['epoch'] == epoch
        assert line['step'] == 4 * epoch
        assert set(line) - {'mode', 'epoch', 'step'} == \
            runs['jax_metric_names']
    with open(runs['work'] / 'straight' / 'train_log.jsonl') as f:
        logged = [json.loads(x) for x in f]
    assert logged == [*s['train'][:4], s['val'][0], *s['train'][4:],
                      s['val'][1]]
    tags = {tag for tag, _, _ in runs['scalars']}
    assert 'train/loss' in tags and 'val/KITTI/Car_3D_moderate' in tags
    assert [(v, st) for tag, v, st in runs['scalars'] if tag == 'train/loss'] \
        == [(line['loss'], line['step']) for line in s['train']]


def test_cli_resume_equals_the_straight_run_bit_for_bit(runs):
    """``--epochs 1`` then ``--epochs 2`` (auto-resume from ``latest.pth``)
    against ``--epochs 2``: epoch 2's losses, the weights, buffers, AdamW
    moments and steps, the schedule's count and the step, bit for bit."""
    s, second = runs['straight'], runs['second']
    assert runs['first']['start_epoch'] == 0
    assert second['start_epoch'] == 1 and second['step'] == s['step'] == 8
    assert [line for line in second['train']] == [
        line | dict(data_time=r['data_time'], time=r['time'])
        for line, r in zip(s['train'][4:], second['train'])]
    assert second['val'] == s['val'][1:]
    a = ckpt.load_checkpoint(s['latest'])
    b = ckpt.load_checkpoint(second['latest'])
    assert a['step'] == b['step'] == 8 and a['meta'] == b['meta']
    assert a['scheduler'] == b['scheduler'] == {'last_epoch': 8}
    assert a['meta'] == dict(preset=PRESET, classes=['Car'], epoch=2)
    for key, val in a['state_dict'].items():
        assert torch.equal(b['state_dict'][key], val), key
    assert a['optimizer']['param_groups'] == b['optimizer']['param_groups']
    assert a['optimizer']['state'].keys() == b['optimizer']['state'].keys()
    for i, state in a['optimizer']['state'].items():
        for key, val in state.items():
            assert torch.equal(b['optimizer']['state'][i][key], val), (i, key)


def test_test_cli_checkpoint_gives_the_last_validation(runs):
    """``tools.test --checkpoint latest.pth`` on the val split: the metrics
    of the training run's last ``mode: 'val'`` line."""
    last = runs['straight']['val'][-1]
    metrics = runs['tested']['metrics']
    assert {k: float(v) for k, v in metrics.items()} == {
        k: v for k, v in last.items() if k not in ('mode', 'epoch', 'step')}
    assert sum(len(r['scores']) for r in runs['tested']['results']) > 0
