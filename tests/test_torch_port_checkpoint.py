"""The port's train-state checkpoints on the CPU: the save/load round trip,
a resume against the unbroken run, and a JAX train state carried across.

``tiny_kitti_test`` with one-block ResNet stages; the schedule steps at
updates 1 and 2 (``SPE``, ``LR_STEPS``), so that the LR a restore gives
back is not the initial one.  The JAX step is compiled once (one batch
shape).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.parallel import train as jax_train
from imvoxelnet_tpu.utils.checkpoint import convert_reference_checkpoint

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models.detector import build_model
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt
from imvoxelnet_tpu_torch.utils import synthetic

from _torch_port_fixtures import (jax_variables, port_model, shared_cores,
                                  tiny_batch_np, to_torch)

pytestmark = pytest.mark.usefixtures('shared_cores')

PRESET = 'tiny_kitti_test'
SMALL_BACKBONE = (1, 1, 1, 1)
SPE, LR_STEPS = 1, (1, 2)
# the biases of the convs before a batch-statistics BN: a true gradient of 0
# (test_torch_port_train.py's second known gap)
BIASES_BEFORE_BN = tuple(f'neck_3d.model.{i}.0.bias' for i in (1, 3, 5))


def _cfgs():
    jp, p = jax_presets.get_preset(PRESET), presets.get_preset(PRESET)
    return tuple(dataclasses.replace(x, model=dataclasses.replace(
        x.model, backbone_stage_blocks=SMALL_BACKBONE)) for x in (jp, p))


def _batch_np(seed=4):
    batch = tiny_batch_np(2, seed=seed)
    boxes, labels, mask = synthetic.car_boxes(
        np.random.RandomState(seed), 2, 8, (3.0, 23.0), (-0.5, 0.5),
        (-11.0, 11.0))
    batch.update(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)
    return batch


def _trainer(model, preset):
    opt, sched = train.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch=SPE, lr_steps=LR_STEPS)
    return opt, sched


def _moments(opt):
    """Each optimizer state tensor, by (parameter index, key)."""
    sd = opt.state_dict()
    return {(i, k): v for i, s in sd['state'].items() for k, v in s.items()}


def _assert_same_bits(got, want, what):
    assert set(got) == set(want), what
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype, (what, key)
        assert torch.equal(got[key], ref), (what, key)


def test_save_load_round_trip_is_bit_exact(tmp_path):
    _, preset = _cfgs()
    model = build_model(preset.model, device='cpu', seed=1)
    opt, sched = _trainer(model, preset)
    step = train.make_train_step(model, opt, sched)
    batch = to_torch(_batch_np())
    for _ in range(2):
        step(batch)
    path = tmp_path / 'latest.pth'
    meta = dict(preset=PRESET, classes=['Car'], epoch=3)
    ckpt.save_checkpoint(path, model, opt, sched, 2, meta)
    assert sorted(p.name for p in tmp_path.iterdir()) == ['latest.pth']

    payload = ckpt.load_checkpoint(path)
    assert set(payload) == {'state_dict', 'optimizer', 'scheduler', 'step',
                            'meta'}
    assert payload['step'] == 2 and payload['meta'] == meta
    fresh = build_model(preset.model, device='cpu', seed=2)
    fopt, fsched = _trainer(fresh, preset)
    ckpt.restore_train_state(fresh, fopt, fsched, payload['state_dict'],
                             payload['optimizer'],
                             payload['scheduler']['last_epoch'])
    _assert_same_bits(fresh.state_dict(), model.state_dict(), 'state_dict')
    _assert_same_bits(_moments(fopt), _moments(opt), 'optimizer state')
    assert len(_moments(opt)) == 3 * sum(
        p.requires_grad for p in model.parameters())
    assert fsched.last_epoch == sched.last_epoch == 2
    assert fsched.get_last_lr() == sched.get_last_lr()
    assert [g['lr'] for g in fopt.param_groups] == \
        [g['lr'] for g in opt.param_groups] == pytest.approx(
            [preset.lr * preset.backbone_lr_mult * 1e-2, preset.lr * 1e-2])
    # a reference-style loader reads the weights of the train state
    _assert_same_bits(ckpt.load_reference_state_dict(path),
                      model.state_dict(), 'reference loader')


def test_resume_equals_the_unbroken_run_bit_for_bit(tmp_path):
    """4 steps straight against 2 steps, save, a new model and optimizer
    (other seed), load, 2 steps: every loss, weight, buffer and AdamW
    tensor bit for bit.  ``make_train_step``'s zero gradients leave the
    loaded moments alone."""
    _, preset = _cfgs()
    batches = [to_torch(_batch_np(seed)) for seed in (4, 5, 6, 7)]

    def run(model, opt, sched, part):
        step = train.make_train_step(model, opt, sched)
        return [{k: v.clone() for k, v in step(b).items()} for b in part]

    straight = build_model(preset.model, device='cpu', seed=1)
    sopt, ssched = _trainer(straight, preset)
    want = run(straight, sopt, ssched, batches)

    first = build_model(preset.model, device='cpu', seed=1)
    fopt, fsched = _trainer(first, preset)
    got = run(first, fopt, fsched, batches[:2])
    path = tmp_path / 'latest.pth'
    ckpt.save_checkpoint(path, first, fopt, fsched, 2, dict(epoch=1))
    payload = ckpt.load_checkpoint(path)
    resumed = build_model(preset.model, device='cpu', seed=3)
    ropt, rsched = _trainer(resumed, preset)
    ckpt.restore_train_state(resumed, ropt, rsched, payload['state_dict'],
                             payload['optimizer'],
                             payload['scheduler']['last_epoch'])
    loaded = {k: v.clone() for k, v in _moments(ropt).items()}
    step = train.make_train_step(resumed, ropt, rsched)
    _assert_same_bits(_moments(ropt), loaded, 'moments after the zero grads')
    got += [{k: v.clone() for k, v in step(b).items()} for b in batches[2:]]

    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_bits(g, w, f'losses of step {i}')
    _assert_same_bits(resumed.state_dict(), straight.state_dict(),
                      'state_dict')
    _assert_same_bits(_moments(ropt), _moments(sopt), 'optimizer state')
    assert rsched.last_epoch == ssched.last_epoch == 4
    assert [g['lr'] for g in ropt.param_groups] == \
        [g['lr'] for g in sopt.param_groups]


# --------------------------------------------------------------------------
# a JAX train state carried across
# --------------------------------------------------------------------------

def _adam_state(opt_state):
    """AdamW's ``mu``, ``nu`` (numpy, ``None`` where the optimizer leaves a
    parameter alone) and ``count`` out of the JAX ``make_optimizer``'s
    state: ``chain(mask, clip, multi_transform({'backbone', 'rest',
    'frozen'}))``, each AdamW behind its label's mask."""
    parts = opt_state[2].inner_states
    adams = [parts[k].inner_state[0] for k in ('backbone', 'rest')]
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731

    def pick(*leaves):
        found = [np.asarray(x) for x in leaves if not masked(x)]
        assert len(found) <= 1
        return found[0] if found else None

    out = {key: jax.tree_util.tree_map(
        pick, *(getattr(a, key) for a in adams), is_leaf=masked)
        for key in ('mu', 'nu')}
    counts = {int(a.count) for a in adams}
    assert len(counts) == 1
    return dict(out, count=counts.pop())


@pytest.fixture(scope='module')
def carried():
    """JAX takes step 1; its state is carried into the port; both take
    step 2 on the same batch."""
    jpreset, preset = _cfgs()
    batch_np = _batch_np()
    variables = jax_variables(jpreset.model, batch_np, seed=9)
    lr = preset.lr
    tx = jax_train.make_optimizer(
        lr, jpreset.weight_decay, jpreset.backbone_lr_mult,
        jpreset.grad_clip_norm, steps_per_epoch=SPE, lr_steps=LR_STEPS)
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params))
    step_fn = jax.jit(jax_train.make_train_step(
        jax_det.ImVoxelNet(jpreset.model), tx))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    state, _ = step_fn(state, batch)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params1, stats1 = tree(state.params), tree(state.batch_stats)
    adam1 = _adam_state(state.opt_state)
    sd, opt_sd, sched_step = ckpt.from_jax_train_state(
        params1, stats1, adam1, int(state.step), preset.model)

    model = port_model(preset.model, variables)      # the step-0 weights
    opt, sched = _trainer(model, preset)
    ckpt.restore_train_state(model, opt, sched, sd, opt_sd, sched_step)
    carried_moments = {k: v.clone() for k, v in _moments(opt).items()}
    lr_carried = [g['lr'] for g in opt.param_groups]
    port_metrics = train.make_train_step(model, opt, sched)(to_torch(
        batch_np))
    state, jax_metrics = step_fn(state, batch)
    schedule = optax.piecewise_constant_schedule(
        lr, {e * SPE: 0.1 for e in LR_STEPS})
    return dict(
        preset=preset, jcfg=jpreset.model, model=model, opt=opt,
        sched=sched, carried_moments=carried_moments, adam1=adam1,
        params1=params1, stats1=stats1, lr_carried=lr_carried,
        schedule=schedule, port_metrics=port_metrics,
        jax_metrics=jax_metrics, jax_after=ckpt.from_jax_variables(
            {'params': tree(state.params),
             'batch_stats': tree(state.batch_stats)}, preset.model),
        adam2=_adam_state(state.opt_state), jax_step=int(state.step),
        sched_step=sched_step)


def test_carried_moments_equal_the_jax_converter():
    """A JAX train state of the full-depth ``tiny_kitti_test`` (seeded
    weights, random ``mu`` and ``nu``, frozen leaves without moments) carried
    into
    the port: every trainable parameter's ``exp_avg`` / ``exp_avg_sq``,
    taken back through the JAX package's own converter
    (``convert_reference_checkpoint``), is the JAX ``mu`` / ``nu`` bit for
    bit; a frozen parameter has no state; the step counts and the schedule
    are the state's."""
    jcfg = jax_presets.get_preset(PRESET).model
    preset = presets.get_preset(PRESET)
    model = build_model(preset.model, device='cpu', seed=3)
    # the JAX tree of these weights, through the JAX package's converter
    variables = convert_reference_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg,
        strict=True)
    labels = jax_train.param_labels(variables['params'])
    # every entry of every moment distinct (exact in float32): a transposed
    # or misplaced one shows
    leaf = iter(range(1, 10**6))
    moments = {key: jax.tree_util.tree_map(
        lambda p, lab: None if lab == 'frozen' else (np.arange(
            1, p.size + 1, dtype=np.float32).reshape(p.shape)
            * np.float32(1 + next(leaf) * 1e-3)),
        variables['params'], labels) for key in ('mu', 'nu')}
    sd, opt_sd, sched_step = ckpt.from_jax_train_state(
        variables['params'], variables['batch_stats'],
        dict(moments, count=3), 3, preset.model)
    opt, sched = _trainer(model, preset)
    ckpt.restore_train_state(model, opt, sched, sd, opt_sd, sched_step)
    assert sched.last_epoch == 3
    assert [g['lr'] for g in opt.param_groups] == pytest.approx(
        [preset.lr * preset.backbone_lr_mult * 1e-2, preset.lr * 1e-2])

    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    assert 0 < len(trainable) < len(list(model.parameters()))
    for name, p in model.named_parameters():
        assert (p in opt.state) == p.requires_grad, name
    base = {k: v.numpy() for k, v in model.state_dict().items()}
    params = dict(model.named_parameters())
    for key, jkey in (('exp_avg', 'mu'), ('exp_avg_sq', 'nu')):
        state = dict(base)
        for name in trainable:
            assert float(opt.state[params[name]]['step']) == 3.0
            state[name] = opt.state[params[name]][key].numpy()
        back = convert_reference_checkpoint(state, jcfg,
                                            strict=True)['params']
        compared = 0
        for path, got in jax.tree_util.tree_leaves_with_path(back):
            ref = moments[jkey]
            for k in path:
                ref = ref[k.key]
            if ref is not None:
                np.testing.assert_array_equal(got, ref, err_msg=str(path))
                compared += 1
        assert compared == len(trainable), key


def test_carried_step_counts_and_lr_equal_jax(carried):
    adam1 = carried['adam1']
    assert adam1['count'] == 1 == carried['sched_step']
    for (_, key), val in carried['carried_moments'].items():
        if key == 'step':
            assert float(val) == 1.0
    # the LR of the second update, the schedule at count 1: x0.1
    jax_lr = float(carried['schedule'](1))
    preset = carried['preset']
    assert np.float32(carried['lr_carried'][1]) == np.float32(jax_lr)
    assert np.float32(carried['lr_carried'][0]) == np.float32(
        jax_lr * preset.backbone_lr_mult)
    # after step 2 in both: count 2, LR x0.01
    assert carried['adam2']['count'] == carried['jax_step'] == 2
    assert carried['sched'].last_epoch == 2
    steps = {float(v) for (_, k), v in _moments(carried['opt']).items()
             if k == 'step'}
    assert steps == {2.0}
    assert np.float32(carried['opt'].param_groups[1]['lr']) == np.float32(
        carried['schedule'](2))


def test_second_step_after_the_carry_matches_jax(carried):
    """Step 2 in both packages: the losses, the weights at ``2 * lr`` of
    that step (``test_torch_port_train.py``'s tolerance per step), and the
    moments it updated (the carried ``mu`` / ``nu`` enter the update) at
    2e-2 x max-abs, the first-step gradients' tolerance there."""
    for key, val in carried['jax_metrics'].items():
        np.testing.assert_allclose(float(carried['port_metrics'][key]),
                                   float(val), rtol=5e-3, atol=1e-5,
                                   err_msg=key)
    atol = 2 * float(carried['schedule'](1))
    got = carried['model'].state_dict()
    for key, want in carried['jax_after'].items():
        if key.endswith(('weight', 'bias')):
            np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                       rtol=0, atol=atol, err_msg=key)
    model, opt = carried['model'], carried['opt']
    index = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g['params'])}
    moments = _moments(opt)
    # AdamW's moment updates, m2 = b m1 + (1 - b) u(g2) (u(g) = g, or g^2
    # for nu), solved for u(g2) from the carried m1: the second step's
    # gradient in each package, within 5e-2 of its norm (1e-1 for its
    # square).  A carried moment the update ignored, or one put on another
    # parameter, moves it by the order of b / (1 - b) m1, 9 to 999 times
    # the moment.  The norm, not the max-abs: 2 of the 110,592 entries of
    # block2's conv2 gradient differ by 7% of its max-abs at step 2
    for key, jkey, beta, tol in (('exp_avg', 'mu', 0.9, 5e-2),
                                 ('exp_avg_sq', 'nu', 0.999, 1e-1)):
        m1, m2 = (ckpt.from_jax_variables(
            {'params': ckpt._filled(carried[adam][jkey], carried['params1']),
             'batch_stats': carried['stats1']}, carried['preset'].model)
            for adam in ('adam1', 'adam2'))
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            i = index[id(p)]
            first = m1[name].numpy()
            assert np.array_equal(carried['carried_moments'][(i, key)]
                                  .numpy(), first), (key, name)
            got = (moments[(i, key)].numpy() - beta * first) / (1 - beta)
            want = (m2[name].numpy() - beta * first) / (1 - beta)
            if name in BIASES_BEFORE_BN:
                # a true gradient of 0, float noise in both packages
                scale = np.abs(m2[name.replace('bias', 'weight')]).max()
                assert np.abs(m2[name].numpy()).max() < 1e-4 * scale, name
                assert np.abs(moments[(i, key)].numpy()).max() < \
                    1e-4 * scale, name
                continue
            assert np.linalg.norm(got - want) <= tol * np.linalg.norm(
                want), (key, name)
