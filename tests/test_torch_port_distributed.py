"""Data parallelism of the port over a 2-rank gloo group on the CPU
(``parallel/mesh.py``), held against one process on the same global batch:
the 3D batch norm's global statistics, a tiny KITTI step (global positive
count, gradients averaged before the one clip), the indoor
``dp_loss_norm='batch_mean'`` loss (also against the JAX
``indoor_head_loss(..., batch_mean=True)``), the view-sharded forward, and
a ``torch.distributed.checkpoint`` save and restore.

The two ranks are ``tests/_torch_port_dist_worker.py`` processes with
torchrun's environment on a free port, started once for the module, each
with a 120 s limit; the one-process references run here meanwhile.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import _torch_port_dist_worker as worker
from _torch_port_fixtures import tiny_indoor_cfgs

from imvoxelnet_tpu_torch.parallel import mesh
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt_lib
from imvoxelnet_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 120
WORKER = os.path.join(REPO, 'tests', '_torch_port_dist_worker.py')


def _indoor_inputs():
    """A b=2 SUN RGB-D global batch for the tiny v1 head: random head maps,
    every voxel seen, image 0 with its GT and image 1 with none, so that
    the per-image counts differ and the two normalizations disagree."""
    _, cfg = tiny_indoor_cfgs()
    batch = synthetic.sunrgbd_train_batch(2, 'cpu', seed=26, size=(128, 96),
                                          max_gt=12, n_classes=3)
    batch['gt_mask'][1] = False
    rng = np.random.RandomState(7)
    sizes = [tuple(n // 2 ** i for n in cfg.n_voxels) for i in range(3)]
    c = cfg.indoor_head.n_classes
    cen = [rng.randn(2, *s, 1) for s in sizes]
    box = [np.concatenate([np.exp(0.3 * rng.randn(2, *s, 6)),
                           rng.uniform(-np.pi, np.pi, (2, *s, 1))], -1)
           for s in sizes]
    cls = [rng.randn(2, *s, c) - 2.0 for s in sizes]
    heads = tuple([torch.from_numpy(x.astype(np.float32)) for x in lv]
                  for lv in (cen, box, cls))
    return dict(heads=heads, valid=torch.ones(2, *cfg.n_voxels, dtype=bool),
                origins=batch['origins'], gt_boxes=batch['gt_boxes'],
                gt_labels=batch['gt_labels'], gt_mask=batch['gt_mask'],
                cfg=cfg.indoor_head)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp('dist')
    inputs = _indoor_inputs()
    torch.save(inputs, out / 'indoor_inputs.pt')
    procs = mesh.start_ranks([sys.executable, WORKER, str(out)], WORLD,
                             cwd=REPO, OMP_NUM_THREADS='1')
    try:
        # the one-process references, while the ranks run
        kitti, trained = worker.kitti_case()
        ref = dict(bn=worker.bn_case(), kitti=kitti, trained=trained,
                   indoor=worker.indoor_loss_case(inputs),
                   indoor_per_image=worker.indoor_loss_case(inputs, False),
                   views=worker.view_case(False))
    finally:
        mesh.wait_ranks(procs, TIMEOUT)
    ranks = [torch.load(out / f'rank{r}.pt', weights_only=False)
             for r in range(WORLD)]
    return dict(ranks=ranks, ref=ref, inputs=inputs, out=out)


def _gap(got, ref):
    ref = ref.double()
    return ((got.double() - ref).abs().max() /
            ref.abs().max().clamp(min=1e-30)).item()


def test_batch_norm_takes_the_global_statistics(run):
    """Two train-mode passes (the second from a moved running mean):
    outputs, input gradients, the summed weight and bias gradients and the
    running statistics equal one process's ``F.batch_norm`` on the global
    batch."""
    ref = run['ref']['bn']
    for it in range(2):
        for key in ('y', 'dx'):
            got = torch.cat([r['bn'][key][it] for r in run['ranks']])
            assert _gap(got, ref[key][it]) < 1e-6, (key, it)
        for key in ('dw', 'db'):
            for r in run['ranks']:
                assert _gap(r['bn'][key][it], ref[key][it]) < 1e-5, (key, it)
    for r in run['ranks']:
        for key in ('running_mean', 'running_var'):
            assert _gap(r['bn'][key], ref[key]) < 1e-6, key
        assert torch.equal(r['bn']['num_batches_tracked'],
                           ref['num_batches_tracked'])


def test_kitti_step_equals_one_process_on_the_global_batch(run):
    """Losses within 1e-6 relative, gradients within 1e-5 of each tensor's
    max-abs, the updated weights and the neck's statistics within 1e-5, and
    both ranks holding the same weights after the step."""
    ref = run['ref']['kitti']
    r0, r1 = (r['kitti'] for r in run['ranks'])
    for key, value in ref['metrics'].items():
        assert abs(r0['metrics'][key] - value) <= 1e-6 * abs(value), key
        assert r1['metrics'][key] == r0['metrics'][key], key
    assert ref['metrics']['loss'] > 0
    for part in ('grads', 'params', 'buffers'):
        assert r0[part].keys() == ref[part].keys()
        for name, t in ref[part].items():
            assert _gap(r0[part][name], t) < 1e-5, (part, name)
            assert torch.equal(r1[part][name], r0[part][name]), (part, name)
    moved = [n for n in ref['buffers'] if n.endswith('running_var')
             and not torch.equal(ref['buffers'][n], torch.ones_like(
                 ref['buffers'][n]))]
    assert moved, 'no neck batch norm moved its statistics'


def test_batch_mean_over_ranks_equals_the_jax_loss(run):
    """``dp_loss_norm='batch_mean'`` over 2 ranks of one image each: the
    ranks' mean losses equal one process's port loss and the JAX
    ``indoor_head_loss(..., batch_mean=True)`` on the global batch, and
    each rank's head gradients are W times the global loss's; the
    per-image normalization gives another ``loss_cls`` here."""
    import jax
    import jax.numpy as jnp
    from imvoxelnet_tpu.models.heads import imvoxel_heads as jax_ivh

    jcfg, _ = tiny_indoor_cfgs()
    inputs = run['inputs']
    j = lambda t: jnp.asarray(t.numpy())     # noqa: E731
    # jitted: one compile (~4 s) where the eager call compiles op by op
    loss = jax.jit(functools.partial(jax_ivh.indoor_head_loss,
                                     cfg=jcfg.indoor_head, batch_mean=True))
    ref = loss(tuple([j(t) for t in lv] for lv in inputs['heads']),
               j(inputs['valid']), j(inputs['origins']),
               j(inputs['gt_boxes']), j(inputs['gt_labels']),
               j(inputs['gt_mask']))
    one = run['ref']['indoor']
    for r in run['ranks']:
        got = r['indoor']['losses']
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], float(ref[key]), rtol=2e-3,
                                       atol=1e-5, err_msg=key)
            np.testing.assert_allclose(got[key], one['losses'][key],
                                       rtol=1e-6, err_msg=key)
    for i, r in enumerate(run['ranks']):
        for lv, (got_lv, ref_lv) in enumerate(zip(r['indoor']['grads'],
                                                  one['grads'])):
            for got, t in zip(got_lv, ref_lv):
                assert _gap(got / WORLD, t[i:i + 1]) < 1e-6, lv
    per_image = run['ranks'][0]['indoor_per_image']['losses']
    assert abs(per_image['loss_cls'] - run['ranks'][0]['indoor']['losses'][
        'loss_cls']) > 1e-3


def test_view_sharded_forward_equals_the_unsharded_one(run):
    """4 views over 2 ranks: the seen mask exactly, every head map within
    1e-5 of its max-abs (only the order of the per-voxel sums differs)."""
    ref = run['ref']['views']
    assert 0 < ref['valid'].float().mean() < 1
    for r in run['ranks']:
        assert torch.equal(r['views']['valid'], ref['valid'])
        for got, t in zip(r['views']['outs'], ref['outs']):
            assert _gap(got, t) < 1e-5


def test_sharded_checkpoint_round_trip(run):
    """The DCP directory both ranks wrote restores on each rank into a
    model and optimizer of another seed bit for bit, and in one process
    with no group too."""
    for r in run['ranks']:
        ck = r['checkpoint']
        assert ck['restored_equal']
        assert ck['step'] == 1 and ck['meta']['epoch'] == 1
    path = run['out'] / 'ckpt'
    assert (path / ckpt_lib.TRAIN_STATE).exists()
    assert not (run['out'] / 'ckpt.tmp').exists()
    _, model, optimizer, scheduler = worker.kitti_setup(seed=1)
    step, _ = ckpt_lib.load_checkpoint_sharded(path, model, optimizer,
                                               scheduler)
    assert step == 1 and scheduler.last_epoch == 1
    saved = run['ranks'][0]['kitti']
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), saved['params'][name]), name
    for name, b in model.named_buffers():
        assert torch.equal(b, saved['buffers'][name]), name
    state = optimizer.state_dict()['state']
    assert len(state) == sum(len(g['params'])
                             for g in optimizer.param_groups)
    payload = ckpt_lib.read_checkpoint_sharded(path)
    assert payload['step'] == 1 and payload['meta']['epoch'] == 1
    for name, t in model.state_dict().items():
        assert torch.equal(payload['state_dict'][name], t), name
    for i, st in state.items():
        for k, t in st.items():
            assert torch.equal(payload['optimizer']['state'][i][k], t), (i, k)
