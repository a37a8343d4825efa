"""Run the data-parallel path once over W processes and hold it against one
process on the same global batch.

    python -m imvoxelnet_tpu_torch.tools.validate_multihost \\
        [--preset tiny_kitti_test] [--world 2] [--batch 4] [--device cuda] \\
        [--override PATH=VALUE] [--views V] [--exact]

Counterpart of the JAX package's ``tools/validate_multihost.py``: it starts
``--world`` processes with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free port of this host), each of which joins the group
through ``parallel/mesh.py:init_distributed`` (gloo on the CPU and where
ranks share a card, NCCL with a card each), runs ONE training step of the
preset (seeded weights, ``utils/synthetic.py:train_batch``) on its slice of
a global batch of ``--batch``, and returns its losses, gradients, weights,
buffers, kernel launches and peak memory; this process meanwhile runs the
same step on the whole global batch, alone, and then compares.  With
``--views V`` a serving forward of one V-view scene is split over the
ranks by view (``mesh.view_sharded_forward``) instead and held against the
unsharded forward: the ``valid`` mask exactly, each head output within
``OUT_TOL`` of its max-abs.

The last line of the output is a JSON verdict: ``ok``, the loss gap
(``dloss_rel``), the largest gaps of the gradients, buffers and updated
weights, each relative to its tensor's max-abs (``dgrads_max``,
``dbuffers_max``, ``dparams_max``), the same gaps between two one-process
steps whose samples come in another order (``noise_*``: what a mere change
in the order of the sums gives), and each rank's launches and peak memory
(:func:`compare_train` says what is checked).  ``--exact`` asks for every
number bit for bit, under ``cudnn.deterministic``.  Every worker has ``--timeout`` seconds;
one that outlives it is killed and the run fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from .. import kernels
from ..configs.presets import apply_overrides, get_preset
from ..data.loader import to_device
from ..models.detector import build_model
from ..parallel import mesh
from ..parallel import train as train_lib
from ..utils import synthetic
from ..utils.precision import compute_precision

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 0
# the limits: the loss (relative), each gradient and each BN statistic (of
# its tensor's max-abs; a gradient may also be within twice the gap that
# the batch's reverse order gives), each head output of the view-sharded
# forward (of its max-abs)
LOSS_RTOL, GRAD_TOL, BUFFER_TOL, OUT_TOL = 1e-6, 1e-5, 1e-5, 2e-3


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--preset', default='tiny_kitti_test')
    parser.add_argument('--override', action='append', default=[],
                        metavar='PATH=VALUE')
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--world', type=int, default=2)
    parser.add_argument('--batch', type=int, default=4,
                        help='the global batch of the training step')
    parser.add_argument('--views', type=int, default=None,
                        help='serve one scene of this many views, split '
                             'over the ranks, instead of a training step')
    parser.add_argument('--exact', action='store_true',
                        help='every number bit for bit (cudnn.deterministic '
                             'in every process)')
    parser.add_argument('--timeout', type=float, default=120.0)
    parser.add_argument('--master-port', type=int, default=0,
                        help='the group\'s port (0: a free one)')
    parser.add_argument('--worker', action='store_true',
                        help=argparse.SUPPRESS)
    parser.add_argument('--out', default=None, help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def _setup(args, device, view_sharded=False):
    if args.exact:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    preset = apply_overrides(get_preset(args.preset), args.override)
    cfg = preset.model
    if view_sharded:
        cfg = dataclasses.replace(cfg, view_shard_axis='view')
    model = build_model(cfg, device='cpu', seed=SEED).to(device)
    return preset, model


def _finish(device, out):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        out['peak_bytes'] = torch.cuda.max_memory_allocated(device)
    out['launches'] = kernels.launch_counts()
    return out


def train_once(args, device, reverse=False):
    """One step on this rank's slice of the global batch (the whole batch
    without a group); ``reverse``: the batch's samples in reverse order,
    which changes only the order of the sums."""
    preset, model = _setup(args, device)
    optimizer, scheduler = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, 10, preset.lr_steps)
    step = train_lib.make_train_step(model, optimizer, scheduler)
    batch = synthetic.train_batch(preset.data, args.batch, 'cpu',
                                  seed=SEED,
                                  layout=preset.model.layout_head is not None)
    if reverse:
        batch = {k: v.flip(0) for k, v in batch.items()}
    batch = to_device(mesh.shard_batch(batch), device)
    kernels.reset_launch_counts()
    metrics = {k: float(v) for k, v in step(batch).items()}
    out = _finish(device, dict(metrics=metrics))
    out['params'] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    out['grads'] = {n: p.grad.cpu() for n, p in model.named_parameters()
                    if p.grad is not None}
    out['buffers'] = {n: b.cpu() for n, b in model.named_buffers()}
    out['biases_before_bn'] = biases_before_bn(model)
    return out


def serve_once(args, device, view_sharded):
    """One serving forward of a ``--views``-view scene, split over the
    ranks by view when ``view_sharded``."""
    preset, model = _setup(args, device, view_sharded)
    d = preset.data
    if d.dataset == 'scannet':
        batch = synthetic.scannet_batch(1, args.views, 'cpu', seed=SEED,
                                        size=d.test_size)
    else:
        batch = synthetic.serving_batch(d.dataset, 1, 'cpu', seed=SEED)
        assert batch['images'].shape[1] == args.views, args.views
    forward = mesh.view_sharded_forward(model) if view_sharded else model
    kernels.reset_launch_counts()
    with torch.no_grad(), compute_precision(preset.model.compute_dtype):
        head_outs, valid = forward(to_device(batch, device))[:2]
    flat = [t for level in head_outs
            for t in (level if isinstance(level, (list, tuple)) else [level])]
    return _finish(device, dict(outs=[t.float().cpu() for t in flat],
                                valid=valid.cpu()))


def _gap(got, ref):
    """Largest ``|got - ref|`` of a tensor over its ``max |ref|``."""
    got, ref = got.double(), ref.double()
    scale = ref.abs().max().item() or 1.0
    return (got - ref).abs().max().item() / scale


def _worst(got: dict, ref: dict, exact: bool):
    gaps = {k: (0.0 if torch.equal(got[k], ref[k]) else
                float('inf') if exact else _gap(got[k], ref[k]))
            for k in ref}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def biases_before_bn(model):
    """The biases of the convs that feed a batch-statistics BN directly:
    their true gradient is 0, so every run gives float noise there."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            for (i, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(b, torch.nn.BatchNorm3d) and getattr(
                        a, 'bias', None) is not None:
                    out.append(f'{name}.{i}.bias')
    return out


def compare_train(args, results, ref, noise=None):
    """The rank-0 step against the one-process step, and (``noise``) the
    one-process step on the batch in reverse order against it: the gaps
    that another order of the sums alone gives, the scale of the rounding
    noise the step amplifies.

    Checked: the loss (``LOSS_RTOL``); every gradient but the conv
    biases before a batch-statistics BN (true gradient 0; held to be
    noise-sized, 1e-4 of their weight's gradient) within ``GRAD_TOL`` of
    its max-abs or within twice the reorder's worst gap; the buffers (the
    BN statistics) within ``BUFFER_TOL``; every rank holding the same
    weights after the step.  The updated weights' gap is reported, not
    checked: AdamW's first update, lr * g / (|g| + eps), turns a near-zero
    gradient's rounding into a move of up to lr either way (a zero-init
    bias then differs by its whole value), as it does between the two
    one-process runs."""
    got = results[0]
    loss_1, loss_n = ref['metrics']['loss'], got['metrics']['loss']
    dloss = abs(loss_n - loss_1)
    noisy = set(ref['biases_before_bn'])
    keep = [k for k in ref['grads'] if k not in noisy]

    def sub(d):
        return {k: d['grads'][k] for k in keep}
    dgrads, worst_grad = _worst(sub(got), sub(ref), args.exact)
    dbuffers, worst_buffer = _worst(got['buffers'], ref['buffers'],
                                    args.exact)
    dparams, worst = _worst(got['params'], ref['params'], args.exact)
    bias_noise = max([got['grads'][k].abs().max().item() / max(
        got['grads'][k[:-len('bias')] + 'weight'].abs().max().item(),
        1e-30) for k in noisy] + [0.0])
    floor = {}
    noise_dgrads = 0.0
    if noise is not None:
        noise_dgrads, noise_worst = _worst(sub(noise), sub(ref), False)
        floor = dict(
            noise_dloss_rel=abs(noise['metrics']['loss'] - loss_1) /
            abs(loss_1),
            noise_dgrads_max=noise_dgrads, noise_worst_grad=noise_worst,
            noise_dparams_max=_worst(noise['params'], ref['params'],
                                     False)[0])
    grad_bound = max(GRAD_TOL, 2.0 * noise_dgrads)
    # every rank makes the same update
    drank = max(_worst(r['params'], got['params'], True)[0]
                for r in results)
    ok = drank == 0 and (
        dloss == 0 and dparams == dgrads == dbuffers == 0 if args.exact else
        dloss <= LOSS_RTOL * abs(loss_1) and dgrads <= grad_bound and
        dbuffers <= BUFFER_TOL and bias_noise <= 1e-4)
    return dict(
        loss_1proc=loss_1, loss_nproc=loss_n, dloss=dloss,
        dloss_rel=dloss / abs(loss_1),
        losses_1proc=ref['metrics'], losses_nproc=got['metrics'],
        dgrads_max=dgrads, worst_grad=worst_grad, grad_bound=grad_bound,
        biases_before_bn=len(noisy), bias_grad_over_weight_grad=bias_noise,
        dbuffers_max=dbuffers, worst_buffer=worst_buffer,
        dparams_max=dparams, worst_param=worst, ranks_equal=drank == 0,
        **floor), ok


def compare_serve(args, results, ref):
    douts = [max(_gap(r['outs'][i], t) for r in results)
             for i, t in enumerate(ref['outs'])]
    valid_equal = all(torch.equal(r['valid'], ref['valid'])
                      for r in results)
    ok = valid_equal and max(douts) <= OUT_TOL
    return dict(douts_max=max(douts), valid_equal=valid_equal,
                valid_voxels=int(ref['valid'].sum())), ok


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    device = torch.device(args.device)
    if args.worker:
        _, _, device = mesh.init_distributed(device.type)
        out = (serve_once(args, device, True) if args.views
               else train_once(args, device))
        torch.save(out, os.path.join(args.out, f'rank{mesh.rank()}.pt'))
        torch.distributed.destroy_process_group()
        return 0
    if device.type == 'cuda':
        from ..kernels import build
        build.build_all()
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix='multihost_')
    procs = mesh.start_ranks(
        [sys.executable, '-m', 'imvoxelnet_tpu_torch.tools.'
         'validate_multihost', *argv, '--worker', '--out', out],
        args.world, args.master_port, cwd=_ROOT)
    # the one-process run on the global batch, while the ranks run
    ref = (serve_once(args, device, False) if args.views
           else train_once(args, device))
    try:
        mesh.wait_ranks(procs, args.timeout - (time.perf_counter() - t0))
    except RuntimeError as e:
        sys.stderr.write(f'{e}\n')
        print(json.dumps({'ok': False, 'error': str(e).splitlines()[0]}))
        return 1
    workers_s = time.perf_counter() - t0
    results = [torch.load(os.path.join(out, f'rank{r}.pt'),
                          weights_only=True) for r in range(args.world)]
    if args.views:
        verdict, ok = compare_serve(args, results, ref)
    else:
        noise = (train_once(args, device, reverse=True) if args.batch > 1
                 else None)
        verdict, ok = compare_train(args, results, ref, noise)
    verdict = dict(ok=ok, preset=args.preset, world=args.world,
                   **verdict, workers_s=workers_s,
                   launches=[r['launches'] for r in results],
                   launches_1proc=ref['launches'],
                   peak_bytes=[r.get('peak_bytes') for r in results],
                   peak_bytes_1proc=ref.get('peak_bytes'))
    print(json.dumps(verdict))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
