"""Export a preset's serving forward as a ``torch.export`` program (.pt2).

    python -m imvoxelnet_tpu_torch.tools.export PRESET --out F.pt2 \\
        [--checkpoint latest.pth | --torch-checkpoint ref.pth] \\
        [--batch-size 1] [--poly-batch] [--platforms cuda,cpu] \\
        [--bake-weights] [--verify] [--override PATH=VALUE] [--device cuda]
    torchrun --nproc-per-node W -m imvoxelnet_tpu_torch.tools.export \\
        PRESET --out F.pt2 (--view-sharded | --data-sharded) [--verify] ...

Counterpart of the JAX package's ``tools/export.py``: the forward +
decode/NMS (``utils/export.py``, fixed-size outputs) traced once on the
device that will serve (the card unless ``--device cpu``), its kernels as
``torch.ops.imvx`` operators, saved as one PT2 archive.  Without
``--bake-weights`` the program takes the model's ``state_dict`` as its
first input and holds no weights.  ``--poly-batch`` exports a symbolic
batch dimension (``--batch-size``, at least 2, then sizes the traced and
the ``--verify`` batch).  The weights are random from seed 0 unless a
checkpoint is given; the batch is the preset's synthetic serving batch
(``utils/synthetic.serving_batch``, real camera geometry) at its test size.
A float32 preset is traced and run with TF32 off.  Prints one JSON line
(rank 0).

The multi-device programs (``utils/export.py``):

* ``--platforms cuda,cpu``: one archive with a program per platform, each
  traced on its own device (the CPU one holds the kernels' plain
  versions); ``utils/export.load_exported`` picks the current device's.
* ``--view-sharded``: under torchrun's environment
  (``parallel/mesh.py:init_distributed``), the program every rank loads,
  whose batch is the rank's share of the views; the views' (sum, count)
  pair is summed over the ranks inside the program, the neck, head and
  decode run replicated.  ``n_images_test`` must divide by the world size.
* ``--data-sharded``: the single-device program at ``--batch-size / W``,
  which each rank runs on its slice of the batch; no collective, the
  outputs batch-sharded.  ``--batch-size`` must divide by the world size.

``--view-sharded``, ``--data-sharded`` and ``--poly-batch`` exclude each
other, and a sharded program is traced for ``--device`` alone (no
``--platforms``).  ``--verify`` loads the artifact in the same process and
holds its detections to the eager forward's (labels and ``valid`` exactly,
boxes and scores within ``DET_TOL``), with the kernel launches of the call
and the largest gap (``program_gap``): each platform's program on its
device against the eager forward there.  A sharded program is held in two
links.  Every rank holds its program's detections to the eager sharded
forward on the same share (the same operations in the same order:
``program_gaps``).  Rank 0 gathers the ranks' outputs and head outputs and
holds them to the unsharded eager forward on the whole batch: the head
outputs within ``OUT_TOL`` of their max-abs (``head_outputs_gap``), the
detections as above.  Where the decode breaks a near tie otherwise (the
views' sums are added in another order), each sample must still have as
many detections with the same labels and scores (sorted; the boxes of the
tie may differ), and ``decode_differs`` says where it differed.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import time

import torch
import torch.distributed as dist

from .. import kernels
from ..configs.presets import apply_overrides, get_preset
from ..models.detector import build_model
from ..parallel import mesh
from ..utils import checkpoint as ckpt_lib
from ..utils import export as export_lib
from ..utils.precision import compute_precision
from ..utils.synthetic import serving_batch

# detections against the eager forward; a sharded forward's head outputs
# against the unsharded ones, of their max-abs (50-view ScanNet over two
# ranks on an H100 in float32: 2.9e-6)
DET_TOL, OUT_TOL = 1e-5, 1e-5
_DETECTION = ('boxes', 'scores', 'labels', 'valid')


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset', nargs='?', default='imvoxelnet_kitti')
    parser.add_argument('--out', required=True)
    parser.add_argument('--batch-size', type=int, default=None,
                        help='samples of the traced batch (default 1; 2 '
                             'with --poly-batch)')
    parser.add_argument('--poly-batch', action='store_true',
                        help='export with a symbolic batch dim: one program '
                             'serves any batch size')
    parser.add_argument('--checkpoint', default=None,
                        help="the port's train state (tools/train.py's "
                             "latest.pth)")
    parser.add_argument('--torch-checkpoint', default=None,
                        help='reference mmdet checkpoint (.pth)')
    parser.add_argument('--platforms', default=None,
                        help='comma list of cuda and cpu: one program per '
                             'platform in one archive (default: --device '
                             'only)')
    parser.add_argument('--bake-weights', action='store_true',
                        help='store the weights in the program (one-file '
                             'deploy)')
    parser.add_argument('--view-sharded', action='store_true',
                        help='the view axis split over the ranks of '
                             "torchrun's group (backbone/FPN/gather per "
                             'shard, the sums pooled over the ranks)')
    parser.add_argument('--data-sharded', action='store_true',
                        help='the batch split over the ranks of '
                             "torchrun's group")
    parser.add_argument('--verify', action='store_true',
                        help='load the program and check it against the '
                             'eager forward')
    parser.add_argument('--override', action='append', default=None,
                        metavar='PATH=VALUE',
                        help='preset field override, e.g. '
                             'model.indoor_head.score_thr=0.1 (repeatable)')
    parser.add_argument('--device', default='cuda')
    return parser


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def close(got, want, tol=DET_TOL):
    """Raise unless the detections ``got`` equal ``want``: integer and
    boolean outputs exactly, the others within ``tol`` (absolute and
    relative), naming the first output that differs, how many of its
    elements and by how much."""
    if set(got) != set(want):
        raise AssertionError(f'outputs {sorted(got)} != {sorted(want)}')
    for key, ref in want.items():
        a, b = got[key].cpu(), ref.cpu()
        exact = ref.dtype in (torch.bool, torch.int32, torch.int64)
        bad = (a != b) if exact else ~torch.isclose(a, b, rtol=tol, atol=tol)
        if bool(bad.any()):
            gap = 0 if exact else float((a - b).abs().max())
            raise AssertionError(f'{key}: {int(bad.sum())} of {b.numel()} '
                                 f'elements differ (largest gap {gap:.3g})')


def largest_gap(got, want):
    """The largest gap of a floating output of ``got`` from ``want``'s."""
    return max((float((got[k].cpu().double() - v.cpu().double()).abs().max())
                for k, v in want.items() if v.is_floating_point()),
               default=0.0)


def same_detections(got, want, tol=DET_TOL):
    """Where a decode breaks a near tie otherwise: ``None`` if every
    sample has as many valid detections as ``want``, with the same labels
    and scores (each sorted; scores within ``tol``) and the other outputs
    but the boxes equal; else what differs."""
    for i in range(want['valid'].shape[0]):
        g, w = got['valid'][i].cpu().bool(), want['valid'][i].cpu().bool()
        if int(g.sum()) != int(w.sum()):
            return f'sample {i}: {int(g.sum())} detections, not {int(w.sum())}'
        labels = [t['labels'][i].cpu()[m].sort().values
                  for t, m in ((got, g), (want, w))]
        scores = [t['scores'][i].cpu()[m].sort().values
                  for t, m in ((got, g), (want, w))]
        if not torch.equal(*labels):
            return f'sample {i}: labels {labels[0].tolist()} != ' \
                   f'{labels[1].tolist()}'
        if not torch.allclose(*scores, rtol=tol, atol=tol):
            return f'sample {i}: scores differ by ' \
                   f'{float((scores[0] - scores[1]).abs().max()):.3g}'
    try:
        close({k: v for k, v in got.items() if k not in _DETECTION},
              {k: v for k, v in want.items() if k not in _DETECTION})
    except AssertionError as e:
        return str(e)
    return None


def _flat(head_outs):
    return [t.float() for level in head_outs for t in (
        level if isinstance(level, (list, tuple)) else [level])]


def head_gap(got, ref):
    """The largest gap of a head output over its max-abs."""
    return max(float((a.double() - b.double()).abs().max()) /
               (float(b.abs().max()) or 1.0) for a, b in zip(got, ref))


def input_shapes(exported):
    """``{name: shape}`` of a program's batch inputs."""
    return {n.name.split('batch_')[-1]: list(n.meta['val'].shape)
            for n in exported.graph.nodes
            if n.op == 'placeholder' and n.name.startswith('batch_')}


def collectives(exported):
    """How many collective operations (``_c10d_functional``) a program
    calls."""
    return sum(str(n.target).startswith('_c10d_functional.')
               and 'wait_tensor' not in str(n.target)
               for n in exported.graph.nodes if n.op == 'call_function')


def _call(program, args, batch, state):
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = program(batch) if args.bake_weights else program(state, batch)
    if batch['images'].is_cuda:
        torch.cuda.synchronize()
    return out, kernels.launch_counts()


def verify_one(args, cfg, model, batch, platform):
    """The archive's program for ``platform`` on ``batch`` (on that
    platform's device) against the eager forward there; returns the
    launches of the program's call, its largest gap and the eager forward's
    detections."""
    device = batch['images'].device
    if next(model.parameters()).device.type != device.type:
        model = copy.deepcopy(model).to(device)
    state = model.state_dict()
    program = export_lib.load_exported(args.out, platform).module()
    got, launches = _call(program, args, batch, state)
    with torch.no_grad():
        want = export_lib.make_serving_fn(cfg, model)(state, batch)
    try:
        close(got, want)
    except AssertionError as e:
        raise AssertionError(f'--verify {platform}: {e}') from None
    return dict(launches=launches, program_gap=largest_gap(got, want),
                detections=int(want['valid'].sum()))


def verify_sharded(args, cfg, model, batch, shard, sharding):
    """Every rank calls the program on its share and holds its detections
    to the eager sharded forward on the same share; rank 0 holds the
    gathered outputs and head outputs to the unsharded eager forward on the
    whole batch.  Returns rank 0's findings (on every rank)."""
    program = export_lib.load_exported(
        args.out, shard['images'].device.type).module()
    state = model.state_dict()
    got, launches = _call(program, args, shard, state)
    with torch.no_grad():
        eager = export_lib.make_serving_fn(cfg, model)(state, shard)
        heads = _flat(model(shard)[0])
    try:
        close(got, eager)
        differs = None
    except AssertionError as e:
        differs = str(e)
    mine = dict(out={k: v.cpu() for k, v in got.items()},
                heads=[t.cpu() for t in heads], launches=launches,
                program_gap=largest_gap(got, eager), program_differs=differs)
    gathered = [None] * mesh.world_size() if mesh.rank() == 0 else None
    dist.gather_object(mine, gathered, dst=0)
    found = [None]
    if mesh.rank() == 0:
        ref_model = build_model(dataclasses.replace(cfg, view_shard_axis=None),
                                device='cpu', seed=0)
        ref_model.load_state_dict(state)
        ref_model.to(batch['images'].device).eval()
        with torch.no_grad():
            want = export_lib.make_serving_fn(cfg, ref_model)(state, batch)
            want_heads = _flat(ref_model(batch)[0])
        want = {k: v.cpu() for k, v in want.items()}
        want_heads = [t.cpu() for t in want_heads]
        if sharding == 'view':
            outs = [g['out'] for g in gathered]
            heads = [g['heads'] for g in gathered]
        else:
            outs = [{k: torch.cat([g['out'][k] for g in gathered])
                     for k in want}]
            heads = [[torch.cat(ts) for ts in zip(*(g['heads']
                                                    for g in gathered))]]
        worst = max(head_gap(h, want_heads) for h in heads)
        errors = [f'rank {r}: the program against the eager sharded '
                  f'forward: {g["program_differs"]}'
                  for r, g in enumerate(gathered) if g['program_differs']]
        if worst > OUT_TOL:
            errors.append(f'head outputs {worst:.3g} of max-abs')
        found[0] = dict(launches=[g['launches'] for g in gathered],
                        detections=int(want['valid'].sum()),
                        program_gaps=[g['program_gap'] for g in gathered],
                        head_outputs_gap=worst, decode_differs=None)
        try:
            for out in outs:
                close(out, want)
        except AssertionError as e:
            found[0]['decode_differs'] = str(e)
            errors += [why for why in (same_detections(out, want)
                                       for out in outs) if why]
        found[0]['error'] = '; '.join(errors) or None
    dist.broadcast_object_list(found, src=0)
    if found[0]['error']:
        raise AssertionError(f'--verify {sharding}-sharded: '
                             f'{found[0]["error"]} (decode: '
                             f'{found[0]["decode_differs"]})')
    return found[0]


def main(argv=None):
    """Export (and verify); prints and returns the summary dict."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if sum([args.view_sharded, args.data_sharded, args.poly_batch]) > 1:
        parser.error('--view-sharded / --data-sharded / --poly-batch are '
                     'mutually exclusive (sharded programs need concrete '
                     'shapes and one sharding)')
    sharding = ('view' if args.view_sharded else
                'data' if args.data_sharded else None)
    if sharding and args.platforms:
        parser.error('a sharded program is traced for --device alone')
    preset = get_preset(args.preset)
    if args.override:
        preset = apply_overrides(preset, args.override)
    cfg = preset.model
    b = args.batch_size or (2 if args.poly_batch else 1)
    rank, world, device = 0, 1, torch.device(args.device)
    if sharding:
        rank, world, device = mesh.init_distributed(device.type)
        n = preset.data.n_images_test if sharding == 'view' else b
        if n % world:
            what = ('n_images_test' if sharding == 'view'
                    else '--batch-size')
            parser.error(f'{what}={n} must divide over {world} ranks')
    batch = serving_batch(preset.data.dataset, b, device, seed=0,
                          views=preset.data.n_images_test,
                          size=preset.data.test_size)
    model = build_model(dataclasses.replace(
        cfg, view_shard_axis='view' if sharding == 'view' else None),
        device='cpu', seed=0)
    path = args.checkpoint or args.torch_checkpoint
    if path:
        model.load_state_dict(ckpt_lib.load_reference_state_dict(path),
                              strict=True)
    model.to(device).eval()

    summary = dict(preset=args.preset, out=args.out, device=str(device),
                   devices=world, sharding=sharding,
                   weights='baked' if args.bake_weights else 'inputs')
    try:
        with compute_precision(cfg.compute_dtype):
            t0 = time.perf_counter()
            shard = batch
            if args.platforms:
                exported = export_lib.export_platforms(
                    cfg, model, batch, args.platforms.split(','),
                    args.bake_weights,
                    None if args.poly_batch else b)
                outputs = export_lib.output_shapes(
                    next(iter(exported.values())))
            else:
                if sharding:
                    exported, shard = export_lib.export_sharded(
                        cfg, model, batch, sharding, args.bake_weights)
                else:
                    exported = export_lib.export_serving(
                        cfg, model, batch, bake_variables=args.bake_weights,
                        batch_size=None if args.poly_batch else b)
                outputs = export_lib.output_shapes(exported)
                summary.update(inputs=input_shapes(exported),
                               collectives=collectives(exported))
            summary['export_s'] = time.perf_counter() - t0
            if rank == 0:
                summary['bytes'] = export_lib.save_exported(
                    exported, args.out, devices=world, sharding=sharding)
            if sharding:
                dist.barrier()
            summary.update(platforms=export_lib.load_meta(args.out)[
                'platforms'], outputs=outputs, verified=None)
            if args.verify:
                if sharding:
                    summary.update(verify_sharded(args, cfg, model, batch,
                                                  shard, sharding))
                elif args.platforms:
                    summary['per_platform'] = {
                        p: verify_one(args, cfg, model, {
                            k: v.to(p) for k, v in batch.items()}, p)
                        for p in summary['platforms']}
                else:
                    summary.update(verify_one(args, cfg, model, batch,
                                              device.type))
                summary['verified'] = True
    finally:
        if sharding:
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
