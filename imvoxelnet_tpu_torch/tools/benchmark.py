"""Throughput of a preset's serving forward, or its training step, on the
card.

    python -m imvoxelnet_tpu_torch.tools.benchmark [PRESET] [--batch-size 4]
        [--iters 10] [--warmup 2] [--dtype bfloat16] [--train]
        [--trace DIR] [--exact-nms] [--override PATH=VALUE]
    torchrun --nproc-per-node W -m imvoxelnet_tpu_torch.tools.benchmark \\
        imvoxelnet_scannet --batch-size 1 --view-sharded

Counterpart of the JAX package's ``tools/benchmark.py``.  The model (random
weights from a seed) and its synthetic batch come from
``tools/profile_forward.py:make_run``: forward + decode/NMS, or with
``--train`` the step of ``parallel/train.py`` on the preset's training
batch.  One batch is in flight, as in the JAX tool: each iteration queues
its work, copies its small output (the scores, or the step's loss) to
pinned host memory without waiting, records an event, and then waits on
the PREVIOUS iteration's event, so that the host queues batch N+1 while
the card runs batch N and every iteration still ends on work the card has
done.  The window closes on the last iteration's event.

``--trace DIR`` records the timed window with ``torch.profiler`` (CPU and
CUDA activities, ``with_stack`` and ``record_shapes``, one
``record_function('benchmark_iter')`` span an iteration) and writes
``DIR/benchmark_trace.json`` (``benchmark_trace.rank{R}.json`` under
several ranks), the input of ``tools/analyze_trace.py``; the window's time
then includes the profiler's own cost (``traced`` in the line), and the
line gives the profiler's own sum of the device time in the window
(``profiler_device_ms``: kernels, copies and memsets as ``key_averages``
totals them), which a digest of the written trace should equal.
``--exact-nms`` serves an indoor preset with ``pre_nms_k=0`` (the exact NMS
on B2's pairwise entry and the scan).  ``--view-sharded`` serves with the
view axis split over the ranks of torchrun's group
(``parallel/mesh.py``); without torchrun's environment it runs as one rank
of its own group, which measures the cost of the sharded composition.

The JAX flag ``--dump-hlo`` has no counterpart: it dumps XLA's HLO so that
``analyze_trace.py --hlo`` can name fusions that carry no source; every
kernel here is launched by an operator with a Python stack, which
``analyze_trace.py --by-source`` reads instead.

Prints one JSON line (rank 0): preset, mode, dtype, batch size, scenes/s,
ms per batch, the kernel launches per iteration, and the card's name and
power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from torch.autograd import DeviceType

from .. import kernels
from ..parallel import mesh
from . import microbench
from .profile_forward import make_run

SPAN = 'benchmark_iter'


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset', nargs='?', default='imvoxelnet_kitti')
    parser.add_argument('--batch-size', type=int, default=4)
    parser.add_argument('--iters', type=int, default=10)
    parser.add_argument('--warmup', type=int, default=2)
    parser.add_argument('--dtype', default='bfloat16',
                        choices=('float32', 'bfloat16'))
    parser.add_argument('--train', action='store_true',
                        help='benchmark the training step instead of the '
                             'forward')
    parser.add_argument('--trace', default=None,
                        help='directory for a torch.profiler chrome trace '
                             'of the timed window')
    parser.add_argument('--exact-nms', action='store_true',
                        help='indoor presets: pre_nms_k=0 (the exact NMS)')
    parser.add_argument('--view-sharded', action='store_true',
                        help="forward only: the view axis split over the "
                             "ranks of torchrun's group (one rank of its "
                             "own group without it)")
    parser.add_argument('--override', action='append', default=[],
                        metavar='PATH=VALUE',
                        help='preset field override, e.g. '
                             'model.indoor_head.score_thr=0.1 (repeatable)')
    return parser


def one_in_flight(run, small):
    """``step()``: one iteration of ``run`` with one batch in flight; its
    small output (``small(out)``) is copied to one of two pinned host
    buffers and an event recorded, then the previous iteration's event is
    waited on.  ``step.drain()`` waits for the last one."""
    state = {'slot': 0, 'pending': None, 'host': {}}

    def step():
        out = small(run())
        host = state['host'].get(state['slot'])
        if host is None or host.shape != out.shape:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            state['host'][state['slot']] = host
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        if state['pending'] is not None:
            state['pending'].synchronize()
        state['pending'] = event
        state['slot'] ^= 1

    def drain():
        state['pending'].synchronize()
    step.drain = drain
    return step


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    microbench.require_cuda('benchmark')
    overrides = list(args.override)
    if args.exact_nms:
        from ..configs.presets import get_preset
        if get_preset(args.preset).model.indoor_head is None:
            parser.error('--exact-nms requires an indoor-head preset')
        overrides.append('model.indoor_head.pre_nms_k=0')
    if args.view_sharded and args.train:
        parser.error('--view-sharded measures the forward only')
    world = 1
    if args.view_sharded:
        if 'RANK' not in os.environ:
            os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                              LOCAL_WORLD_SIZE='1', MASTER_ADDR='localhost',
                              MASTER_PORT=str(mesh.free_port()))
        _, world, _ = mesh.init_distributed('cuda')
    try:
        _, _, run = make_run(args.preset, args.train, args.batch_size,
                             args.dtype, overrides=overrides,
                             view_sharded=args.view_sharded)
        step = one_in_flight(run, (lambda loss: loss.detach().float())
                             if args.train else (lambda out: out['scores']))
        for _ in range(args.warmup + 1):
            step()
        step.drain()
        prof = None
        if args.trace:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                record_shapes=True, with_stack=True)
            prof.__enter__()
        kernels.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            if prof is not None:
                with torch.profiler.record_function(SPAN):
                    step()
            else:
                step()
        end.record()
        step.drain()
        ms = start.elapsed_time(end) / args.iters
        launches = {k: v / args.iters
                    for k, v in kernels.launch_counts().items()}
        trace = profiled_ms = None
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(args.trace, exist_ok=True)
            name = ('benchmark_trace.json' if world == 1 else
                    f'benchmark_trace.rank{mesh.rank()}.json')
            trace = os.path.join(args.trace, name)
            prof.export_chrome_trace(trace)
            profiled_ms = sum(
                ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and not ev.is_user_annotation) / 1e3
        result = dict(
            preset=args.preset, mode='train' if args.train else 'fwd',
            dtype=args.dtype, batch_size=args.batch_size, iters=args.iters,
            world=world, view_sharded=args.view_sharded,
            exact_nms=args.exact_nms,
            scenes_per_sec=args.batch_size * 1e3 / ms, ms_per_batch=ms,
            launches_per_iter=launches, traced=trace,
            profiler_device_ms=profiled_ms,
            card=microbench.card())
        if mesh.rank() == 0:
            print(json.dumps(result))
        return result
    finally:
        if args.view_sharded:
            torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
