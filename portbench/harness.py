"""One run of one cell: set-up, the measured window, the check.

Set-up builds the kernels' libraries (nvcc on a checkout's first run,
loaded after), makes the weights and the traffic pool on the device from
the seed, builds the port's model and warms up the cell's own shapes; a
training cell also drives its step object through the three first steps
that the check compares.  ``setup_s`` runs from the process's start to the
first timed iteration.

The window is a closed loop with two iterations outstanding: the host
enqueues iteration N+1, then waits for iteration N's results to reach
pinned host memory (a serving batch's detections, a step's loss).  An
iteration's latency runs from the moment the host began to enqueue it to
the moment the host saw its results.  The window runs ``--seconds`` from
the first enqueue, then drains; its length ends at the last result.  With
``--trace 1`` the window is the traffic mix's ``trace_iters`` iterations
under ``torch.profiler``, with the layer spans of ``program.py`` opened
from forward hooks (``trace.py`` bills the device time to them).

After the window closes and the peak memory is read, the reference checks
a sample of what the window produced (``check.py``), against the limits of
``limits/<workload>.json``.  The reference is the configuration's
(``spec.reference``): its model gives the weights' names and scheme, the
FLOP and B3 counts and the readings the check compares.
"""

from __future__ import annotations

import collections
import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import check, flops, rooflines, spec, trace, weights
from . import traffic as traffic_lib

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'imvoxelnet_tpu')


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``imvoxelnet_tpu_torch`` is not ``imvoxelnet_tpu``)."""
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


class Device:
    """Events, waits and host copies on the card; the same calls run
    synchronously on the CPU (the tests' tiny runs)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'

    def event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def wait(event):
        if event is not None:
            event.synchronize()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def to_host(self, tensors: dict, slots: dict, slot: int) -> dict:
        """Copy ``tensors`` into the pinned buffers of ``slot``, without
        waiting."""
        bufs = slots.get(slot)
        if bufs is None:
            bufs = {k: torch.empty(v.shape, dtype=v.dtype,
                                   pin_memory=self.cuda)
                    for k, v in tensors.items()}
            slots[slot] = bufs
        for k, v in tensors.items():
            bufs[k].copy_(v, non_blocking=True)
        return bufs

    def peak(self):
        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def empty_cache(self):
        if self.cuda:
            torch.cuda.empty_cache()

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()


def closed_loop(dev, launch, n_pool, outstanding, seconds=None, iters=None,
                keep=(), span=None):
    """Run ``launch(i) -> (host tensors to fetch, kept outputs)`` with
    ``outstanding`` iterations in flight, for ``seconds`` (then drain) or
    ``iters`` iterations.  Returns the window's start and end (host
    clock), each iteration's latency and the kept outputs of the
    iterations in ``keep`` and of the last one, by iteration."""
    pending = collections.deque()
    slots, latencies, kept = {}, [], {}
    t0 = end = time.perf_counter()
    i, stop = 0, False
    while True:
        ts = time.perf_counter()
        with span() if span else contextlib.nullcontext():
            fetch, outputs = launch(i)
            host = dev.to_host(fetch, slots, i % (outstanding + 1))
            pending.append((i, ts, dev.event(), host, outputs))
            i += 1
            stop = stop or (iters is not None and i >= iters)
            while pending and (len(pending) >= outstanding or stop):
                j, tj, ev, hj, oj = pending.popleft()
                dev.wait(ev)
                end = time.perf_counter()
                latencies.append(end - tj)
                if j in keep or (stop and not pending):
                    kept[j] = dict(outputs=oj, host={k: v.clone()
                                                    for k, v in hj.items()})
                if seconds is not None and end - t0 >= seconds:
                    stop = True
        if stop and not pending:
            break
    return dict(t0=t0, t1=end, latencies=latencies, iterations=i, kept=kept)


class Spans:
    """``record_function`` spans opened by forward hooks around modules
    and by wrappers around functions, for the traced window only."""

    def __init__(self):
        self.handles, self.saved = [], []

    def modules(self, model, pairs):
        for name, attr in pairs:
            mod = getattr(model, attr)
            opened = []

            def pre(*_, _name=name, _opened=opened):
                rf = torch.profiler.record_function(trace.LAYER + _name)
                rf.__enter__()
                _opened.append(rf)

            def post(*_, _opened=opened):
                _opened.pop().__exit__(None, None, None)
            self.handles.append(mod.register_forward_pre_hook(pre))
            self.handles.append(mod.register_forward_hook(post))

    def function(self, owner, attr, name):
        fn = getattr(owner, attr)

        def wrapped(*a, **k):
            with torch.profiler.record_function(trace.LAYER + name):
                return fn(*a, **k)
        self.saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)

    def optimizer(self, optimizer, name):
        opened = []

        def pre(*_):
            rf = torch.profiler.record_function(trace.LAYER + name)
            rf.__enter__()
            opened.append(rf)

        def post(*_):
            opened.pop().__exit__(None, None, None)
        self.handles.append(optimizer.register_step_pre_hook(pre))
        self.handles.append(optimizer.register_step_post_hook(post))

    def close(self):
        for h in self.handles:
            h.remove()
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def card():
    """``name, power.limit`` of the card, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def sample(seed: int, n: int, k: int):
    """``k`` iteration indices below ``n``, drawn from the seed."""
    rng = traffic_lib.rng_for(seed, 4)
    return set(int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def run(cell, seed: int, seconds: float, traced: bool, device='cuda',
        t_start=None):
    """One run of ``cell``; returns the record the result line is made
    from (``metrics`` still to be read by the cell's readers)."""
    from . import program

    t_start = time.perf_counter() if t_start is None else t_start
    dev = Device(device)
    cfg_file, mix = cell.config, cell.traffic
    serve = mix['mode'] == 'serve'
    ref = spec.reference(cfg_file)
    ref_cfg = ref.config_from_dict(cfg_file['model'])
    marks = [('start', t_start), ('imports', time.perf_counter())]
    program.build_kernels(device)
    dev.sync()
    marks.append(('kernels', time.perf_counter()))
    state = weights.make_state_dict(ref, ref_cfg, seed, device, serve)
    pool = traffic_lib.make_pool(cfg_file, mix, seed, device)
    model = program.build_model(cfg_file, state, device)
    dev.sync()
    marks.append(('weights_pool_model', time.perf_counter()))
    n_pool, b = len(pool), mix['batch']
    window_iters = mix['trace_iters'] if traced else None
    keep = sample(seed, mix['trace_iters'], mix['check_iters'])
    record = dict(iterations_checked=None, kernel_names=dict(
        b1=program.B1_FORWARD, b1_grad=program.B1_BACKWARD, b3=program.B3))

    if serve:
        call = program.serve_call(model)

        def launch(i):
            batch = pool[i % n_pool]
            dets, head_outs, valid = call(batch)
            return dets, (batch, head_outs, valid)
    else:
        step, optimizer = program.train_step(model, cfg_file)
        names = {p: n for n, p in model.named_parameters()}
        # the first steps, which the check follows, go through the
        # window's own step object and pool; the window continues after
        # them
        offset = mix['check_steps']
        losses, grads = [], None
        outputs, remove = check.first_forward(model)
        for i in range(offset):
            metrics = step(pool[i % n_pool])
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                grads = check.norms(check.first_gradients(optimizer, names))
        changes = check.change_norms(check.moving(state),
                                     check.moving(model.state_dict()))
        remove()
        record['program_steps'] = dict(losses=losses, grads=grads,
                                       changes=changes, head_outs=outputs[0])

        def launch(i):
            metrics = step(pool[(i + offset) % n_pool])
            return dict(loss=metrics['loss'].float().reshape(1)), None

    dev.sync()
    marks.append(('first_steps', time.perf_counter()))
    closed_loop(dev, launch, n_pool, mix['outstanding'],
                iters=mix['warmup'])
    dev.sync()
    marks.append(('warmup', time.perf_counter()))

    spans = prof = None
    if traced:
        spans = Spans()
        spans.modules(model, program.SERVE_MODULES if serve
                      else program.TRAIN_MODULES)
        if serve:
            spans.function(program.detector, 'imvoxelnet_predict',
                           'head_decode')
        else:
            spans.function(*program.LOSS_CALL, 'targets_loss')
            spans.optimizer(optimizer, 'optimizer')
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    setup_peak = dev.peak()
    dev.reset_peak()
    t_window = time.perf_counter()
    out = closed_loop(
        dev, launch, n_pool, mix['outstanding'],
        seconds=None if traced else seconds, iters=window_iters,
        keep=keep if serve else (),
        span=(lambda: torch.profiler.record_function(trace.ITER))
        if traced else None)
    window_peak = dev.peak()
    record.update(
        setup_s=t_window - t_start,
        setup_phases={name: t1 - t0 for (_, t0), (name, t1)
                      in zip(marks, marks[1:])},
        window_s=out['t1'] - out['t0'],
        latencies=out['latencies'], iterations=out['iterations'],
        batch=b, mode=mix['mode'], window_peak=window_peak,
        memory_peak=max(setup_peak, window_peak))
    if traced:
        prof.__exit__(None, None, None)
        spans.close()
        trace_dir = tempfile.mkdtemp(prefix='portbench-trace-')
        try:
            path = os.path.join(trace_dir, 'trace.json')
            prof.export_chrome_trace(path)
            record['trace'] = trace.digest(trace.load_events(path))
        finally:
            shutil.rmtree(trace_dir, ignore_errors=True)
        shift = 0 if serve else mix['check_steps']
        batches = [pool[(i + shift) % n_pool] for i in range(window_iters)]
        record['flops_per_iter'] = flops.counted(ref, ref_cfg, pool[0],
                                                 not serve)
        record['b1_bytes_per_iter'] = float(np.mean(
            [rooflines.b1_bytes(ref_cfg, bt, not serve) for bt in batches]))
        record['b3_flops_per_iter'] = rooflines.b3_flops(ref, ref_cfg,
                                                         pool[0], not serve)

    # the check, after the window and the peak memory
    if serve:
        kept = [dict(batch=o['outputs'][0], head_outs=o['outputs'][1],
                     valid=o['outputs'][2], dets=o['host'])
                for _, o in sorted(out['kept'].items())]
        record['iterations_checked'] = sorted(out['kept'])
        del out, model, launch, call
        dev.empty_cache()
        numbers = check.serve_numbers(
            ref, ref_cfg, check.reference_model(ref, ref_cfg, state, device),
            check.reference_model(ref, ref_cfg, state, device, 'bfloat16'),
            kept)
    else:
        batches = [pool[i % n_pool] for i in range(mix['check_steps'])]
        del out, model, launch, step, optimizer
        dev.empty_cache()
        want = check.reference_steps(ref, ref_cfg, cfg_file, state, batches,
                                     device)
        want16 = check.reference_steps(ref, ref_cfg, cfg_file, state,
                                       batches, device, 'bfloat16')
        record['detail'] = {}
        numbers = check.train_numbers(record['program_steps'], want, want16,
                                      record['detail'])
        record['iterations_checked'] = list(range(mix['check_steps']))
    record['numbers'] = numbers
    return record
