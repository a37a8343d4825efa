"""Device time of a traced window, from a ``torch.profiler`` chrome trace.

A frozen copy of the arithmetic of the port's
``tools/analyze_trace.py``, so that a change to the program cannot move
the yardstick:

* the device lanes are the events of the categories ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset``; a device event's ``args.correlation``
  names the runtime call (``cuda_runtime`` / ``cuda_driver``) that
  launched it;
* the busy time is the union of the lanes' intervals inside the window;
* a launch is billed to the innermost layer span around it on its host
  thread.  The layer spans are ``record_function`` spans the benchmark
  opens around the calls into each layer (``layer.<name>``), so no Python
  stack is needed.  A launch with no such span (the autograd engine's
  thread) is billed through the innermost backward operator around it:
  its ``Sequence number`` names the forward operator it differentiates,
  and the layer span around that operator takes the kernel.  So every
  layer's time in a training step includes its backward.
"""

from __future__ import annotations

import collections
import json

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
# host calls that wait for the device
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy', 'cudaMemcpy2D',
              'cuStreamSynchronize', 'cuCtxSynchronize', 'cuEventSynchronize',
              'cuMemcpyDtoH_v2', 'cudaFree', 'cudaFreeHost')
LAYER = 'layer.'
ITER = 'portbench.iter'


def load_events(path: str):
    with open(path) as f:
        return json.load(f)['traceEvents']


def _x(events, cats):
    return [e for e in events if e.get('ph') == 'X' and e.get('cat') in cats]


def _intervals(events, cat, payload):
    """Per host thread, the ``cat`` events as ``(start, end, payload(e))``
    sorted by start (outer first), those whose payload is not ``None``."""
    out = collections.defaultdict(list)
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == cat:
            value = payload(e)
            if value is not None:
                out[(e['pid'], e['tid'])].append(
                    (e['ts'], e['ts'] + e.get('dur', 0), value))
    for spans in out.values():
        spans.sort(key=lambda f: (f[0], -f[1]))
    return out


def enclosing(intervals, points):
    """``{key: [payload, ...]}``: for each ``(key, pid, tid, ts)`` of
    ``points`` the payloads of its thread's intervals that enclose ``ts``,
    innermost first (one sweep a thread; a thread's intervals nest)."""
    by_thread = collections.defaultdict(list)
    for key, pid, tid, ts in points:
        by_thread[(pid, tid)].append((ts, key))
    out = {}
    for thread, group in by_thread.items():
        todo, i, open_ = intervals.get(thread, []), 0, []
        for ts, key in sorted(group, key=lambda p: p[0]):
            while i < len(todo) and todo[i][0] <= ts:
                while open_ and open_[-1][1] < todo[i][0]:
                    open_.pop()
                open_.append(todo[i])
                i += 1
            while open_ and open_[-1][1] < ts:
                open_.pop()
            out[key] = [span[2] for span in reversed(open_)]
    return out


def _layer(e):
    name = e.get('name', '')
    return name[len(LAYER):] if name.startswith(LAYER) else None


def launch_layers(events, launches):
    """``{correlation: layer}`` for the runtime calls inside a layer span,
    directly or through the forward operator of a backward operator."""
    layers = _intervals(events, 'user_annotation', _layer)
    ops = _intervals(events, 'cpu_op', lambda e: e)
    calls = [(corr, e['pid'], e['tid'], e['ts'])
             for corr, e in launches.items()]
    direct, op_stacks = enclosing(layers, calls), enclosing(ops, calls)
    forward = {}
    for group in ops.values():
        for _, _, e in group:
            args = e.get('args', {})
            if 'Sequence number' in args and not args.get('Fwd thread id'):
                forward.setdefault(args['Sequence number'], e)
    out, pending = {}, {}
    for corr in launches:
        found = direct.get(corr)
        if found:
            out[corr] = found[0]
            continue
        for op in op_stacks.get(corr, []):
            args = op.get('args', {})
            fwd = forward.get(args.get('Sequence number'))
            if args.get('Fwd thread id') and fwd is not None:
                pending[corr] = (corr, fwd['pid'], fwd['tid'], fwd['ts'])
                break
    for corr, found in enclosing(layers, pending.values()).items():
        if found:
            out[corr] = found[0]
    return out


def union_length(intervals):
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float('-inf')
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def digest(events, n_gaps: int = 10):
    """What the readers need from a trace whose window is the
    ``portbench.iter`` spans: the window (first span's start to the end of
    the last device event launched in a span), the busy time inside it,
    the device time by layer and by kernel name, and the longest idle gaps
    named by what the host was doing, and the host calls in the window
    that wait for the device.  Times in seconds."""
    iters = sorted((e for e in _x(events, ('user_annotation',))
                    if e.get('name') == ITER), key=lambda e: e['ts'])
    if not iters:
        raise ValueError(f'trace: no {ITER} spans')
    h0, h1 = iters[0]['ts'], iters[-1]['ts'] + iters[-1]['dur']
    launches = {e['args']['correlation']: e
                for e in _x(events, LAUNCH_CATS)
                if 'correlation' in e.get('args', {})}
    device = _x(events, DEVICE_CATS)
    inside = [e for e in device if h0 <= launches.get(
        e.get('args', {}).get('correlation'), {}).get('ts', -1) <= h1]
    w1 = max([h1] + [e['ts'] + e['dur'] for e in inside])
    lanes = [(max(e['ts'], h0), min(e['ts'] + e['dur'], w1)) for e in device
             if e['ts'] < w1 and e['ts'] + e['dur'] > h0]
    billed = launch_layers(events, launches)
    by_layer, by_kernel = collections.Counter(), collections.Counter()
    for e in inside:
        layer = billed.get(e['args']['correlation'], 'other')
        by_layer[layer] += e['dur'] / 1e6
        by_kernel[e.get('name', '?')] += e['dur'] / 1e6
    syncs = collections.Counter(
        e['name'] for e in _x(events, LAUNCH_CATS)
        if e['name'] in SYNC_CALLS and h0 <= e['ts'] <= h1)
    return dict(iterations=len(iters), window_s=(w1 - h0) / 1e6,
                sync_calls=dict(syncs),
                busy_s=union_length(lanes) / 1e6, layers=dict(by_layer),
                kernels=dict(by_kernel),
                idle_gaps=idle_gaps(events, lanes, h0, w1, n_gaps))


def idle_gaps(events, lanes, t0, t1, n):
    """The ``n`` longest stretches of ``[t0, t1]`` with no device event,
    each named by the innermost span or operator on the host's main thread
    (the one that opened the iteration spans) at the gap's start."""
    gaps, end = [], t0
    for a, b in sorted(lanes):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    main = next((e['pid'], e['tid']) for e in events
                if e.get('name') == ITER and e.get('ph') == 'X')
    host = _intervals(events, 'user_annotation', lambda e: e['name'])
    ops = _intervals(events, 'cpu_op', lambda e: e['name'])
    points = [(i, main[0], main[1], a) for i, (a, _) in enumerate(gaps)]
    spans, calls = enclosing(host, points), enclosing(ops, points)
    out = []
    for i, (a, b) in enumerate(gaps):
        span = next((s for s in spans.get(i, []) if s != ITER), 'iteration')
        op = (calls.get(i) or ['python'])[0]
        out.append([f'{span} / {op}', (b - a) / 1e6])
    return out
