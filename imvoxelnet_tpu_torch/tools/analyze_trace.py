"""Per-kernel device time from a ``torch.profiler`` chrome trace.

    python -m imvoxelnet_tpu_torch.tools.analyze_trace TRACE [--top 30]
        [--min-ms 0] [--bucket NAME=REGEX] [--steps N] [--span NAME]
        [--by-source [--by-line] [--repo-source]]

Counterpart of the JAX package's ``tools/analyze_trace.py``.
``tools/benchmark.py --trace DIR`` writes ``DIR/benchmark_trace.json``;
``TRACE`` is such a file (``.json`` or ``.json.gz``) or a directory, whose
newest trace is read.  The device lanes are the events of the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the table sums their time by
kernel name, sorted, with ``--bucket NAME=REGEX`` merging the rows whose
name matches (repeatable, the first match wins).  ``--steps N`` divides the
totals by N; where the trace holds ``--span`` spans (the benchmark's
``record_function`` per iteration), it also gives their host ms and the
device ms of the kernels launched inside them, per span.  :func:`window`
reads a run of such spans as one window: the host calls in it that wait for
the device, the device-to-host copies and the card's busy share.

``--by-source`` groups by the code that asked for each kernel instead: a
device event's ``args.correlation`` names the runtime call that launched it
(``cuda_runtime`` / ``cuda_driver``), and the ``python_function`` frames
(``with_stack=True``) around that call on its thread give the Python stack.
The kernel is billed to the innermost frame that belongs neither to
PyTorch nor to the port's wrapper layers (``imvoxelnet_tpu_torch/kernels``,
``imvoxelnet_tpu_torch/ops``): the model code that ran it, e.g. B3's
kernel to ``models/necks3d.py``.  ``--repo-source`` takes the first such
frame under the repository (``--root``, by default this checkout), skipping
every other library too.  Files are named relative to the repository;
``--by-line`` keeps the line numbers.  A kernel of the backward pass, whose
launch has no such frame (the autograd engine's thread runs C++), is
billed to the code of the forward operator it differentiates, found by the
``Sequence number`` the profiler gives both, with ``(backward)`` after it.

The JAX flag ``--hlo`` names XLA fusions that carry no source from a dumped
HLO module; it has no counterpart, since every eager kernel here has a
launching operator with a Python stack, which ``--by-source`` reads.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
# host calls that wait for the device (cudaFree and cudaFreeHost
# synchronize it too)
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'cudaMemcpy', 'cudaMemcpy2D',
              'cuStreamSynchronize', 'cuCtxSynchronize', 'cuEventSynchronize',
              'cuMemcpyDtoH_v2', 'cudaFree', 'cudaFreeHost')
SPAN = 'benchmark_iter'
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# frames of the port's wrapper layers: the caller above them is billed
WRAPPERS = ('imvoxelnet_tpu_torch/kernels/', 'imvoxelnet_tpu_torch/ops/')
_FRAME = re.compile(r'^(.*\.py)\((\d+)\): ')


def trace_path(path: str) -> str:
    """``path`` or the newest ``*.json`` / ``*.json.gz`` under it."""
    if not os.path.isdir(path):
        return path
    files = [f for p in ('*.json', '*.json.gz', '*/*.json', '*/*.json.gz')
             for f in glob.glob(os.path.join(path, p))]
    if not files:
        raise SystemExit(f'no *.json or *.json.gz trace under {path}')
    return max(files, key=os.path.getmtime)


def load_events(path: str):
    path = trace_path(path)
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        return json.load(f)['traceEvents']


def device_events(events):
    """The events of the device lanes (``DEVICE_CATS``)."""
    return [e for e in events if e.get('ph') == 'X'
            and e.get('cat') in DEVICE_CATS]


def launch_map(events):
    """``{correlation: event}`` of the runtime calls that launch device
    work (``LAUNCH_CATS``)."""
    return {e['args']['correlation']: e for e in events
            if e.get('ph') == 'X' and e.get('cat') in LAUNCH_CATS
            and 'correlation' in e.get('args', {})}


def spans(events, name=SPAN):
    """The ``record_function`` spans named ``name``, by start."""
    return sorted((e for e in events if e.get('ph') == 'X'
                   and e.get('cat') == 'user_annotation'
                   and e.get('name') == name), key=lambda e: e['ts'])


def window(events, span, n_spans):
    """The ``n_spans`` spans named ``span`` as one window: the host window
    from the first span's start to the last one's end; the device window
    from the first to the last end of the kernels launched in it; the host
    calls in the host window that wait for the device (``SYNC_CALLS``); the
    device-to-host copies in the device window; and the card's busy share
    of the device window (the union of every kernel's interval in it)."""
    found = spans(events, span)
    if len(found) != n_spans:
        raise AssertionError(f'trace: {len(found)} {span} spans, not '
                             f'{n_spans}')
    h0, h1 = found[0]['ts'], found[-1]['ts'] + found[-1]['dur']
    calls = [e for e in events if e.get('ph') == 'X'
             and e.get('cat') in LAUNCH_CATS and h0 <= e['ts'] <= h1]
    launches = launch_map(events)
    device = device_events(events)
    kernel = [e for e in device if e['cat'] == 'kernel']
    launched = [e for e in kernel if h0 <= launches.get(
        e.get('args', {}).get('correlation'), {}).get('ts', -1) <= h1]
    if not launched:
        raise AssertionError(f'trace: no kernel launched in the {span} '
                             f'spans')
    d0 = min(e['ts'] for e in launched)
    d1 = max(e['ts'] + e['dur'] for e in launched)
    syncs = sorted({e['name'] for e in calls if e['name'] in SYNC_CALLS})
    dtoh = [e for e in device if e['cat'] == 'gpu_memcpy'
            and 'DtoH' in e['name'] and e['ts'] < d1
            and e['ts'] + e['dur'] > d0]
    union, end = 0.0, d0
    for a, b in sorted((max(e['ts'], d0), min(e['ts'] + e['dur'], d1))
                       for e in kernel if e['ts'] < d1
                       and e['ts'] + e['dur'] > d0):
        if b > end:
            union += b - max(a, end)
            end = b
    return dict(steps=n_spans, host_window_ms=(h1 - h0) / 1e3,
                device_window_ms=(d1 - d0) / 1e3, kernels=len(launched),
                runtime_calls=len(calls), sync_calls=syncs,
                device_to_host_copies=len(dtoh),
                busy_share=union / (d1 - d0))


def _is_torch(path: str) -> bool:
    return '/torch/' in path or path.startswith('torch/')


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


def _frame(e):
    """``(path, line)`` of a ``python_function`` event naming a file."""
    m = _FRAME.match(e.get('name', ''))
    return (m.group(1), int(m.group(2))) if m else None


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


def launch_sources(events, launches, root, repo_only):
    """``{correlation: (file, line, backward)}`` of the runtime calls: the
    frame :func:`source_of` picks from the call's Python stack; for a call
    with none there (the autograd engine's thread runs C++ or only wrapper
    frames), the innermost backward operator around it gives the sequence
    number of the forward operator it differentiates, whose stack is read
    instead, and ``backward`` is set."""
    frames = _intervals(events, 'python_function', _frame)
    ops = _intervals(events, 'cpu_op', lambda e: e)
    calls = [(corr, e['pid'], e['tid'], e['ts'])
             for corr, e in launches.items()]
    stacks, op_stacks = enclosing(frames, calls), enclosing(ops, calls)
    # the forward operators by sequence number (a backward operator names
    # its forward's thread by a nonzero 'Fwd thread id')
    forward = {}
    for group in ops.values():
        for _, _, e in group:
            args = e.get('args', {})
            if 'Sequence number' in args and not args.get('Fwd thread id'):
                forward.setdefault(args['Sequence number'], e)
    out, pending = {}, {}
    for corr in launches:
        src = source_of(stacks.get(corr, []), root, repo_only)
        if src is not None:
            out[corr] = src + (False,)
            continue
        for op in op_stacks.get(corr, []):
            args = op.get('args', {})
            fwd = forward.get(args.get('Sequence number'))
            if args.get('Fwd thread id') and fwd is not None:
                pending[corr] = (corr, fwd['pid'], fwd['tid'], fwd['ts'])
                break
    for corr, stack in enclosing(frames, pending.values()).items():
        src = source_of(stack, root, repo_only)
        if src is not None:
            out[corr] = src + (True,)
    return out


def in_repo(path: str, root: str):
    """Whether a frame's file is under ``root``, and its name relative to
    it.  The profiler names a file relative to the ``sys.path`` entry it
    was found under, so a relative name is the repository's if the file is
    there."""
    root = root.rstrip('/')
    if os.path.isabs(path):
        if path.startswith(root + '/'):
            return True, path[len(root) + 1:]
        return False, path
    return os.path.exists(os.path.join(root, path)), path


def source_of(stack, root: str, repo_only: bool):
    """The frame a kernel is billed to: the innermost ``(path, line)`` of
    ``stack`` outside PyTorch and the port's wrapper layers (``repo_only``:
    the innermost under ``root``), the path relative to ``root``; ``None``
    if there is none."""
    for path, line in stack:
        if _is_torch(path) or any(w in path for w in WRAPPERS):
            continue
        ours, name = in_repo(path, root)
        if repo_only and not ours:
            continue
        return name, line
    return None


def digest(events, by_source=False, by_line=False, repo_source=False,
           buckets=(), root=ROOT, span=SPAN):
    """The device time of a trace: ``rows`` (name or source -> [ms,
    calls]), ``device_ms`` (all device events), ``kernel_ms`` (the
    ``kernel`` category alone), with ``by_source`` also ``sources`` (each
    kernel name -> the sorted names of the sources it was billed to) and,
    where the trace holds ``span`` spans, ``spans`` (their count, host ms
    and the device ms of the kernels launched inside them)."""
    device = device_events(events)
    launches = launch_map(events)
    sources = (launch_sources(events, launches, root, repo_source)
               if by_source else {})
    rows, billed = collections.OrderedDict(), collections.defaultdict(set)
    for e in device:
        name = kernel = e.get('name', '?')
        if by_source:
            src = sources.get(e.get('args', {}).get('correlation'))
            if src is None:
                name = f'(no source: {name})'
            else:
                name = (f'{src[0]}:{src[1]}' if by_line else src[0]) + (
                    ' (backward)' if src[2] else '')
            billed[kernel].add(name)
        for bname, rx in buckets:
            if re.search(rx, name):
                name = bname
                break
        row = rows.setdefault(name, [0.0, 0])
        row[0] += e.get('dur', 0) / 1e3
        row[1] += 1
    out = dict(rows=rows, device_ms=sum(r[0] for r in rows.values()),
               kernel_ms=sum(e.get('dur', 0) for e in device
                             if e['cat'] == 'kernel') / 1e3,
               device_events=len(device))
    if by_source:
        out['sources'] = {k: sorted(v) for k, v in billed.items()}
    found = spans(events, span)
    if found:
        inside = 0.0
        for e in device:
            call = launches.get(e.get('args', {}).get('correlation'))
            if call is not None and any(
                    s['ts'] <= call['ts'] <= s['ts'] + s['dur']
                    for s in found):
                inside += e.get('dur', 0) / 1e3
        out['spans'] = dict(count=len(found),
                            host_ms=sum(s['dur'] for s in found) / 1e3
                            / len(found),
                            device_ms=inside / len(found))
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('trace')
    parser.add_argument('--top', type=int, default=30)
    parser.add_argument('--steps', type=int, default=None,
                        help='divide totals by N steps for per-step ms')
    parser.add_argument('--span', default=SPAN,
                        help='name of the record_function span of one step')
    parser.add_argument('--min-ms', type=float, default=0.0)
    parser.add_argument('--bucket', action='append', default=[],
                        help='NAME=REGEX: merge matching rows into NAME '
                             '(repeatable, first match wins)')
    parser.add_argument('--by-source', action='store_true',
                        help='group by the launching Python code instead '
                             'of the kernel name')
    parser.add_argument('--by-line', action='store_true',
                        help='with --by-source, keep line numbers')
    parser.add_argument('--repo-source', action='store_true',
                        help='with --by-source, bill to the first frame '
                             'under the repository')
    parser.add_argument('--root', default=ROOT,
                        help='the repository whose frames --repo-source '
                             'takes (default: this checkout)')
    return parser.parse_args(argv)


def main(argv=None):
    """Print the table; returns :func:`digest`'s dict with the rows as
    printed (``table``: name, ms or ms/step, calls, share)."""
    args = parse_args(argv)
    buckets = [b.split('=', 1) for b in args.bucket]
    out = digest(load_events(args.trace), args.by_source, args.by_line,
                 args.repo_source, buckets, args.root, args.span)
    div = args.steps or 1
    unit = 'ms/step' if args.steps else 'ms total'
    total = out['device_ms']
    print(f'device-lane events: {out["device_events"]}, lane total '
          f'{total / div:.3f} {unit} (kernels {out["kernel_ms"] / div:.3f})')
    if 'spans' in out:
        s = out['spans']
        print(f'{s["count"]} {args.span} spans: host {s["host_ms"]:.3f} ms, '
              f'device {s["device_ms"]:.3f} ms a span')
    print(f'{"op":<64} {unit:>12} {"calls":>7} {"%":>6}')
    table, shown = [], 0
    ranked = sorted(out['rows'].items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in ranked:
        # --min-ms extends the listing past --top: rows at or above it
        # keep printing (with the default 0 the table stops at --top)
        if shown >= args.top and not (args.min_ms > 0
                                      and ms / div >= args.min_ms):
            break
        share = ms / total if total else 0.0
        print(f'{name[:64]:<64} {ms / div:12.3f} {calls:7d} '
              f'{100 * share:6.1f}')
        table.append(dict(name=name, ms=ms / div, calls=calls, share=share))
        shown += 1
    rest = total - sum(r[0] for _, r in ranked[:shown])
    print(f'{"(rest)":<64} {rest / div:12.3f}')
    out['table'] = table
    return out


if __name__ == '__main__':
    main()
