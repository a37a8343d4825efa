"""Run one cell of the benchmark once, as the driver calls it:

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks for.
Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics), ``device``
(``--trace 1``: with ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and last ``checked``: each number the correctness check
compared, beside its limit.  The same numbers end standard error.

Exits non-zero, printing no result, where no card is visible or fewer
than the cell asks for, where the port is missing, or where a module of
JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ''):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness, spec  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def result_line(cell, record, traced: bool, device: dict):
    """The result object of a run's ``record``, and the lines of its
    check for standard error."""
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m['name'])(record)
        if value is not None:
            metrics[m['name']] = dict(value=value, unit=m['unit'])
    checked = {name: dict(value=record['numbers'][name],
                          limit=entry['limit'])
               for name, entry in cell.limits['numbers'].items()}
    correct = all(c['value'] <= c['limit'] for c in checked.values())
    out = dict(correct=correct, attempted=record['iterations'], failed=0,
               metrics=metrics, device=device)
    if traced:
        t = record['trace']
        out['device'] = dict(device, busy_s=t['busy_s'],
                             window_s=t['window_s'])
        top = sorted(t['kernels'].items(), key=lambda kv: -kv[1])[:10]
        out['breakdown'] = dict(device_ops=[[k[:120], v] for k, v in top],
                                idle_gaps=t['idle_gaps'])
    out['checked'] = checked
    lines = [f'check {name}: {c["value"]!r} (limit {c["limit"]!r})'
             for name, c in checked.items()]
    return out, lines


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.find_cell(args.workload, spec.load_benchmark())
    if not torch.cuda.is_available():
        print('portbench: no CUDA device; the benchmark measures the card',
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f'portbench: {args.workload} needs {cell.chips} cards, '
              f'{torch.cuda.device_count()} visible', file=sys.stderr)
        return 2
    record = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         'cuda', T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f'portbench: loaded after the window: {bad}', file=sys.stderr)
        return 3
    device = dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                  count=cell.chips, memory_peak_bytes=record['memory_peak'],
                  card=harness.card())
    out, lines = result_line(cell, record, bool(args.trace), device)
    print('set-up phases (s):', json.dumps(record['setup_phases']),
          file=sys.stderr)
    if 'trace' in record:
        print('host calls waiting for the device in the traced window:',
              json.dumps(record['trace']['sync_calls']), file=sys.stderr)
    print('\n'.join(lines), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
