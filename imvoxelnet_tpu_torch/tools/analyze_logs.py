"""Summarize or plot the loss curves of a training log.

    python -m imvoxelnet_tpu_torch.tools.analyze_logs WORK_DIR/train_log.jsonl
        [--keys loss loss_cls] [--plot curves.png]

Counterpart of the JAX package's ``tools/analyze_logs.py``: reads the
jsonl log that ``tools/train.py`` writes (one JSON object a line) and
prints, for each key, its first, last, smallest and largest value and how
many lines hold it.  ``--plot`` draws the keys against ``step`` into a PNG
with matplotlib, and raises where matplotlib is missing.
"""

from __future__ import annotations

import argparse
import json


def read_log(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summary(records, keys):
    """``{key: dict(first, last, min, max, n)}`` of the keys the log holds
    (printed as the JAX tool prints them)."""
    out = {}
    for key in keys:
        vals = [r[key] for r in records if key in r]
        if not vals:
            continue
        out[key] = dict(first=vals[0], last=vals[-1], min=min(vals),
                        max=max(vals), n=len(vals))
        print(f'{key}: first={vals[0]:.4f} last={vals[-1]:.4f} '
              f'min={min(vals):.4f} max={max(vals):.4f} n={len(vals)}')
    return out


def plot(records, keys, path: str):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    steps = [r.get('step', i) for i, r in enumerate(records)]
    for key in keys:
        plt.plot(steps, [r.get(key) for r in records], label=key)
    plt.xlabel('step')
    plt.legend()
    plt.savefig(path, dpi=120)
    print(f'saved {path}')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('log', help="train_log.jsonl from tools/train.py")
    parser.add_argument('--keys', nargs='+', default=['loss'])
    parser.add_argument('--plot', default=None, help='output png path')
    args = parser.parse_args(argv)
    records = read_log(args.log)
    if not records:
        print('empty log')
        return {}
    out = summary(records, args.keys)
    if args.plot:
        plot(records, args.keys, args.plot)
    return out


if __name__ == '__main__':
    main()
