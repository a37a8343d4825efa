"""The readings the check's limits are set from, on the card, at the cell's
own sizes, in one process (the kernels build once):

    python3 -m portbench.calibrate --workload NAME --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--seconds 2] \\
        [--out FILE]

For each of ``--seeds`` a whole run of the cell (a short window) gives the
program's numbers, the lower readings.  For each of ``--control-seeds``
the control (the reference with its convolution operands rounded below
bfloat16 in the program's place: ``check.py``) gives the upper readings; for each of ``--fault-seeds``
each fault of ``faults.py`` the cell can have, planted in the program,
gives its numbers.  One JSON object goes to ``--out`` (and stdout).  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, faults, harness, spec, weights
from portbench import traffic as traffic_lib


def control_numbers(cell, seed, device):
    """The control's numbers for ``seed``: the same weights, batches and
    sample as a run of the cell."""
    cfg_file, mix = cell.config, cell.traffic
    serve = mix['mode'] == 'serve'
    ref = spec.reference(cfg_file)
    ref_cfg = ref.config_from_dict(cfg_file['model'])
    state = weights.make_state_dict(ref, ref_cfg, seed, device, serve)
    pool = traffic_lib.make_pool(cfg_file, mix, seed, device)
    if serve:
        keep = sorted(harness.sample(seed, mix['trace_iters'],
                                     mix['check_iters']))
        batches = [pool[i % len(pool)] for i in keep]
        control = check.reference_model(ref, ref_cfg, state, device,
                                        'bfloat16')
        items = check.control_serve_items(ref, ref_cfg, control, batches)
        del control
        return check.serve_numbers(
            ref, ref_cfg, check.reference_model(ref, ref_cfg, state, device),
            check.reference_model(ref, ref_cfg, state, device, 'bfloat16'),
            items)
    batches = [pool[i % len(pool)] for i in range(mix['check_steps'])]
    got = check.reference_steps(ref, ref_cfg, cfg_file, state, batches,
                                device, 'bfloat16', rounding=check.int8_round)
    want = check.reference_steps(ref, ref_cfg, cfg_file, state, batches,
                                 device)
    want16 = check.reference_steps(ref, ref_cfg, cfg_file, state, batches,
                                   device, 'bfloat16')
    detail = {}
    return dict(check.train_numbers(got, want, want16, detail),
                detail=detail)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', default='')
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--fault-seeds', default='')
    parser.add_argument('--seconds', type=float, default=2.0)
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('calibrate: no CUDA device')
    cell = spec.find_cell(args.workload, spec.load_benchmark())
    seeds = [int(s) for s in args.seeds.split(',') if s]
    out = dict(workload=args.workload, card=harness.card(),
               program={}, control={}, faults={})
    for seed in seeds:
        t = time.perf_counter()
        record = harness.run(cell, seed, args.seconds, False, 'cuda')
        out['program'][seed] = dict(
            record['numbers'], run_s=time.perf_counter() - t,
            setup_s=record['setup_s'],
            rate=record['iterations'] * record['batch'] / record['window_s'],
            detail=record.get('detail'))
        print(seed, out['program'][seed], flush=True)
    for seed in [int(s) for s in args.control_seeds.split(',') if s]:
        out['control'][seed] = control_numbers(cell, seed, 'cuda')
        print('control', seed, out['control'][seed], flush=True)
    table = faults.SERVE if cell.traffic['mode'] == 'serve' else faults.TRAIN
    for seed in [int(s) for s in args.fault_seeds.split(',') if s]:
        for name, fault in table.items():
            with fault():
                record = harness.run(cell, seed, args.seconds, False, 'cuda')
            out['faults'].setdefault(name, {})[seed] = dict(
                record['numbers'], detail=record.get('detail'))
            print('fault', name, seed, record['numbers'], flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    print(text)


if __name__ == '__main__':
    main()
