"""Where the time of the KITTI forward goes on the card.

    python -m imvoxelnet_tpu_torch.tools.profile_forward [--batch 8]
        [--dtype bfloat16] [--out work_dirs/profile_forward.json]

Runs ``imvoxelnet_kitti`` forward + decode/NMS (random weights from a seed,
the cls bias at 0 so detections pass) on a synthetic KITTI batch and reports:

* stage times from CUDA events recorded by forward hooks around the
  backbone, FPN, 3D neck and head; backprojection is the span between the
  FPN's end and the neck's start, decode + NMS the span after the head;
* the device's busy share over the timed iterations, the top device
  kernels by self time and the device time of the port's own kernels, from
  ``torch.profiler``;
* the card's name and power limit.

Needs a CUDA device.  One JSON object goes to ``--out``; a summary to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from ..configs.presets import get_preset
from ..models.detector import build_model, imvoxelnet_predict
from ..utils.synthetic import kitti_batch

STAGES = ('backbone', 'neck', 'neck_3d', 'bbox_head')
ITERS = 5
# name fragments of the kernels in kernels/csrc/*.cu
OWN_KERNELS = ('backproject', 'conv_wgmma', 'split3', 'rect_clip_kernel',
               'pairwise_area_kernel', 'nms_mask_kernel', 'nms_scan_kernel')
SEED = 0


def stage_events(model):
    """Record a CUDA event before and after each top-level stage."""
    events = {}

    def hook(name, when):
        def record(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[(name, when)] = ev
        return record

    handles = []
    for name in STAGES:
        mod = getattr(model, name)
        handles.append(mod.register_forward_pre_hook(hook(name, 'start')))
        handles.append(mod.register_forward_hook(hook(name, 'end')))
    return events, handles


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('float32', 'bfloat16'))
    ap.add_argument('--out', default='work_dirs/profile_forward.json')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_forward: no CUDA device', file=sys.stderr)
        return 1

    cfg = dataclasses.replace(get_preset('imvoxelnet_kitti').model,
                              compute_dtype=args.dtype)
    model = build_model(cfg, device='cuda', seed=SEED)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    batch = kitti_batch(args.batch, 'cuda', seed=SEED)

    def forward():
        with torch.no_grad():
            head_outs, _ = model(batch)
            return imvoxelnet_predict(cfg, head_outs)

    forward()                                   # build kernels, warm up
    torch.cuda.synchronize()

    events, handles = stage_events(model)
    spans = {k: [] for k in ('backbone', 'fpn', 'backprojection', 'neck_3d',
                             'head', 'decode_nms', 'total')}
    walls = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

        e = events
        for span, a, b in (
                ('backbone', e['backbone', 'start'], e['backbone', 'end']),
                ('fpn', e['neck', 'start'], e['neck', 'end']),
                ('backprojection', e['neck', 'end'], e['neck_3d', 'start']),
                ('neck_3d', e['neck_3d', 'start'], e['neck_3d', 'end']),
                ('head', e['bbox_head', 'start'], e['bbox_head', 'end']),
                ('decode_nms', e['bbox_head', 'end'], end),
                ('total', start, end)):
            spans[span].append(a.elapsed_time(b))
    for h in handles:
        h.remove()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            forward()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    device_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    kernels.sort(key=lambda ev: -ev.self_device_time_total)
    top = [dict(name=ev.key[:90], calls=ev.count,
                ms_per_forward=ev.self_device_time_total / 1e3 / ITERS)
           for ev in kernels[:15]]
    own = [dict(name=ev.key[:90], calls_per_forward=ev.count / ITERS,
                ms_per_forward=ev.self_device_time_total / 1e3 / ITERS)
           for ev in kernels if any(k in ev.key for k in OWN_KERNELS)]

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = dict(
        card=smi, batch=args.batch, dtype=args.dtype, iters=ITERS,
        stage_ms={k: sorted(v)[len(v) // 2] for k, v in spans.items()},
        wall_ms_median=sorted(walls)[len(walls) // 2],
        scenes_per_s=args.batch * 1e3 / (sorted(walls)[len(walls) // 2]),
        profiled_device_busy_share=device_ms / prof_wall_ms,
        top_device_kernels=top, own_kernels=own,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ('top_device_kernels', 'own_kernels')}))
    for row in top:
        print(f"{row['ms_per_forward']:9.3f} ms  x{row['calls']:<4} "
              f"{row['name']}")
    print('own kernels, per forward:')
    for row in own:
        print(f"{row['ms_per_forward']:9.4f} ms  x{row['calls_per_forward']:<4g} "
              f"{row['name']}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
