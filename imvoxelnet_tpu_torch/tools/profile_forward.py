"""Where the time of the KITTI forward, or of a training step, goes on the
card.

    python -m imvoxelnet_tpu_torch.tools.profile_forward [--batch 8]
        [--dtype bfloat16] [--out work_dirs/profile_forward.json]
    python -m imvoxelnet_tpu_torch.tools.profile_forward --train [--batch 4]

Runs ``imvoxelnet_kitti`` (random weights from a seed) on a synthetic KITTI
batch: forward + decode/NMS (the cls bias at 0 so detections pass), or with
``--train`` the training step of ``parallel/train.py`` at the preset's padded
train size (1408x416).  It reports:

* stage times from CUDA events recorded by forward hooks around the
  backbone, FPN, 3D neck and head; backprojection is the span between the
  FPN's end and the neck's start, decode + NMS the span after the head.
  With ``--train`` also the step's phases: forward, targets + loss (their
  forward and backward, up to the gradient of the head's maps), the rest of
  the backward, and the optimizer (clip + AdamW, up to its step's end);
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
from ..parallel import train as train_lib
from ..utils.synthetic import kitti_batch, kitti_train_batch

STAGES = ('backbone', 'neck', 'neck_3d', 'bbox_head')
ITERS = 5
# name fragments of the kernels in kernels/csrc/*.cu
OWN_KERNELS = ('backproject', 'conv_wgmma', 'split3', 'rect_clip_kernel',
               'pairwise_area_kernel', 'nms_mask_kernel', 'nms_scan_kernel')
SEED = 0


def record(events, key):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    events[key] = ev


def stage_events(model, events):
    """Record a CUDA event before and after each top-level stage."""
    def hook(name, when):
        return lambda *_: record(events, (name, when))

    handles = []
    for name in STAGES:
        mod = getattr(model, name)
        handles.append(mod.register_forward_pre_hook(hook(name, 'start')))
        handles.append(mod.register_forward_hook(hook(name, 'end')))
    return handles


def step_events(model, optimizer, events):
    """Events at the training step's phase boundaries: the model's forward,
    the gradient of the head's class map (the loss's backward is done), and
    the optimizer's step."""
    def grad_hook(_):
        record(events, ('backward', 'start'))

    def forward_end(_mod, _args, out):
        record(events, ('forward', 'end'))
        head_outs, _ = out
        head_outs[0].register_hook(grad_hook)

    return [model.register_forward_pre_hook(
                lambda *_: record(events, ('forward', 'start'))),
            model.register_forward_hook(forward_end),
            optimizer.register_step_pre_hook(
                lambda *_: record(events, ('optimizer', 'start'))),
            optimizer.register_step_post_hook(
                lambda *_: record(events, ('optimizer', 'end')))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--train', action='store_true',
                    help='profile the training step, not the forward')
    ap.add_argument('--batch', type=int, default=None,
                    help='samples (default 8; 4 with --train)')
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('float32', 'bfloat16'))
    ap.add_argument('--out', default=None,
                    help='JSON path (default work_dirs/profile_forward.json '
                         'or work_dirs/profile_train.json)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_forward: no CUDA device', file=sys.stderr)
        return 1
    batch_size = args.batch or (4 if args.train else 8)
    out_path = args.out or ('work_dirs/profile_train.json' if args.train
                            else 'work_dirs/profile_forward.json')

    preset = get_preset('imvoxelnet_kitti')
    cfg = dataclasses.replace(preset.model, compute_dtype=args.dtype)
    model = build_model(cfg, device='cuda', seed=SEED)
    events = {}
    handles = []
    if args.train:
        batch = kitti_train_batch(batch_size, 'cuda', seed=SEED,
                                  size=preset.data.train_size)
        optimizer, scheduler = train_lib.make_optimizer(
            model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
            preset.grad_clip_norm, steps_per_epoch=1000,
            lr_steps=preset.lr_steps)
        train_step = train_lib.make_train_step(model, optimizer, scheduler)

        def run():
            return train_step(batch)['loss']
    else:
        with torch.no_grad():
            model.bbox_head.conv_cls.bias.zero_()
        batch = kitti_batch(batch_size, 'cuda', seed=SEED)

        def run():
            with torch.no_grad():
                head_outs, _ = model(batch)
                return imvoxelnet_predict(cfg, head_outs)

    run()                                       # build kernels, warm up
    torch.cuda.synchronize()

    handles += stage_events(model, events)
    if args.train:
        handles += step_events(model, optimizer, events)
    spans = {k: [] for k in ('backbone', 'fpn', 'backprojection', 'neck_3d',
                             'head', 'total')}
    spans.update({k: [] for k in (
        ('forward', 'targets_loss', 'backward', 'optimizer') if args.train
        else ('decode_nms',))})
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(ITERS):
        t0 = time.perf_counter()
        record(events, ('total', 'start'))
        run()
        record(events, ('total', 'end'))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

        e = events
        pairs = [('backbone', e['backbone', 'start'], e['backbone', 'end']),
                 ('fpn', e['neck', 'start'], e['neck', 'end']),
                 ('backprojection', e['neck', 'end'], e['neck_3d', 'start']),
                 ('neck_3d', e['neck_3d', 'start'], e['neck_3d', 'end']),
                 ('head', e['bbox_head', 'start'], e['bbox_head', 'end']),
                 ('total', e['total', 'start'], e['total', 'end'])]
        if args.train:
            pairs += [
                ('forward', e['forward', 'start'], e['forward', 'end']),
                ('targets_loss', e['forward', 'end'], e['backward', 'start']),
                ('backward', e['backward', 'start'], e['optimizer', 'start']),
                ('optimizer', e['optimizer', 'start'],
                 e['optimizer', 'end'])]
        else:
            pairs.append(('decode_nms', e['bbox_head', 'end'],
                          e['total', 'end']))
        for span, a, b in pairs:
            spans[span].append(a.elapsed_time(b))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for h in handles:
        h.remove()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows, less the annotations (the optimizer's step range) that
    # span kernels already counted
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation]
    device_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    kernels.sort(key=lambda ev: -ev.self_device_time_total)
    top = [dict(name=ev.key[:90], calls=ev.count,
                ms_per_iter=ev.self_device_time_total / 1e3 / ITERS)
           for ev in kernels[:15]]
    own = [dict(name=ev.key[:90], calls_per_iter=ev.count / ITERS,
                ms_per_iter=ev.self_device_time_total / 1e3 / ITERS)
           for ev in kernels if any(k in ev.key for k in OWN_KERNELS)]

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wall = sorted(walls)[len(walls) // 2]
    result = dict(
        card=smi, mode='train' if args.train else 'forward',
        batch=batch_size, dtype=args.dtype, iters=ITERS,
        stage_ms={k: sorted(v)[len(v) // 2] for k, v in spans.items()},
        wall_ms_median=wall, scenes_per_s=batch_size * 1e3 / wall,
        profiled_device_busy_share=device_ms / prof_wall_ms,
        top_device_kernels=top, own_kernels=own, peak_memory_gb=peak_gb)
    if args.train:
        result['steps_per_s'] = 1e3 / wall
    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump(result, f, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ('top_device_kernels', 'own_kernels')}))
    for row in top:
        print(f"{row['ms_per_iter']:9.3f} ms  x{row['calls']:<4} "
              f"{row['name']}")
    print('own kernels, per iteration:')
    for row in own:
        print(f"{row['ms_per_iter']:9.4f} ms  x{row['calls_per_iter']:<4g} "
              f"{row['name']}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
