"""Where the time of a forward, or of a training step, goes on the card.

    python -m imvoxelnet_tpu_torch.tools.profile_forward [--batch 8]
        [--dtype bfloat16] [--preset imvoxelnet_kitti]
        [--out work_dirs/profile_forward.json]
    python -m imvoxelnet_tpu_torch.tools.profile_forward --train [--batch 4]
        [--preset imvoxelnet_sunrgbd]
    python -m imvoxelnet_tpu_torch.tools.profile_forward --batch 1
        --preset imvoxelnet_nuscenes [--train]

Runs the preset (``imvoxelnet_kitti`` by default, or another such as
``imvoxelnet_nuscenes``, ``imvoxelnet_sunrgbd``, ``imvoxelnet_total_sunrgbd``
or ``imvoxelnet_scannet``; random weights from a seed) on its synthetic
batch (``utils/synthetic.py``: KITTI 1280x384, nuScenes six views of
1600x900 padded to 928, SUN RGB-D 640x480, ScanNet 640x480 with the
preset's ``n_images_test`` views): forward + decode/NMS (the cls bias at 0
so detections pass; Total3D with the extrinsics its layout head predicts,
the angle layer scaled down so they stay level; nuScenes with seeded
``conv_offset`` weights, whose offsets of a few pixels make the DCN sample
between pixels and off the map), or with ``--train`` the training step of
``parallel/train.py`` on the preset's synthetic training batch at its
padded train size (KITTI 1408x416, nuScenes 1600x928, SUN RGB-D 768x576,
ScanNet 640x480 with ``n_images_train`` views).  It reports:

* the median wall time of an iteration (host clock, synchronised);
* ``stage_ms``: device ms an iteration by the port's own layer spans
  (``utils/tracing.py``), keyed by span name, read from the
  ``torch.profiler`` trace of the profiled iterations
  (``tools/analyze_trace.py:launch_spans``): each span's kernels and those
  of every span inside it, a backward kernel in the span of the forward
  operator it differentiates.  Serving: ``forward``, ``backbone_fpn``,
  ``backproject``, ``neck3d``, ``head``, ``predict``, ``nms``; with
  ``--train`` ``train_step``, ``zero_grad``, ``forward`` and its layers,
  ``loss``, ``targets``, ``backward`` (what the autograd engine launches
  for no forward operator) and ``optimizer`` (clip, AdamW, LR step); for a
  DCN backbone (nuScenes) ``dcn``, every DCN's forward and, with
  ``--train``, its backward;
* ``sync_calls``: by the innermost port span around them, the host calls in
  the profiled iterations that wait for the device (``cudaMemcpy``,
  ``cudaStreamSynchronize``, ...); a span that reads nothing back to the
  host has none;
* ``host_ms``: host ms an iteration by span, each span's whole interval,
  from ``ITERS`` further iterations under ``utils/tracing.py:recording``
  (the host clock, without the profiler's cost of recording every
  operator), and their median wall time beside the plain one;
  ``cold_ms``: the same for the first, cold iteration (kernel builds,
  cuDNN's choice of algorithms, lazy CUDA modules);
* the device's busy share over the profiled iterations, the top device
  kernels by self time and the device time of the port's own kernels, from
  ``torch.profiler``;
* the card's name and power limit.

A float32 run computes in full float32 (TF32 off: ``utils/precision.py``).

Needs a CUDA device.  One JSON object goes to ``--out``; a summary to stdout.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType

from ..configs.presets import apply_overrides, get_preset
from ..models.dcn import DeformConv2d
from ..models.detector import build_model, imvoxelnet_predict
from ..parallel import mesh
from ..parallel import train as train_lib
from ..utils.precision import compute_precision
from ..utils.synthetic import serving_batch, train_batch
from ..utils.tracing import recording
from . import analyze_trace, microbench

ITERS = 5
# name fragments of the kernels in kernels/csrc/*.cu
OWN_KERNELS = ('backproject', 'grad_count', 'grad_scan', 'grad_fill',
               'grad_sum', 'conv_wgmma', 'split3', 'rect_clip_kernel',
               'rect_clip_grad_zero_kernel', 'rect_clip_grad_sweep_kernel',
               'pairwise_area_kernel', 'nms_mask_kernel', 'nms_over_kernel',
               'nms_rank_kernel', 'nms_scan_kernel')
SEED = 0


def zero_cls_bias(model):
    """The reference's cls bias of -4.595 puts every random-weight score
    near 0.01, below ``score_thr`` (x ~0.5 centerness on the indoor head);
    0 lets detections through."""
    head = model.bbox_head
    conv = head.conv_cls if hasattr(head, 'conv_cls') else head.cls_conv
    with torch.no_grad():
        conv.bias.zero_()


def level_angle_head(model):
    """Random weights put a Total3D model's predicted pitch and roll
    anywhere in [-pi/2, pi/2), and a camera that looks at the ceiling sees
    little of the grid; the angle MLP's last layer at 1/100 keeps them
    within a few degrees, as a trained head's are.  No-op without a layout
    head."""
    head = getattr(model, 'head_2d', None)
    if head is not None:
        with torch.no_grad():
            head.angle_mlp[-1].weight.mul_(0.01)


def dcn_offsets(model, seed: int = SEED, pixels: float = 3.0):
    """Seeded nonzero ``conv_offset`` weights for every DCN of ``model``.
    The init's zeros make every offset 0 and every mask 0.5, a plain conv
    at half strength; here the offsets' biases are uniform within
    ``pixels``, their weights small (std ``0.1 / sqrt(fan_in)``), so that
    the taps sample between pixels and some fall off the map, and the
    masks' biases standard normal.  No-op without a DCN."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if not isinstance(mod, DeformConv2d):
                continue
            conv = mod.conv_offset
            fan_in = conv.weight[0].numel()
            w = torch.randn(conv.weight.shape, generator=gen) * (
                0.1 / fan_in ** 0.5)
            b = torch.cat([(torch.rand(18, generator=gen) * 2 - 1) * pixels,
                           torch.randn(9, generator=gen)])
            conv.weight.copy_(w)
            conv.bias.copy_(b)


def span_ms(events, iters: int) -> dict:
    """Device ms an iteration by the port's layer spans of a chrome trace:
    a device event counts in every span that
    ``analyze_trace.launch_spans`` finds around its launch."""
    launches = analyze_trace.launch_map(events)
    stacks = analyze_trace.launch_spans(events, launches)
    out = collections.Counter()
    for e in analyze_trace.device_events(events):
        for name in set(stacks.get(e.get('args', {}).get('correlation'),
                                   ())):
            out[name] += e.get('dur', 0) / 1e3 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def span_syncs(events) -> dict:
    """``{span: count}``: the host calls of a chrome trace that wait for
    the device (``analyze_trace.SYNC_CALLS``), by the innermost port span
    open around them (``None``: outside every span)."""
    calls = dict(enumerate(
        e for e in events if e.get('ph') == 'X'
        and e.get('cat') in analyze_trace.LAUNCH_CATS
        and e.get('name') in analyze_trace.SYNC_CALLS))
    stacks = analyze_trace.launch_spans(events, calls)
    return dict(collections.Counter(
        (stacks.get(i) or [None])[0] for i in calls))


def host_ms(records, iters: int) -> dict:
    """Host ms an iteration by span name of a ``recording()`` list: the
    sum of each span's intervals (a span's holds those inside it)."""
    out = collections.Counter()
    for name, _, _, t0, t1 in records:
        out[name] += (t1 - t0) / 1e6 / iters
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def make_run(preset_name: str, train: bool, batch_size: int, dtype: str,
             device='cuda', overrides=(), view_sharded: bool = False):
    """The preset's model (random weights from ``SEED``) and ``run()``, one
    forward + decode or one training step on its synthetic batch, at the
    precision ``dtype`` names (``utils/precision.py``: float32 means TF32
    off).  ``overrides``: ``PATH=VALUE`` preset fields
    (``configs/presets.py:apply_overrides``).  ``view_sharded`` (serving
    only, in a process group): the forward takes this rank's share of the
    views and pools the voxel sums over the ranks
    (``parallel/mesh.py:view_sharded_forward``).  Returns ``(model,
    optimizer or None, run)``."""
    preset = apply_overrides(get_preset(preset_name), list(overrides))
    cfg = dataclasses.replace(preset.model, compute_dtype=dtype,
                              view_shard_axis='view' if view_sharded
                              else None)
    if view_sharded and train:
        raise ValueError('the view-sharded forward serves; it does not '
                         'train')
    model = build_model(cfg, device=device, seed=SEED)
    dcn_offsets(model)
    if train:
        batch = train_batch(preset.data, batch_size, device, seed=SEED,
                            layout=cfg.layout_head is not None)
        optimizer, scheduler = train_lib.make_optimizer(
            model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
            preset.grad_clip_norm, steps_per_epoch=1000,
            lr_steps=preset.lr_steps)
        train_step = train_lib.make_train_step(model, optimizer, scheduler)

        def run():
            return train_step(batch)['loss']
        return model, optimizer, run
    zero_cls_bias(model)
    level_angle_head(model)
    batch = serving_batch(preset.data.dataset, batch_size, device, seed=SEED,
                          views=preset.data.n_images_test)
    forward = mesh.view_sharded_forward(model) if view_sharded else model
    # Total3D serves with the extrinsics its layout head predicts
    predicted = cfg.layout_head is not None

    def run():
        with compute_precision(dtype), torch.no_grad():
            head_outs, valid, *features_2d = forward(
                batch, use_predicted_extrinsics=predicted)
            return imvoxelnet_predict(cfg, head_outs, valid,
                                      batch['origins'], *features_2d)
    return model, None, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--train', action='store_true',
                    help='profile the training step, not the forward')
    ap.add_argument('--batch', type=int, default=None,
                    help='samples (default 8; 4 with --train)')
    ap.add_argument('--dtype', default='bfloat16',
                    choices=('float32', 'bfloat16'))
    ap.add_argument('--preset', default='imvoxelnet_kitti',
                    help='a preset of configs/presets.py')
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

    _, _, run = make_run(args.preset, args.train, batch_size, args.dtype)
    with recording() as cold:
        run()                                   # build kernels, warm up
        torch.cuda.synchronize()
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(ITERS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recorded_walls = []
    with recording() as records:
        for _ in range(ITERS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            recorded_walls.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        events = analyze_trace.load_events(path)
        stages, syncs = span_ms(events, ITERS), span_syncs(events)
    # device rows, less the annotations (the port's spans) that span
    # kernels already counted
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

    smi = microbench.card()
    wall = sorted(walls)[len(walls) // 2]
    result = dict(
        card=smi, preset=args.preset,
        mode='train' if args.train else 'forward',
        batch=batch_size, dtype=args.dtype, iters=ITERS,
        stage_ms=stages, sync_calls=syncs,
        host_ms=host_ms(records, ITERS), cold_ms=host_ms(cold, 1),
        wall_ms_median=wall, scenes_per_s=batch_size * 1e3 / wall,
        recorded_wall_ms_median=sorted(recorded_walls)[ITERS // 2],
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
