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

* stage times from CUDA events recorded by forward hooks around the
  backbone, FPN, 3D neck and head; backprojection is the span between the
  FPN's end and the neck's start, decode + NMS the span after the head.
  With ``--train`` also the step's phases: forward, targets + loss (their
  forward and backward, up to the last gradient of the head's outputs), the
  rest of the backward, and the optimizer (clip + AdamW, up to its step's
  end); for an indoor preset also the forward of the pieces of targets +
  loss (``indoor_targets``, the focal loss, the centerness BCE, the box
  loss -- rotated IoU-3D or, for ScanNet, axis-aligned IoU -- and for
  Total3D the layout head's loss; a piece called twice, as the IoU-3D loss
  is with a layout head, counts both calls); for a DCN backbone (nuScenes)
  the forward of every DCN (``dcn``) and, with ``--train``, their
  backward, from each one's output gradient to its input gradient
  (``dcn_backward``);
* the device's busy share over the timed iterations, the top device
  kernels by self time and the device time of the port's own kernels, from
  ``torch.profiler``;
* the card's name and power limit.

A float32 run computes in full float32 (TF32 off: ``utils/precision.py``).

Needs a CUDA device.  One JSON object goes to ``--out``; a summary to stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType

from ..configs.presets import apply_overrides, get_preset
from ..models.dcn import DeformConv2d
from ..models.detector import build_model, imvoxelnet_predict
from ..models.heads import imvoxel_heads as ivh
from ..models.heads import layout_head as lh
from ..ops import losses as loss_ops
from ..parallel import mesh
from ..parallel import train as train_lib
from ..utils.precision import compute_precision
from ..utils.synthetic import serving_batch, train_batch
from . import microbench

STAGES = ('backbone', 'neck', 'neck_3d', 'bbox_head')
ITERS = 5
# name fragments of the kernels in kernels/csrc/*.cu
OWN_KERNELS = ('backproject', 'grad_count', 'grad_scan', 'grad_fill',
               'grad_sum', 'conv_wgmma', 'split3', 'rect_clip_kernel',
               'rect_clip_grad_zero_kernel', 'rect_clip_grad_sweep_kernel',
               'pairwise_area_kernel', 'nms_mask_kernel', 'nms_scan_kernel')
SEED = 0
# the indoor loss's pieces timed on their own: (span, module, function)
INDOOR_LOSS_SPANS = (('indoor_targets', ivh, 'indoor_targets'),
                     ('focal_loss', loss_ops, 'sigmoid_focal_loss'),
                     ('centerness_bce', loss_ops, 'binary_cross_entropy'))


def loss_spans(cfg):
    """The indoor loss's pieces of ``cfg``: the shared ones, its box loss
    and, with a layout head, the layout head's loss."""
    box = ('iou_3d_loss' if cfg.indoor_head.dataset == 'sunrgbd'
           else 'axis_aligned_iou_loss')
    spans = INDOOR_LOSS_SPANS + ((box, loss_ops, box),)
    if cfg.layout_head is not None:
        spans += (('layout_head_loss', lh, 'layout_head_loss'),)
    return spans


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
    the last gradient of the head's outputs to arrive (the loss's backward
    is done), and the optimizer's step."""
    def grad_hook(_):
        record(events, ('backward', 'start'))

    def forward_end(_mod, _args, out):
        record(events, ('forward', 'end'))
        head_outs = out[0]
        for t in head_outs:
            for leaf in (t if isinstance(t, (list, tuple)) else [t]):
                leaf.register_hook(grad_hook)

    return [model.register_forward_pre_hook(
                lambda *_: record(events, ('forward', 'start'))),
            model.register_forward_hook(forward_end),
            optimizer.register_step_pre_hook(
                lambda *_: record(events, ('optimizer', 'start'))),
            optimizer.register_step_post_hook(
                lambda *_: record(events, ('optimizer', 'end')))]


def span_events(events, spans):
    """Wrap each ``(name, module, function)`` of ``spans`` so that CUDA
    events bracket its calls, listed under ``events[name]``; returns the
    originals to restore."""
    saved = []
    for name, mod, attr in spans:
        fn = getattr(mod, attr)

        def timed(*a, _fn=fn, _name=name, **k):
            pair = {}
            record(pair, 'start')
            out = _fn(*a, **k)
            record(pair, 'end')
            events.setdefault(_name, []).append((pair['start'], pair['end']))
            return out
        saved.append((mod, attr, fn))
        setattr(mod, attr, timed)
    return saved


def dcn_events(model, events, backward: bool):
    """CUDA events around each DCN's forward, listed under
    ``events['dcn']``, and with ``backward`` from the gradient of its output
    to that of its input, under ``events['dcn_backward']``."""
    def timed(mod):
        pair = {}

        def pre(_mod, _args):
            record(pair, 'start')

        def post(_mod, args, out):
            record(pair, 'end')
            events.setdefault('dcn', []).append((pair['start'], pair['end']))
            if not (backward and out.requires_grad
                    and args[0].requires_grad):
                return
            grad = {}

            def out_grad(_g):
                record(grad, 'start')

            def in_grad(_g):
                record(grad, 'end')
                events.setdefault('dcn_backward', []).append(
                    (grad['start'], grad['end']))
            out.register_hook(out_grad)
            args[0].register_hook(in_grad)
        return [mod.register_forward_pre_hook(pre),
                mod.register_forward_hook(post)]

    return [h for mod in model.modules() if isinstance(mod, DeformConv2d)
            for h in timed(mod)]


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

    preset = get_preset(args.preset)
    indoor = preset.model.head_kind == 'indoor'
    model, optimizer, run = make_run(args.preset, args.train, batch_size,
                                     args.dtype)
    events = {}
    handles = []
    run()                                       # build kernels, warm up
    torch.cuda.synchronize()

    handles += stage_events(model, events)
    if args.train:
        handles += step_events(model, optimizer, events)
    pieces = loss_spans(preset.model) if args.train and indoor else ()
    saved = span_events(events, pieces)
    sums = [name for name, _, _ in pieces]
    if any(preset.model.stage_with_dcn):
        handles += dcn_events(model, events, args.train)
        sums += ['dcn', 'dcn_backward'] if args.train else ['dcn']
    spans = {k: [] for k in ('backbone', 'fpn', 'backprojection', 'neck_3d',
                             'head', 'total')}
    spans.update({k: [] for k in (
        ('forward', 'targets_loss', 'backward', 'optimizer') if args.train
        else ('decode_nms',))})
    spans.update({name: [] for name in sums})
    try:
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ITERS):
            t0 = time.perf_counter()
            for name in sums:
                events[name] = []
            record(events, ('total', 'start'))
            run()
            record(events, ('total', 'end'))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

            e = events
            pairs = [
                ('backbone', e['backbone', 'start'], e['backbone', 'end']),
                ('fpn', e['neck', 'start'], e['neck', 'end']),
                ('backprojection', e['neck', 'end'], e['neck_3d', 'start']),
                ('neck_3d', e['neck_3d', 'start'], e['neck_3d', 'end']),
                ('head', e['bbox_head', 'start'], e['bbox_head', 'end']),
                ('total', e['total', 'start'], e['total', 'end'])]
            if args.train:
                pairs += [
                    ('forward', e['forward', 'start'], e['forward', 'end']),
                    ('targets_loss', e['forward', 'end'],
                     e['backward', 'start']),
                    ('backward', e['backward', 'start'],
                     e['optimizer', 'start']),
                    ('optimizer', e['optimizer', 'start'],
                     e['optimizer', 'end'])]
            else:
                pairs.append(('decode_nms', e['bbox_head', 'end'],
                              e['total', 'end']))
            for span, a, b in pairs:
                spans[span].append(a.elapsed_time(b))
            for name in sums:
                spans[name].append(sum(a.elapsed_time(b) for a, b in e[name]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        # the hooks and the wrapped loss functions go, also on an error
        for h in handles:
            h.remove()
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)

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

    smi = microbench.card()
    wall = sorted(walls)[len(walls) // 2]
    result = dict(
        card=smi, preset=args.preset,
        mode='train' if args.train else 'forward',
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
