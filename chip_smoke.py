"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each failing the run on its own error:
  1. build   -- nvcc builds the kernel libraries from the sources in
                imvoxelnet_tpu_torch/kernels/csrc, in parallel; no kernel
                of the clip library may need a stack frame or spill, and the
                conv library's SASS must hold tensor-core (HGMMA)
                instructions;
  2. kernels -- each kernel against its plain PyTorch version on the card at
                the shapes the KITTI main path gives it, with times;
  3. slice   -- the full-width imvoxelnet_kitti forward + decode/NMS through
                the port's entry points: b=1 float32 (held against the same
                model's plain path on the card) and b=8 bfloat16 (throughput),
                with the launch counts that show the kernels ran, and with
                decode + NMS forbidden to wait for the device.
  4. train   -- the full-width imvoxelnet_kitti training step
                (parallel/train.py): b=1 float32 through the kernels held
                against the plain path (losses, every trainable gradient,
                the 3D neck's batch-norm statistics); where the gradient gap
                comes from (each kernel swapped alone for its plain version,
                and both paths against a float64 step of the plain path);
                two steps from one state with cudnn.deterministic, whose
                gradients must repeat bit for bit; the backprojection's
                backward kernel bit for bit against its plain version on the
                CPU, twice, at the b=4 bfloat16 and b=1 float32 shapes, with
                the time of each of its passes; B1's forward and B3's
                forward and dx at the b=4 bfloat16 shapes; 5 timed b=4
                bfloat16 steps at 1408x416 with their launch counts; one
                step forbidden to wait for the device.
  5. indoor  -- the SUN RGB-D serving path at full width and depth
                (imvoxelnet_sunrgbd, imvoxelnet_sunrgbd_fast and
                imvoxelnet_perspective_sunrgbd_fast, 640x480): b=1 float32
                held against the plain path and b=8 bfloat16 timed, with
                launch counts and a decode that must not wait for the
                device; the backprojection at the indoor shapes (C=64 into
                204,800 voxels, C=256 into 25,600) and the NMS mask + scan
                at 80 and 240 groups of 256 candidates against their plain
                versions.
  6. indoor train -- the SUN RGB-D training step (imvoxelnet_sunrgbd and
                imvoxelnet_sunrgbd_fast, full width and depth, 768x576):
                the clip's paired entry and its backward kernels against
                autograd of the plain clip at the b=4 IoU-3D loss shapes
                (934,400 and 116,800 pairs; a stress input with 80% of the
                pairs carrying an area gradient, and the corners and area
                gradient of a b=4 step, timed, with the time of each of the
                backward's passes and the live count its kernels found;
                then every area gradient nonzero, none, NaN at known pairs,
                1 and 129 pairs; two launches bit-identical), B1's forward
                and backward at the training shapes (b=4 bfloat16, b=1
                float32, with the backward's segment-length histogram);
                per preset one b=1
                float32 step through the kernels held against the plain
                path (losses, every gradient, the neck's BN statistics;
                positives at every level, a nonzero gradient into the
                clip), 5 timed b=4 bfloat16 steps with their launch counts
                and one step forbidden to wait for the device; then one
                b=4 bfloat16 step of each other SUN RGB-D preset (_top27
                and the perspective family), with its launch counts.
  7. total3d -- the Total3D presets (imvoxelnet_total_sunrgbd and _fast,
                full width and depth): serving with the extrinsics the
                layout head predicts, b=1 float32 held against the plain
                path (angles and layout too) and b=8 bfloat16 timed with a
                decode that must not wait for the device; the NMS mask + scan
                at 33 x 8 = 264 groups of 256; training (768x576, camera
                angles and room layout as GT) b=1 float32 held against the
                plain path (head_2d's gradients included), 5 timed b=4
                bfloat16 steps, one step forbidden to wait for the device;
                one b=4 step of _top27; launches asserted (the IoU-3D loss
                and the layout loss each take the clip and its backward).
  8. scannet -- multi-view ScanNet (imvoxelnet_scannet and _fast, 640x480):
                serving with 50 views, b=1 float32 held against the plain
                path and b=1 bfloat16 timed (class-aware axis-aligned NMS:
                a plain mask and the scan kernel over ~3,000 candidates,
                which it records and checks); training with 20 views, b=1
                float32 held against the plain path, 5 timed b=1 bfloat16
                steps, one step forbidden to wait for the device; one step
                of _top27; the backprojection with 20 and 50 views (C=64 and
                256) and its backward with 20 views, bit for bit against the
                plain version on the CPU.
  9. nuscenes -- imvoxelnet_nuscenes at full width and depth (six cameras
                of 1600x900 padded to 928, ResNet-50 with DCNv2 in stages
                3-4 on seeded nonzero offsets, the nuScenes neck, 312x312x12
                voxels): the kernels at its shapes (B1 with six views and
                7 of 232 feature rows cropped, its backward with the segment
                histogram, B3 on the 312x312x12 block0 with its 4x8 tiling,
                forward and dx, the NMS mask + scan at one group of 1,000);
                serving b=1 float32 held against the plain path (every
                score tied at 0.5, so that the decode's order is the stable
                top-k's index order on both paths) and b=1 bfloat16 timed
                with a decode that must not wait for the device; one b=1
                float32 training step held against the plain path (the DCN
                and conv_offset gradients named); two float32 steps from one
                state with cudnn.deterministic, whose gradients must repeat
                bit for bit; 5 timed b=1 bfloat16 steps and one that must
                not wait for the device; launches asserted.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
float32 work runs with TF32 off (utils/precision.py).  Weights are random
from a seed.  Needs a CUDA device; imports no JAX.
"""

import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from imvoxelnet_tpu_torch import kernels
from imvoxelnet_tpu_torch.configs.presets import get_preset
from imvoxelnet_tpu_torch.kernels import backproject as bp_kernel
from imvoxelnet_tpu_torch.kernels import build
from imvoxelnet_tpu_torch.kernels import conv3x3x3 as conv_kernel
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.core import target_assign
from imvoxelnet_tpu_torch.models import necks3d
from imvoxelnet_tpu_torch.models.dcn import DeformConv2d
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.models.detector import (build_model,
                                                  imvoxelnet_loss,
                                                  imvoxelnet_predict)
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops
from imvoxelnet_tpu_torch.parallel import train as train_lib
from imvoxelnet_tpu_torch.tools.profile_forward import (dcn_offsets,
                                                        level_angle_head,
                                                        zero_cls_bias)
from imvoxelnet_tpu_torch.utils.precision import compute_precision
from imvoxelnet_tpu_torch.utils.synthetic import (kitti_batch,
                                                  kitti_train_batch,
                                                  serving_batch,
                                                  sunrgbd_batch, train_batch)

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SEED = 0


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps, warmup=1, queue_us=0):
    """Milliseconds per call of ``fn`` between two CUDA events.

    A kernel of a few microseconds runs faster than the host can launch it,
    and the events then time the host.  ``queue_us`` (the host's cost per
    call, generously) holds the device in a spin kernel while the host
    queues all ``reps`` launches, so that the events time the device alone.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_us:
        torch.cuda._sleep(int(reps * queue_us * 2000))   # ~2 cycles a ns
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_flops, dtype):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def copy_rate_tb_s():
    """Device-to-device copy of 1 GiB, read + write bytes per second: the
    memory rate a bytes-bound kernel can reach on this card."""
    src = torch.empty(1 << 28, dtype=torch.float32, device='cuda')
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), 10)
    return 2 * nbytes(src) / (ms * 1e-3) / 1e12


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def gathered_rows(points, proj, hw, hf, wf):
    """How many distinct feature rows (sample, view, pixel) the gather
    reads, and how many (sample, view, voxel) pairs see one."""
    idx, valid = bp._view_indices(points, proj, hw, hf, wf)     # (B, V, P)
    b, v = idx.shape[:2]
    keys = (torch.arange(b * v, device=idx.device).reshape(b, v, 1)
            * (hf * wf) + idx)[valid]
    return int(torch.unique(keys).numel()), int(valid.sum())


def check_backproject(b, dtype, tol, rng, name='imvoxelnet_kitti',
                      train=False):
    """B1 at the main-path shapes of preset ``name``: its feature map,
    channels, views and voxel grid; ``train``: the preset's padded training
    size and training views."""
    preset = get_preset(name)
    cfg = preset.model
    if train:
        batch = train_batch(preset.data, b, 'cuda', seed=SEED)
    else:
        batch = serving_batch(preset.data.dataset, b, 'cuda', seed=SEED,
                              views=preset.data.n_images_test)
    v, h, w = batch['images'].shape[1:4]
    hf, wf, c = h // 4, w // 4, cfg.fpn_out_channels
    feats = torch.tensor(rng.randn(b, v, hf, wf, c).astype(np.float32),
                         device='cuda').to(dtype)
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                           batch['origins']).reshape(b, -1, 3).contiguous()
    proj = bp.compute_projection(batch['intrinsics'], batch['extrinsics'],
                                 batch['ratios']).contiguous()
    hw = (batch['img_shape'] // 4).to(torch.int32)
    acc, cnt = bp_kernel.backproject_batch(feats, points, proj, hw)
    ref_acc, ref_cnt = bp.backproject_batch_plain(feats, points, proj, hw)
    torch.cuda.synchronize()
    seen_diff = int(((cnt > 0) != (ref_cnt > 0)).sum())
    if seen_diff:
        raise AssertionError(f'backproject: seen differs at {seen_diff}')
    err = (acc.float() - ref_acc.float()).abs().max().item()
    if err > tol:
        raise AssertionError(f'backproject: max abs err {err} > {tol}')
    p = points.shape[1]
    # what this input needs: the feature rows that some voxel reads, each
    # once; per voxel and view 3 projections and 2 divides, per seen pair C
    # adds
    rows_read, n_valid = gathered_rows(points, proj, hw, hf, wf)
    n_flops = b * v * p * (18 + 2) + n_valid * c
    t_bound, by = bound(rows_read * c * feats.element_size()
                        + nbytes(points, proj, hw, acc, cnt), n_flops,
                        torch.float32)
    return dict(
        name='backproject', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/backproject.cu',
        replaces='imvoxelnet_tpu/ops/backproject_pallas.py:155',
        shape=f'{name}{" training" if train else ""} b={b} '
              f'{str(dtype)[6:]} features {tuple(feats.shape)} P={p}',
        max_abs_err=err, views=v,
        seen_frac=float((cnt > 0).float().mean()),
        max_view_count=int(cnt.float().max()), feature_rows_read=rows_read,
        feature_rows=b * v * hf * wf,
        ms=time_ms(lambda: bp_kernel.backproject_batch(feats, points, proj, hw),
                   10),
        plain_ms=time_ms(
            lambda: bp.backproject_batch_plain(feats, points, proj, hw), 3),
        bound_ms=t_bound, bound_by=by, library_ms=None)


CLIP_REPLACES = 'imvoxelnet_tpu/ops/iou_pallas.py:189'
CLIP_SOURCE = 'imvoxelnet_tpu_torch/kernels/csrc/rect_clip.cu'
# per clipped pair ~ 4 edges x 8 slots x 14 flops + the 8-term shoelace
CLIP_FLOPS = 4 * 8 * 14 + 8 * 4
# The clip and scan kernels take microseconds: `ms` is their time on the
# device with the launches queued ahead, `launch_bound_ms` the time per call
# when the host launches them back to back (what a caller in a loop sees).
# QUEUE_US is generous: a call of the clip's backward costs the host three
# allocations, a memset and two launches.
SMALL_REPS = 200
QUEUE_US = 150


def car_boxes(rng, g, n):
    """``(g, n, 5)`` BEV boxes of car size, clustered so that they overlap,
    touch and nest; boxes 0 and 1 of every group are identical."""
    xy = rng.uniform(0, 0.8 * np.sqrt(n), (g, n, 2))
    wl = np.stack([rng.uniform(1.4, 1.8, (g, n)),
                   rng.uniform(3.4, 4.4, (g, n))], -1)
    yaw = rng.uniform(-np.pi, np.pi, (g, n, 1))
    boxes = torch.tensor(np.concatenate([xy, wl, yaw], -1).astype(np.float32),
                         device='cuda')
    boxes[:, 1] = boxes[:, 0]
    return boxes


def assert_same_bits(name, got, ref):
    n_diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    if n_diff:
        raise AssertionError(f'{name}: {n_diff} 32-bit words of '
                             f'{got.numel()} values not bit-identical')


def clip_row(name, replaces, shape, ms, plain_ms, n_bytes, n_flops, **extra):
    t_bound, by = bound(n_bytes, n_flops, torch.float32)
    return dict(name=name, route='cuda', source=CLIP_SOURCE,
                replaces=replaces, shape=shape, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=t_bound, bound_by=by,
                library_ms=None, **extra)


def check_rect_clip_paired(rng):
    """The paired entry at the 100 x 100 pairs of one KITTI sample's NMS."""
    corners = box_ops.bev_corners(car_boxes(rng, 1, 100)[0])
    k = corners.shape[0]
    c1 = corners[:, None].expand(k, k, 4, 2).reshape(-1, 4, 2).contiguous()
    c2 = corners[None, :].expand(k, k, 4, 2).reshape(-1, 4, 2).contiguous()
    got = clip_kernel.rect_intersection_area(c1, c2)
    ref = iou_ops.rect_intersection_area_plain(c1, c2)
    torch.cuda.synchronize()
    assert_same_bits('rect_clip paired vs its plain version', got, ref)
    n = c1.shape[0]

    def run():
        return clip_kernel.rect_intersection_area(c1, c2)
    return clip_row(
        'rect_clip', CLIP_REPLACES, f'paired, {n} pairs float32',
        time_ms(run, SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: iou_ops.rect_intersection_area_plain(c1, c2), 20),
        nbytes(c1, c2, got), n * CLIP_FLOPS,
        launch_bound_ms=time_ms(run, SMALL_REPS))


# The clip's backward per pair: the forward again (CLIP_FLOPS), then per
# edge and slot ~37 operations of the reverse sweep (the crossing's and the
# edge distance's adjoints, the routing adds) and 8 per slot for the
# shoelace's adjoint.
CLIP_GRAD_FLOPS = CLIP_FLOPS + 4 * 8 * 37 + 8 * 8
CLIP_GRAD_REPLACES = ('imvoxelnet_tpu/ops/iou_pallas.py:189 (backward; the '
                      'JAX package differentiates its jnp clip, '
                      'imvoxelnet_tpu/ops/iou.py:291-307)')


def loss_pairs(rng, n):
    """BEV corners of ``n`` pairs as the v1 IoU-3D loss clips them
    (``bev_corners_loss`` of gravity-center boxes): furniture-sized targets
    with predictions near them, and a share of disjoint (5%), nested (5%)
    and identical (5%) pairs."""
    target = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                             rng.uniform(0.3, 2.5, (n, 2)),
                             rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    pred = target + np.concatenate([0.2 * rng.randn(n, 2),
                                    0.15 * rng.randn(n, 2),
                                    0.3 * rng.randn(n, 1)], -1)
    pred[:, 2:4] = np.abs(pred[:, 2:4]) + 0.05
    k = n // 20
    pred[:k, :2] += 20.0
    pred[k:2 * k] = target[k:2 * k]
    pred[2 * k:3 * k] = target[2 * k:3 * k] * [1, 1, 0.5, 0.5, 1]
    c1, c2 = (box_ops.bev_corners_loss(torch.tensor(
        x.astype(np.float32), device='cuda')).contiguous()
        for x in (pred, target))
    return c1, c2


def zero_pairs(grad):
    """Pairs whose ``(4, 2)`` gradient is exactly zero."""
    return (grad.reshape(grad.shape[0], -1) == 0).all(1)


def stress_area_grad(rng, n):
    """A random area gradient with 20% zeros: 80% of the pairs carry one,
    far more than a training step sends (there only the positives do), so
    that the sweep is checked on every kind of pair."""
    g = torch.tensor(rng.randn(n).astype(np.float32), device='cuda')
    g[torch.tensor(rng.uniform(size=n) < 0.2, device='cuda')] = 0.0
    return g


def clip_grad_vs_autograd(c1, c2, g, label):
    """The clip's backward kernel (through ``RectClipFunction``) against
    autograd of the plain clip on the same CUDA tensors: the areas bit for
    bit, the gradients within 1e-5 x max-abs and exactly zero for the same
    pairs.  Pairs whose area gradient is NaN are live: they must hold a NaN
    where their clipped area is positive, and are left out of the
    comparison (the plain version's masked sums spread a NaN where the
    kernel's selects do not).  Returns the kernel's area and gradients, the
    plain graph's area and leaves, and the comparison's numbers."""
    x1, x2 = c1.clone().requires_grad_(), c2.clone().requires_grad_()
    area = iou_ops.RectClipFunction.apply(x1, x2)
    area.backward(g)
    y1, y2 = c1.clone().requires_grad_(), c2.clone().requires_grad_()
    ref = iou_ops.rect_intersection_area_plain(y1, y2)
    ref.backward(g, retain_graph=True)
    torch.cuda.synchronize()
    assert_same_bits(f'rect_clip paired {label} vs its plain version',
                     area.detach(), ref.detach())
    finite = ~g.isnan()
    swept = ~finite & (area.detach() > 0)
    if not x1.grad[swept].reshape(-1, 8).isnan().any(1).all():
        raise AssertionError(f'rect_clip_grad {label}: a pair with a NaN '
                             f'area gradient was not swept')
    errs, abs_errs, zeros = [], [], {}
    for name, got, want in (('corners1', x1.grad, y1.grad),
                            ('corners2', x2.grad, y2.grad)):
        got, want = got[finite], want[finite]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        errs.append(err / scale if scale > 0 else err)
        abs_errs.append(err)
        if err > 1e-5 * scale:
            raise AssertionError(f'rect_clip_grad {label} {name}: max abs '
                                 f'err {err} > 1e-5 x {scale}')
        zk, zp = zero_pairs(got), zero_pairs(want)
        if not torch.equal(zk, zp):
            raise AssertionError(f'rect_clip_grad {label} {name}: the '
                                 f'exactly-zero pairs differ')
        flips = (got == 0) != (want == 0)
        zeros[name] = dict(zero_pairs=int(zp.sum()),
                           zero_entries_plain=int((want == 0).sum()),
                           entries_zero_in_one_only=int(flips.sum()),
                           their_max_abs=float((got - want)[flips].abs()
                                               .max()) if flips.any()
                           else 0.0)
    again = clip_kernel.rect_intersection_area_grad(c1, c2, g)
    assert_same_bits(f'rect_clip_grad {label}, second launch vs first',
                     torch.stack(again), torch.stack((x1.grad, x2.grad)))
    live = int((~(zero_pairs(y1.grad) & zero_pairs(y2.grad))).sum())
    return area, x1.grad, x2.grad, ref, y1, y2, dict(
        max_abs_err=max(abs_errs), max_err_over_max_abs=max(errs),
        zeros=zeros, nan_area_gradients=int((~finite).sum()),
        pairs_with_a_gradient=live, repeats_bit_for_bit=True)


def live_count(c1, c2, g):
    """The live count that the backward kernel's counter holds after a
    call; it must equal the nonzero (NaN included) area gradients."""
    _, _, n_live = clip_kernel.rect_intersection_area_grad_live(c1, c2, g)
    got, want = int(n_live.item()), int((g != 0).sum())
    if got != want:
        raise AssertionError(f'rect_clip_grad: the kernel counted {got} '
                             f'live pairs, the gradient has {want}')
    return got


def check_rect_clip_grad(c1, c2, g, label, min_live):
    """B2's paired entry and its backward on ``(n, 4, 2)`` corners ``c1``,
    ``c2`` and the area gradient ``g`` (``clip_grad_vs_autograd``); at
    least ``min_live`` pairs must get a gradient.  Returns the forward and
    the backward row, the backward's with the device time of its passes
    and its kernels' ``ptxas`` lines.  The backward's bound counts what
    this input needs: every pair reads its gradient and writes 64 B, and
    only a pair with a nonzero gradient reads its corners and runs the
    sweep (its 8 B in the live list are left out)."""
    n = c1.shape[0]
    area, grad1, grad2, ref, y1, y2, info = clip_grad_vs_autograd(
        c1, c2, g, label)
    if info['pairs_with_a_gradient'] < min_live:
        raise AssertionError(f'rect_clip_grad {label}: only '
                             f'{info["pairs_with_a_gradient"]} pairs with a '
                             f'gradient')
    overlap = float((area > 0).float().mean())

    def fwd():
        return clip_kernel.rect_intersection_area(c1, c2)

    def bwd():
        return clip_kernel.rect_intersection_area_grad(c1, c2, g)

    def plain_bwd():
        return torch.autograd.grad(ref, (y1, y2), g, retain_graph=True)
    g0 = torch.zeros_like(g)
    n_live_g = int((g != 0).sum())
    fwd_row = clip_row(
        'rect_clip', CLIP_REPLACES, f'paired, {label}, {n} pairs float32',
        time_ms(fwd, 20), time_ms(
            lambda: iou_ops.rect_intersection_area_plain(c1, c2), 3),
        nbytes(c1, c2, area), n * CLIP_FLOPS, overlapping_share=overlap)
    t_bound, by = bound(nbytes(g, grad1, grad2) + n_live_g * 64,
                        n_live_g * CLIP_GRAD_FLOPS, torch.float32)
    bwd_row = dict(
        name='rect_clip_grad', route='cuda', source=CLIP_SOURCE,
        replaces=CLIP_GRAD_REPLACES,
        shape=f'paired backward, {label}, {n} pairs float32',
        **info, nonzero_area_gradients=n_live_g, nonzero_share=n_live_g / n,
        ms=time_ms(bwd, SMALL_REPS, queue_us=QUEUE_US),
        launch_bound_ms=time_ms(bwd, SMALL_REPS),
        # the same call with no area gradient at all: what the pairs
        # without one cost (the zero pass, and a sweep that finds no work)
        all_zero_gradient_ms=time_ms(
            lambda: clip_kernel.rect_intersection_area_grad(c1, c2, g0),
            SMALL_REPS, queue_us=QUEUE_US),
        pass_ms=device_ms_by_name(bwd, CLIP_GRAD_PASSES),
        live_count=live_count(c1, c2, g),
        plain_ms=time_ms(plain_bwd, 3),
        plain='autograd of rect_intersection_area_plain (backward only)',
        bound_ms=t_bound, bound_by=by, live_list_bytes=8 * n_live_g,
        library_ms=None, ptxas=clip_grad_ptxas())
    del ref, y1, y2
    return fwd_row, bwd_row


def check_rect_clip_grad_cases(rng):
    """The backward kernel on the inputs a step does not send: every area
    gradient nonzero, none, NaN at known pairs, and 1 and 129 pairs; each
    against autograd of the plain clip (``clip_grad_vs_autograd``), with
    the kernels' live count."""
    n = 116800
    c1, c2 = loss_pairs(rng, n)
    g = stress_area_grad(rng, n)
    nan_g = g.clone()
    nan_g[7::97] = float('nan')
    cases = {'100% live': (c1, c2, torch.where(g == 0, 0.5, g)),
             'all-zero gradient': (c1, c2, torch.zeros_like(g)),
             'NaN at every 97th pair': (c1, c2, nan_g)}
    # 400 pairs: 0-19 disjoint, 20-39 identical, 40-59 nested, then plain
    c1s, c2s = loss_pairs(rng, 400)
    for m, first in ((1, 100), (129, 10)):
        cases[f'n={m}'] = (c1s[first:first + m], c2s[first:first + m],
                           torch.tensor(rng.randn(m).astype(np.float32),
                                        device='cuda'))
    out = {}
    for label, (a, b, grad) in cases.items():
        *_, info = clip_grad_vs_autograd(a, b, grad, label)
        out[label] = dict(pairs=a.shape[0], live_count=live_count(a, b, grad),
                          ms=time_ms(lambda: clip_kernel.
                                     rect_intersection_area_grad(a, b, grad),
                                     SMALL_REPS, queue_us=QUEUE_US), **info)
    return out


def ptxas_functions(log):
    """Per kernel of a ``ptxas -v`` log: registers, stack frame and spill
    bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and cur:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r'Compiling entry function \'(\S+)\'', line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
        m = re.search(r'Used (\d+) registers', line)
        if m and cur:
            out[cur]['registers'] = int(m.group(1))
    return out


CLIP_GRAD_KERNELS = ('rect_clip_grad_zero_kernel',
                     'rect_clip_grad_sweep_kernel')
CLIP_GRAD_PASSES = CLIP_GRAD_KERNELS + ('Memset',)


def clip_grad_ptxas():
    """The ``ptxas -v`` lines of the backward's two kernels (when this run
    built the library): registers, and no stack frame and no spills."""
    log = build.ptxas_log.get('rect_clip')
    if log is None:
        return None
    out = {}
    for fn, info in ptxas_functions(log).items():
        for name in CLIP_GRAD_KERNELS:
            if name in fn:
                if info.get('stack', 1) or info.get('spill_stores', 1) or \
                        info.get('spill_loads', 1):
                    raise AssertionError(f'rect_clip: {name}: {info}')
                out[name] = info
    if len(out) != len(CLIP_GRAD_KERNELS):
        raise AssertionError(f'rect_clip: ptxas lines for {sorted(out)} '
                             f'only')
    return out


def check_rect_clip_pairwise(g, n, rng):
    """The pairwise entry: every box of a group against every box of it."""
    corners = box_ops.bev_corners(car_boxes(rng, g, n)).contiguous()
    got = clip_kernel.rect_intersection_area_pairwise(corners, corners)
    ref = iou_ops.rect_intersection_area_pairwise_plain(corners, corners)
    torch.cuda.synchronize()
    assert_same_bits(f'rect_clip pairwise G={g} N={n} vs its plain version',
                     got, ref)
    if not (0 < float((got > 0).float().mean()) < 1):
        raise AssertionError('rect_clip pairwise: degenerate test boxes')
    def run():
        return clip_kernel.rect_intersection_area_pairwise(corners, corners)
    ms = time_ms(run, SMALL_REPS, queue_us=QUEUE_US)
    return clip_row(
        'rect_clip', CLIP_REPLACES,
        f'pairwise, G={g} N=M={n}, {g * n * n} pairs float32', ms,
        time_ms(lambda: iou_ops.rect_intersection_area_pairwise_plain(
            corners, corners), 5),
        nbytes(corners, corners, got), g * n * n * CLIP_FLOPS,
        launch_bound_ms=time_ms(run, SMALL_REPS),
        ns_per_pair=ms * 1e6 / (g * n * n),
        overlapping_share=float((got > 0).float().mean()))


def check_nms_kernels(g, n, iou_thr, rng, plain_reps=20):
    """The fused mask entry and the scan kernel at a main path's shape
    (b=8 KITTI: 8 samples x 1 class, nms_pre = 100; b=8 SUN RGB-D: 8
    samples x 10 or 30 classes, pre_nms_k = 256), against their plain
    versions and against the fixpoint NMS on the plain IoU."""
    boxes = car_boxes(rng, g, n)
    valid = torch.tensor(rng.uniform(0, 1, (g, n)) > 0.1, device='cuda')
    corners = box_ops.bev_corners(boxes).contiguous()
    areas = (boxes[..., 2] * boxes[..., 3]).contiguous()
    mask = clip_kernel.nms_dominance_mask(corners, areas, iou_thr)
    keep = clip_kernel.nms_scan(mask, valid)
    ref_mask = iou_ops.nms_dominance_mask_plain(corners, areas, iou_thr)
    ref_iou = iou_ops.iou_from_overlaps(
        iou_ops.rect_intersection_area_pairwise_plain(corners, corners),
        areas, areas)
    ref_keep = nms_ops.greedy_nms_from_iou_batched(
        ref_iou, areas, valid, iou_thr, presorted=True)
    torch.cuda.synchronize()
    if not torch.equal(mask, ref_mask):
        raise AssertionError('nms mask: differs from the plain version')
    if not torch.equal(keep, nms_ops.nms_scan_plain(mask, valid)):
        raise AssertionError('nms scan: differs from the plain version')
    if not torch.equal(keep, ref_keep):
        raise AssertionError('nms mask + scan: keep differs from the '
                             'fixpoint NMS on the plain IoU')
    n_keep = int(keep.sum())
    if not 0 < n_keep < int(valid.sum()):
        raise AssertionError('nms: the test boxes suppress nothing')

    def fixpoint():
        iou = iou_ops.iou_from_overlaps(
            iou_ops.rect_intersection_area_pairwise_plain(corners, corners),
            areas, areas)
        return nms_ops.greedy_nms_from_iou_batched(iou, areas, valid,
                                                   iou_thr, presorted=True)
    shape = f'G={g} N={n} float32'
    # only pairs with i < j are needed
    def run_mask():
        return clip_kernel.nms_dominance_mask(corners, areas, iou_thr)

    def run_scan():
        return clip_kernel.nms_scan(mask, valid)
    mask_row = clip_row(
        'rect_clip', CLIP_REPLACES, f'nms mask, {shape}',
        time_ms(run_mask, SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: iou_ops.nms_dominance_mask_plain(corners, areas,
                                                         iou_thr), plain_reps),
        nbytes(corners, areas, mask),
        g * n * (n - 1) // 2 * (CLIP_FLOPS + 4),
        launch_bound_ms=time_ms(run_mask, SMALL_REPS))
    scan_row = clip_row(
        'nms_scan', 'imvoxelnet_tpu/ops/nms.py:75', f'nms scan, {shape}',
        time_ms(run_scan, SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: nms_ops.nms_scan_plain(mask, valid),
                min(5, plain_reps)),
        nbytes(mask, valid, keep), 0,
        launch_bound_ms=time_ms(run_scan, SMALL_REPS),
        note='no Pallas counterpart: the JAX package runs the greedy step '
             'as a lax.while_loop fixpoint', kept=n_keep,
        fixpoint_nms_ms=time_ms(fixpoint, min(5, plain_reps)))
    return mask_row, scan_row


def check_conv3x3x3(b, dtype, tol, rng, dx=False, volume=(216, 248, 12),
                    name='imvoxelnet_kitti'):
    """B3 at the block0 shape of preset ``name`` (``volume``, KITTI's by
    default), with the tiling the kernel picks for it.  ``dx``: the input
    gradient of the training step, the same kernel on the output gradient
    with the transposed kernel; its library call is
    ``aten.convolution_backward`` asked for the input gradient alone."""
    (nx, ny, nz), c = volume, 64
    plan = conv_kernel.tile_plan(nx, ny, nz)
    x = torch.tensor(rng.randn(b, nx, ny, nz, c).astype(np.float32),
                     device='cuda').to(dtype)
    w = torch.tensor((rng.randn(3, 3, 3, c, c) / np.sqrt(27 * c))
                     .astype(np.float32), device='cuda').to(dtype)
    w_run = conv3z.transpose_kernel(w) if dx else w
    got = conv_kernel.conv3x3x3(x, w_run)
    ref = conv3z.conv3x3x3_plain(x, w_run)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    x_ncdhw = x.permute(0, 4, 1, 2, 3)           # channels_last_3d memory
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    if dx:
        def library():
            return torch.ops.aten.convolution_backward(
                x_ncdhw, x_ncdhw, w_oidhw, None, [1, 1, 1], [1, 1, 1],
                [1, 1, 1], False, [0, 0, 0], 1, [True, False, False])[0]
    else:
        def library():
            return F.conv3d(x_ncdhw, w_oidhw, padding=1)
    n_flops = 2 * b * nx * ny * nz * 27 * c * c
    t_bound, by = bound(nbytes(x, w, got), n_flops, dtype)
    extra = {}
    if dtype == torch.float32:
        # both float32 convs against one in float64: how far each is from
        # the exact result
        exact = conv3z.conv3x3x3_plain(x.double(), w_run.double())
        extra = dict(max_abs_err_vs_float64=(got - exact).abs().max().item(),
                     library_max_abs_err_vs_float64=(
                         ref - exact).abs().max().item())
        del exact
    reps = 10
    ms = time_ms(lambda: conv_kernel.conv3x3x3(x, w_run), reps)
    what = 'dx: output gradient' if dx else 'x'
    return dict(
        name='conv3x3x3', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/conv3x3x3.cu',
        replaces='imvoxelnet_tpu/ops/conv3z_pallas.py:91',
        shape=f'{name} block0 b={b} {str(dtype)[6:]} {what} '
              f'{tuple(x.shape)}',
        tile=[plan.tx, plan.ty], grid=list(plan.grid),
        smem_bytes=plan.smem_bytes,
        max_abs_err=err, ms=ms, tflops=n_flops / (ms * 1e-3) / 1e12,
        plain_ms=time_ms(lambda: conv3z.conv3x3x3_plain(x, w_run), reps),
        bound_ms=t_bound, bound_by=by, library_ms=time_ms(library, reps),
        library_call=('aten.convolution_backward, input gradient only'
                      if dx else 'F.conv3d'), **extra)


GRAD_PASSES = ('grad_count_kernel', 'grad_scan_kernel', 'grad_fill_kernel',
               'grad_sum_kernel', 'Memset')


def device_ms_by_name(fn, names, reps=5):
    """Device milliseconds per call of ``fn`` for each kernel whose name
    holds one of ``names``, from ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key and ev.self_device_time_total > 0:
                out[n] = out.get(n, 0.0) + \
                    ev.self_device_time_total / 1e3 / reps
    return out


def segment_histogram(segments):
    """How the pixel rows' reads spread over segments (voxels that read one
    pixel row): percentiles of the segment lengths, and the share of the
    reads in segments longer than 64 and than 160 (the sum pass ranks up to
    160 entries in shared memory, longer ones with shuffles)."""
    seg = segments[segments > 0].double()
    reads = seg.sum()
    q = torch.quantile(seg, torch.tensor([0.5, 0.9, 0.99],
                                         dtype=torch.float64, device='cuda'))
    return dict(median=float(q[0]), p90=float(q[1]), p99=float(q[2]),
                longest=int(seg.max()),
                reads_in_segments_over_64=float(seg[seg > 64].sum() / reads),
                reads_in_segments_over_160=float(seg[seg > 160].sum()
                                                 / reads))


def check_backproject_grad(b, dtype, rng, name='imvoxelnet_kitti'):
    """The backward kernel at the training shapes of preset ``name`` (its
    padded train size and training views): bit for bit against its plain
    version run on CPU copies, two launches bit-identical, with the device
    time of each of its passes, the histogram of its segment lengths, and
    the library time of ``index_add_`` over the forward's precomputed
    pixels."""
    preset = get_preset(name)
    cfg, size = preset.model, preset.data.train_size
    batch = train_batch(preset.data, b, 'cuda', seed=SEED)
    hf, wf, c = size[1] // 4, size[0] // 4, cfg.fpn_out_channels
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                           batch['origins']).reshape(b, -1, 3).contiguous()
    proj = bp.compute_projection(batch['intrinsics'], batch['extrinsics'],
                                 batch['ratios']).contiguous()
    hw = (batch['img_shape'] // 4).to(torch.int32)
    p = points.shape[1]
    g = torch.tensor(rng.randn(p, b, c).astype(np.float32),
                     device='cuda').to(dtype)
    got = bp_kernel.backproject_batch_grad(g, points, proj, hw, hf, wf)
    again = bp_kernel.backproject_batch_grad(g, points, proj, hw, hf, wf)
    ref = bp.backproject_batch_grad_plain(g.cpu(), points.cpu(), proj.cpu(),
                                          hw.cpu(), hf, wf)
    torch.cuda.synchronize()
    # (32-bit words of the rows, both dtypes: C is even)
    assert_same_bits(f'backproject_grad b={b} vs its plain version on the '
                     f'CPU', got.cpu(), ref)
    assert_same_bits(f'backproject_grad b={b}, second launch vs first',
                     again, got)
    err = (got.cpu().float() - ref.float()).abs().max().item()

    # the same function as one library call: index_add_ of the float32
    # gradient rows at the forward's pixels (unseen rows to a spare row)
    v = proj.shape[1]
    idx, valid = bp._view_indices(points, proj, hw, hf, wf)     # (B, V, P)
    n_valid = int(valid.sum())
    if not 0 < n_valid < b * v * p:
        raise AssertionError(f'backproject_grad: {n_valid} of {b * v * p} '
                             f'rows seen')
    n_pix = b * v * hf * wf
    base = torch.arange(b * v, device='cuda').reshape(b, v, 1) * (hf * wf)
    flat = torch.where(valid, base + idx, n_pix)
    segments = torch.bincount(flat.reshape(-1), minlength=n_pix + 1)[:-1]
    flat = flat.permute(2, 0, 1).reshape(-1).contiguous()     # (P * B * V,)
    src = g.float()[:, :, None].expand(p, b, v, c).reshape(-1, c)
    table = torch.zeros((n_pix + 1, c), device='cuda')
    lib = torch.zeros_like(table).index_add_(0, flat, src)[:-1]
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(lib.reshape(got.shape), ref.float().cuda(),
                               rtol=tol, atol=tol)
    # per row and view: 3 projections of 6 operations, 2 divides; per seen
    # row C adds; bytes: the gradient rows of the voxels some view sees,
    # each read once, and the whole output written once
    rows_seen = int(valid.any(1).sum())
    n_flops = b * v * p * (18 + 2) + n_valid * c
    t_bound, by = bound(rows_seen * c * g.element_size()
                        + nbytes(points, proj, hw, got), n_flops,
                        torch.float32)
    reps = 10

    def run():
        return bp_kernel.backproject_batch_grad(g, points, proj, hw, hf, wf)
    return dict(
        name='backproject_grad', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/backproject.cu',
        replaces='imvoxelnet_tpu/ops/backproject_pallas.py:155 (backward; '
                 'the JAX package differentiates its XLA gather, '
                 'imvoxelnet_tpu/ops/backproject.py:166)',
        shape=f'{name} training b={b} {str(dtype)[6:]} grad_acc '
              f'{tuple(g.shape)} -> {tuple(got.shape)}', max_abs_err=err,
        views=v,
        bit_identical_to_plain_on_cpu=True, repeats_bit_for_bit=True,
        seen_rows=n_valid, grad_rows_read=rows_seen,
        pixels_read=int((segments > 0).sum()), pixels=int(segments.numel()),
        longest_segment=int(segments.max()),
        mean_segment=n_valid / max(1, int((segments > 0).sum())),
        segment_histogram=segment_histogram(segments),
        ms=time_ms(run, reps),
        pass_ms=device_ms_by_name(run, GRAD_PASSES),
        plain_ms=time_ms(lambda: bp.backproject_batch_grad_plain(
            g, points, proj, hw, hf, wf), 3),
        bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: table.index_add_(0, flat, src), reps),
        library_call='index_add_ of float32 rows, indices precomputed')


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------

@contextlib.contextmanager
def swapped(*patches):
    """Replace ``module.attr`` by ``fn`` for each ``(module, attr, fn)``
    for the duration of the block."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


PLAIN = [(bp, 'backproject_batch', bp.backproject_batch_plain),
         (iou_ops, 'rect_intersection_area',
          iou_ops.rect_intersection_area_plain),
         (iou_ops, 'rect_intersection_area_pairwise',
          iou_ops.rect_intersection_area_pairwise_plain),
         (nms_ops, 'rotated_nms_presorted',
          nms_ops.rotated_nms_presorted_plain),
         (nms_ops, 'aligned_nms_presorted',
          nms_ops.aligned_nms_presorted_plain),
         (necks3d, 'conv3x3x3', conv3z.conv3x3x3_plain)]


def plain_path():
    """Route the model's kernel call sites to their plain versions for the
    duration of the block (a smoke-run comparison device only)."""
    return swapped(*PLAIN)


def forward(m, c, batch, sync_debug='default'):
    """The forward + decode of model ``m`` (config ``c``; with a layout
    head, on the extrinsics it predicts, as the reference serves Total3D).
    ``sync_debug='error'`` makes PyTorch raise if decode + NMS waits for the
    device (an ``.item()``, a ``bool(tensor)``, a copy to the host) between
    the head's output and the result."""
    with torch.no_grad():
        head_outs, valid, *features_2d = m(
            batch, use_predicted_extrinsics=c.layout_head is not None)
        torch.cuda.set_sync_debug_mode(sync_debug)
        try:
            return imvoxelnet_predict(c, head_outs, valid, batch['origins'],
                                      *features_2d), valid
        finally:
            torch.cuda.set_sync_debug_mode('default')


def compare_with_plain_path(tag, model, cfg, batch):
    """One forward + decode through the kernels, one through their plain
    versions (same model, same batch): seen voxels, valid and labels exact,
    boxes and scores within 2e-3.  Returns the kernel path's launch counts
    and a summary."""
    kernels.reset_launch_counts()
    res, seen = forward(model, cfg, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    with plain_path():
        ref, ref_seen = forward(model, cfg, batch)
    torch.cuda.synchronize()
    seen_diff = int((seen != ref_seen).sum())
    log(f'{tag}: {int(seen.sum())} of {seen.numel()} voxels seen '
        f'({float(seen.float().mean()):.4g}); {seen_diff} differ in seen '
        f'between kernel and plain path')
    for key in ('boxes', 'scores'):
        if not torch.isfinite(res[key]).all():
            raise AssertionError(f'{tag}: non-finite {key}')
    if not torch.equal(res['valid'], ref['valid']) or not torch.equal(
            res['labels'], ref['labels']):
        raise AssertionError(f'{tag}: valid/labels differ from the plain '
                             f'path')
    # with a layout head also the predicted angles and room layout
    keys = [k for k in ('boxes', 'scores', 'angles', 'layout') if k in res]
    for key in keys:
        torch.testing.assert_close(res[key], ref[key], rtol=2e-3, atol=2e-3)
    if seen_diff or int(res['valid'].sum()) == 0:
        raise AssertionError(f'{tag}: seen differs at {seen_diff} voxels or '
                             f'no valid detection')
    err = max((res[k] - ref[k]).abs().max().item() for k in keys)
    log(f'{tag}: {int(res["valid"].sum())} detections, max abs err vs '
        f'plain path {err:.3g}')
    return counts, dict(detections=int(res['valid'].sum()),
                        max_abs_err_vs_plain=err,
                        seen_share=float(seen.float().mean()))


def timed_forward(tag, model, cfg, batch, n_iters=3):
    """The forward + decode after a warm-up: once with decode + NMS
    forbidden to wait for the device (launch counts, peak memory), then
    ``n_iters`` times on the host clock, each fetching a score."""
    forward(model, cfg, batch)                  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res, _ = forward(model, cfg, batch, sync_debug='error')
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for key in ('boxes', 'scores'):
        if not torch.isfinite(res[key]).all():
            raise AssertionError(f'{tag}: non-finite {key}')
    if int(res['valid'].sum()) == 0:
        raise AssertionError(f'{tag}: no valid detection')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b = batch['images'].shape[0]
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out, _ = forward(model, cfg, batch)
        out['scores'].sum().item()
    dt = time.perf_counter() - t0
    log(f'{tag}: {int(res["valid"].sum())} detections; '
        f'{b * n_iters / dt:.4g} scenes/s over {n_iters} batches; '
        f'peak memory {peak_gb:.4g} GB')
    return counts, dict(detections=int(res['valid'].sum()),
                        scenes_per_s=b * n_iters / dt,
                        ms_per_batch=dt * 1e3 / n_iters,
                        peak_memory_gb=peak_gb, sync_free_decode=True)


def assert_launches(tag, counts, want):
    if counts != want:
        raise AssertionError(f'{tag}: launch counts {counts} != {want}')


def run_slice():
    cfg = get_preset('imvoxelnet_kitti').model
    model = build_model(cfg, device='cuda', seed=SEED)
    zero_cls_bias(model)
    counts = {}

    # --- b=1 float32, kernel path vs plain path on the card
    counts['b1_f32'], _ = compare_with_plain_path(
        'b=1 float32', model, cfg, kitti_batch(1, 'cuda', seed=SEED))

    # --- b=8 bfloat16 throughput
    cfg16 = dataclasses.replace(cfg, compute_dtype='bfloat16')
    model16 = build_model(cfg16, device='cuda', seed=SEED)
    model16.load_state_dict(model.state_dict())
    counts['b8_bf16'], _ = timed_forward(
        'b=8 bfloat16', model16, cfg16, kitti_batch(8, 'cuda', seed=SEED + 1))

    want = {'backproject': 1, 'backproject_grad': 0, 'conv3x3x3': 2,
            'rect_clip': 1, 'rect_clip_grad': 0, 'nms_scan': 1}
    for name, c in counts.items():
        assert_launches(name, c, want)
    log(f'launch counts per forward: {json.dumps(counts)}')
    return counts


# --------------------------------------------------------------------------
# phase 4: training
# --------------------------------------------------------------------------

# a conv's bias right before a batch-statistics BN has a true gradient of 0:
# both paths give float noise there
BIASES_BEFORE_BN = tuple(f'neck_3d.model.{i}.0.bias' for i in (1, 3, 5))
MUST_LEARN = ('backbone.layer2.0.conv1.weight',
              'backbone.layer2.3.conv3.weight',
              'neck.lateral_convs.0.conv.weight',
              'neck.fpn_convs.0.conv.weight',
              'neck_3d.model.0.conv1.weight', 'neck_3d.model.0.conv2.weight')
TRAIN_STEPS = 5


def trainer(model, preset):
    """``make_train_step`` with the preset's optimizer (an epoch of 1000
    steps: the LR keeps its first value); ``grads`` holds copies of the first
    step's gradients as the optimizer receives them, before its clip."""
    opt, sched = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch=1000, lr_steps=preset.lr_steps)
    grads = {}
    names = {p: n for n, p in model.named_parameters()}

    def snapshot(optimizer, args, kwargs):
        if grads:       # a pre-hook may run again inside the parent's step
            return
        for group in optimizer.param_groups:
            for p in group['params']:
                grads[names[p]] = p.grad.detach().clone()
    opt.register_step_pre_hook(snapshot)
    return train_lib.make_train_step(model, opt, sched), grads


def bn_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith('neck_3d.') and k.endswith(('running_mean',
                                                        'running_var'))}


class B3PlainForward(conv3z.Conv3x3x3Function):
    """B3 with its forward as ``F.conv3d`` and its ``dx`` through the
    kernel."""

    @staticmethod
    def forward(ctx, x, kernel, plain=False):
        ctx.save_for_backward(x, kernel)
        ctx.conv = conv_kernel.conv3x3x3
        return conv3z.conv3x3x3_plain(x, kernel)


class B3PlainDx(conv3z.Conv3x3x3Function):
    """B3 with its forward through the kernel and its ``dx`` as
    ``F.conv3d``."""

    @staticmethod
    def forward(ctx, x, kernel, plain=False):
        ctx.save_for_backward(x, kernel)
        ctx.conv = conv3z.conv3x3x3_plain
        return conv_kernel.conv3x3x3(x, kernel)


class B1PlainBackward(bp.BackprojectFunction):
    """B1 with its forward through the kernel and its backward as the plain
    ``index_add_``."""

    @staticmethod
    def forward(ctx, features, points, projections, valid_hw, plain=False):
        out = bp.BackprojectFunction.forward(ctx, features, points,
                                             projections, valid_hw)
        ctx.plain = True
        return out


def conv_with(fn):
    return lambda x, k: fn.apply(x.contiguous(), k.contiguous())


def backproject_with(fn):
    return lambda f, pts, pj, hw: fn.apply(
        f.contiguous(), pts.float().contiguous(), pj.float().contiguous(),
        hw.to(torch.int32).contiguous())


# one kernel at a time swapped for its plain version (the C2 study)
SWAPS = {
    'B3 forward plain': [(necks3d, 'conv3x3x3', conv_with(B3PlainForward))],
    'B3 dx plain': [(necks3d, 'conv3x3x3', conv_with(B3PlainDx))],
    'B1 backward plain': [(bp, 'backproject_batch',
                           backproject_with(B1PlainBackward))],
}
GAP_WATCH = 'neck_3d.model.4.conv1.weight'


def first_grads(model, cfg, batch):
    """The trainable gradients of one training step of ``model`` from zero
    gradients (train-mode forward, losses, backward; the optimizer's
    freezing), at ``cfg``'s precision, as float64 copies."""
    for name, prm in model.named_parameters():
        prm.requires_grad_(train_lib.param_label(name) != 'frozen')
        prm.grad = None
    with compute_precision(cfg.compute_dtype):
        model.train()
        head_outs, _ = model(batch)
        sum(imvoxelnet_loss(cfg, head_outs, batch).values()).backward()
    return {n: (torch.zeros_like(prm) if prm.grad is None else prm.grad)
            .detach().double() for n, prm in model.named_parameters()
            if prm.requires_grad}


def grad_gap(got, ref):
    """Worst max-abs gap over max-abs of ``ref`` across the gradients
    (the conv biases before a batch-statistics BN, true gradient 0, left
    out), its parameter, and the gap on ``GAP_WATCH``."""
    gaps = {}
    for name, r in ref.items():
        if name in BIASES_BEFORE_BN:
            continue
        scale = r.abs().max().item()
        gaps[name] = ((got[name].double() - r.double()).abs().max().item()
                      / scale if scale > 0 else 0.0)
    worst = max(gaps, key=gaps.get)
    return dict(worst=gaps[worst], worst_grad=worst,
                watched=gaps[GAP_WATCH])


def gradient_gap_study(pristine, cfg, batch, grads, plain_grads):
    """Where the b=1 float32 gap between the kernel path and the plain path
    comes from: each kernel swapped alone for its plain version, a second
    kernel-path step, and a float64 step of the plain path as the
    reference that both paths are measured against."""
    kernel_path = {k: v.double() for k, v in grads.items()}
    plain = {k: v.double() for k, v in plain_grads.items()}
    out = {'kernel path': dict(vs_plain=grad_gap(kernel_path, plain))}
    runs = {'kernel path again': []}
    runs.update(SWAPS)
    for tag, patches in runs.items():
        with swapped(*patches):
            g = first_grads(copy.deepcopy(pristine), cfg, batch)
        out[tag] = dict(vs_plain=grad_gap(g, plain),
                        vs_kernel_path=grad_gap(g, kernel_path))
        del g
    cfg64 = dataclasses.replace(cfg, compute_dtype='float64')
    model64 = build_model(cfg64, device='cuda', seed=SEED)
    model64.load_state_dict(pristine.state_dict())
    model64.double()
    with plain_path():
        exact = first_grads(model64, cfg64, batch)
    del model64
    out['kernel path']['vs_float64'] = grad_gap(kernel_path, exact)
    out['plain path'] = dict(vs_float64=grad_gap(plain, exact))
    for tag, res in out.items():
        log(f'train b=1 float32 gradient gap, {tag}: ' + ', '.join(
            f'{k} worst {v["worst"]:.3g} ({v["worst_grad"]}), '
            f'{GAP_WATCH} {v["watched"]:.3g}' for k, v in res.items()))
    return out


def repeat_count(pristine, preset, batch):
    """Two b=1 float32 training steps of the kernel path from one state
    with ``cudnn.deterministic`` set: every gradient must repeat bit for
    bit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            step, grads = trainer(copy.deepcopy(pristine), preset)
            step(batch)
            runs.append(grads)
    finally:
        torch.backends.cudnn.deterministic = saved
    same = [n for n, g in runs[0].items() if torch.equal(
        g.view(torch.int32), runs[1][n].view(torch.int32))]
    differing = sorted(set(runs[0]) - set(same))
    log(f'train b=1 float32, cudnn.deterministic: {len(same)} of '
        f'{len(runs[0])} gradients repeat bit for bit')
    if differing:
        raise AssertionError(f'train b=1 float32: gradients differ between '
                             f'two steps from one state: {differing}')
    return dict(repeated=len(same), gradients=len(runs[0]))


def run_train():
    preset = get_preset('imvoxelnet_kitti')
    cfg = preset.model
    out = {}

    # --- b=1 float32: one step through the kernels and one through the
    # plain versions (forward and backward), from the same weights
    model = build_model(cfg, device='cuda', seed=SEED)
    pristine = copy.deepcopy(model)
    plain_model = copy.deepcopy(model)
    step, grads = trainer(model, preset)
    plain_step, plain_grads = trainer(plain_model, preset)
    batch1 = kitti_train_batch(1, 'cuda', seed=SEED,
                               size=preset.data.train_size)
    kernels.reset_launch_counts()
    metrics = step(batch1)
    torch.cuda.synchronize()
    counts_b1 = kernels.launch_counts()
    with plain_path():
        plain_metrics = plain_step(batch1)
    torch.cuda.synchronize()
    if any(counts_b1[k] != v for k, v in (('backproject', 1),
                                           ('backproject_grad', 1),
                                           ('conv3x3x3', 4))):
        raise AssertionError(f'b=1 train step: launch counts {counts_b1}')
    loss_err = {k: abs(float(metrics[k]) - float(plain_metrics[k]))
                for k in metrics}
    for k in metrics:
        torch.testing.assert_close(metrics[k], plain_metrics[k], rtol=2e-3,
                                   atol=2e-3)
    if not float(metrics['loss_bbox']) > 0:
        raise AssertionError('b=1 train step: no positive anchor')
    worst, worst_name = 0.0, None
    for name, ref in plain_grads.items():
        got = grads[name]
        if name in BIASES_BEFORE_BN:
            scale = plain_grads[name.replace('bias', 'weight')].abs().max()
            if max(got.abs().max(), ref.abs().max()) > 1e-4 * scale:
                raise AssertionError(f'{name}: gradient not noise-sized')
            continue
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2 * scale,
                                   msg=lambda m: f'{name}: {m}')
        err = (got - ref).abs().max().item() / scale if scale > 0 else 0.0
        if err > worst:
            worst, worst_name = err, name
    for name in MUST_LEARN:
        if not float(grads[name].abs().max()) > 0:
            raise AssertionError(f'{name}: zero gradient on the kernel path')
    stats, plain_stats = bn_stats(model), bn_stats(plain_model)
    stats_err = 0.0
    for key, ref in plain_stats.items():
        torch.testing.assert_close(stats[key], ref, rtol=2e-3, atol=2e-3)
        stats_err = max(stats_err, (stats[key] - ref).abs().max().item())
    out['b1_float32_vs_plain'] = dict(
        loss=float(metrics['loss']), loss_abs_err=loss_err,
        grads_compared=len(plain_grads),
        max_grad_err_over_max_abs=worst, worst_grad=worst_name,
        bn_stats_max_abs_err=stats_err,
        launches=counts_b1)
    log(f'train b=1 float32: kernel path == plain path (loss '
        f'{float(metrics["loss"]):.6g}, {len(plain_grads)} gradients within '
        f'{worst:.3g} of their max-abs ({worst_name} the worst), BN stats '
        f'within {stats_err:.3g})')
    del model, plain_model, step, plain_step
    out['b1_float32_gap_study'] = gradient_gap_study(
        pristine, cfg, batch1, grads, plain_grads)
    del grads, plain_grads
    out['b1_float32_repeat'] = repeat_count(pristine, preset, batch1)
    del pristine

    # --- b=4 bfloat16 at the padded train size: throughput
    b = preset.data.samples_per_device
    cfg16 = dataclasses.replace(cfg, compute_dtype='bfloat16')
    model16 = build_model(cfg16, device='cuda', seed=SEED)
    step16, _ = trainer(model16, preset)
    batch = kitti_train_batch(b, 'cuda', seed=SEED + 1,
                              size=preset.data.train_size)
    step16(batch)                               # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step16(batch)['loss'] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f'b={b} train: non-finite loss {losses}')
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
    want = {'backproject': 1, 'backproject_grad': 1, 'conv3x3x3': 4,
            'rect_clip': 0, 'rect_clip_grad': 0, 'nms_scan': 0}
    if per_step != want:
        raise AssertionError(f'b={b} train: launches per step {per_step} '
                             f'!= {want}')

    # --- one step that must not wait for the device (the loss is fetched
    # after it)
    torch.cuda.set_sync_debug_mode('error')
    try:
        metrics = step16(batch)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    if not np.isfinite(float(metrics['loss'])):
        raise AssertionError('train: non-finite loss in the sync-free step')
    out[f'b{b}_bfloat16'] = dict(
        size=list(preset.data.train_size), steps=TRAIN_STEPS,
        losses=losses, steps_per_s=TRAIN_STEPS / dt,
        scenes_per_s=b * TRAIN_STEPS / dt, ms_per_step=dt * 1e3 / TRAIN_STEPS,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, launches_per_step=per_step, sync_free_step=True)
    log(f'train b={b} bfloat16: {TRAIN_STEPS / dt:.4g} steps/s, '
        f'{b * TRAIN_STEPS / dt:.4g} scenes/s, peak memory '
        f'{out[f"b{b}_bfloat16"]["peak_memory_gb"]:.4g} GB, losses {losses}')
    return out, counts


# --------------------------------------------------------------------------
# phase 5: SUN RGB-D serving
# --------------------------------------------------------------------------

INDOOR_PRESETS = ('imvoxelnet_sunrgbd', 'imvoxelnet_sunrgbd_fast',
                  'imvoxelnet_perspective_sunrgbd_fast')
INDOOR_LAUNCHES = {'backproject': 1, 'backproject_grad': 0, 'conv3x3x3': 0,
                   'rect_clip': 1, 'rect_clip_grad': 0, 'nms_scan': 1}


@contextlib.contextmanager
def tied_scores(model):
    """The anchor head's cls weights at zero for the block (its bias is
    zero already): every anchor scores exactly 0.5, so the decode keeps the
    stable top-k's lowest indices and NMS sees them in index order on any
    path; the boxes still come from the model's regression."""
    conv = model.bbox_head.conv_cls
    saved = conv.weight.detach().clone()
    with torch.no_grad():
        conv.weight.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            conv.weight.copy_(saved)


def serve_vs_plain(name, b1, b_timed, launches, tie=False):
    """Preset ``name`` served at full width and depth: ``b1`` (a b=1
    batch) float32 through the kernels against the plain path, then
    ``b_timed`` bfloat16 timed with a decode that must not wait for the
    device; launches per forward asserted at both sizes.  ``tie``: the
    float32 comparison with :func:`tied_scores`, for a decode whose
    random-weight candidates' scores may lie closer together than the
    float32 kernel path's rounding moves them (nuScenes: 1,000 of 48,672
    anchors, against 100 on KITTI)."""
    cfg = get_preset(name).model
    model = build_model(cfg, device='cuda', seed=SEED)
    zero_cls_bias(model)
    level_angle_head(model)
    dcn_offsets(model)
    with tied_scores(model) if tie else contextlib.nullcontext():
        c1, res1 = compare_with_plain_path(f'{name} b=1 float32', model,
                                           cfg, b1)
    cfg16 = dataclasses.replace(cfg, compute_dtype='bfloat16')
    model16 = build_model(cfg16, device='cuda', seed=SEED)
    model16.load_state_dict(model.state_dict())
    del model
    b = b_timed['images'].shape[0]
    c8, res8 = timed_forward(f'{name} b={b} bfloat16', model16, cfg16,
                             b_timed)
    del model16
    for tag, c in (('b1_f32', c1), (f'b{b}_bf16', c8)):
        assert_launches(f'{name} {tag}', c, launches)
    return dict(b1_float32_vs_plain=res1, timed_bfloat16=res8,
                launches_b1=c1, launches_timed=c8), c8


def run_indoor():
    """Each indoor preset at full width and depth: b=1 float32 kernel path
    against the plain path, b=8 bfloat16 timed; launches per forward
    asserted at both sizes (B3's gate keeps it off these volumes)."""
    out, counts = {}, {}
    for name in INDOOR_PRESETS:
        out[name], counts[name] = serve_vs_plain(
            name, sunrgbd_batch(1, 'cuda', seed=SEED),
            sunrgbd_batch(8, 'cuda', seed=SEED + 1), INDOOR_LAUNCHES)
    log(f'indoor launch counts per forward: {json.dumps(counts)}')
    return out, counts


# --------------------------------------------------------------------------
# phase 6: SUN RGB-D training
# --------------------------------------------------------------------------

INDOOR_TRAIN_PRESETS = ('imvoxelnet_sunrgbd', 'imvoxelnet_sunrgbd_fast')
INDOOR_TRAIN_LAUNCHES = {'backproject': 1, 'backproject_grad': 1,
                         'conv3x3x3': 0, 'rect_clip': 1, 'rect_clip_grad': 1,
                         'nms_scan': 0}
# the other SUN RGB-D presets that train: one b=4 bfloat16 step each
INDOOR_TRAIN_OTHERS = ('imvoxelnet_sunrgbd_top27',
                       'imvoxelnet_perspective_sunrgbd',
                       'imvoxelnet_perspective_sunrgbd_top27',
                       'imvoxelnet_perspective_sunrgbd_fast')
INDOOR_MUST_LEARN = ('backbone.layer2.0.conv1.weight',
                     'neck.lateral_convs.0.conv.weight',
                     'bbox_head.centerness_conv.weight',
                     'bbox_head.reg_conv.weight', 'bbox_head.cls_conv.weight')


def biases_before_bn(model):
    """The biases of the convs that feed a batch-statistics BN directly:
    their true gradient is 0, and both paths give float noise there."""
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            for (i, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(b, torch.nn.BatchNorm3d) and getattr(
                        a, 'bias', None) is not None:
                    out.add(f'{name}.{i}.bias')
    return out


def positives_per_level(model, cfg, batch):
    """``(B, levels)`` positive counts of the indoor targets on ``batch``
    (labels >= 0 on voxels the camera sees), as the loss finds them; for
    the anchor head ``(B, 1)``, the anchors its assigner makes positive."""
    if cfg.head_kind == 'anchor3d':
        hc = cfg.anchor_head
        with torch.no_grad():
            cls_score = model(batch)[0][0]
            anchors = a3d.head_anchors(cls_score.shape[1:3], hc,
                                       device=cls_score.device)
            targets = target_assign.anchor_targets(
                anchors, batch['gt_boxes'], batch['gt_labels'],
                batch['gt_mask'], hc.assigner, hc.num_classes, hc.dir_offset)
        return targets['n_pos'][:, None].cpu()
    hc = cfg.indoor_head
    with torch.no_grad():
        head_outs, valid = model(batch)[:2]
        sizes = [tuple(x.shape[1:4]) for x in head_outs[0]]
        b = valid.shape[0]
        flat_valid = torch.cat([v.reshape(b, -1) for v in
                                ivh.resize_valid_to_levels(valid, sizes)], 1)
        scales, rr = ivh._level_constants(
            [x * y * z for x, y, z in sizes], hc.regress_ranges, 'cuda')
        points = torch.cat(ivh.mlvl_points(sizes, hc.voxel_size,
                                           batch['origins']), 1)
        _, _, labels = ivh.indoor_targets(
            points, scales, rr, batch['gt_boxes'], batch['gt_labels'],
            batch['gt_mask'], hc)
        pos = (labels >= 0) & flat_valid
        return torch.stack([pos[:, scales == i].sum(1)
                            for i in range(hc.n_scales)], 1).cpu()


@contextlib.contextmanager
def clip_grad_probe(seen):
    """Record copies of the corners and the area gradient that reach the
    clip's backward kernel, ``(c1, c2, grad_areas)`` in ``seen``."""
    wrapped = clip_kernel.rect_intersection_area_grad

    def probe(c1, c2, grad_areas):
        seen.append((c1.clone(), c2.clone(), grad_areas.clone()))
        return wrapped(c1, c2, grad_areas)
    with swapped((clip_kernel, 'rect_intersection_area_grad', probe)):
        yield


def train_vs_plain(name, launches, must_learn):
    """One b=1 float32 training step of preset ``name`` through the kernels
    against one through the plain path, from the same weights and batch:
    positives on every level, the launches, the losses (2e-3), every
    gradient (2e-2 x its max-abs; the conv biases before a batch-statistics
    BN are float noise in both), the neck's BN statistics (2e-3), a nonzero
    gradient into ``must_learn``; where the box loss clips, a nonzero area
    gradient into the clip."""
    preset = get_preset(name)
    cfg = preset.model
    model = build_model(cfg, device='cuda', seed=SEED)
    dcn_offsets(model)
    noise = biases_before_bn(model)
    batch1 = train_batch(preset.data, 1, 'cuda', seed=SEED,
                         layout=cfg.layout_head is not None)
    pos = positives_per_level(model, cfg, batch1)
    if not bool((pos > 0).all()):
        raise AssertionError(f'{name} b=1: a level without positives '
                             f'{pos.tolist()}')
    plain_model = copy.deepcopy(model)
    step, grads = trainer(model, preset)
    plain_step, plain_grads = trainer(plain_model, preset)
    seen = []
    kernels.reset_launch_counts()
    with clip_grad_probe(seen):
        metrics = step(batch1)
    torch.cuda.synchronize()
    counts_b1 = kernels.launch_counts()
    with plain_path():
        plain_metrics = plain_step(batch1)
    torch.cuda.synchronize()
    assert_launches(f'{name} b=1 train step', counts_b1, launches)
    # (the detections' IoU-3D loss clips the most pairs; with a layout
    # head the layout loss clips one a sample)
    clip_grad_max = (float(max(seen, key=lambda t: t[2].numel())[2].abs()
                           .max()) if seen else None)
    if not float(metrics['loss_bbox']) > 0 or (
            launches['rect_clip_grad'] and not (clip_grad_max or 0) > 0):
        raise AssertionError(f'{name}: the box loss sends no gradient '
                             f'({metrics["loss_bbox"]}, clip {clip_grad_max})')
    loss_err = {k: abs(float(metrics[k]) - float(plain_metrics[k]))
                for k in metrics}
    gaps = {}
    for gname, ref in plain_grads.items():
        got = grads[gname]
        if gname in noise:
            scale = plain_grads[gname.replace('bias', 'weight')].abs(
                ).max().item()
            gaps[gname] = max(got.abs().max().item(),
                              ref.abs().max().item()) / scale
            continue
        scale = ref.abs().max().item()
        gaps[gname] = ((got - ref).abs().max().item() / scale
                       if scale > 0 else 0.0)
    noise_gap = max((gaps[k] for k in noise), default=0.0)
    worst = max((k for k in gaps if k not in noise), key=gaps.get)
    stats, plain_stats = bn_stats(model), bn_stats(plain_model)
    stats_err = max((stats[k] - v).abs().max().item()
                    for k, v in plain_stats.items())
    log(f'{name} train b=1 float32: loss {float(metrics["loss"]):.6g} '
        f'(kernel - plain: {json.dumps(loss_err)}); worst gradient gap '
        f'{gaps[worst]:.3g} of max-abs on {worst}; conv biases before '
        f'BN {noise_gap:.3g} of their weight gradient; BN stats within '
        f'{stats_err:.3g}; largest area gradient at the clip '
        f'{clip_grad_max}; positives per level {pos.tolist()}')
    for k in metrics:
        torch.testing.assert_close(metrics[k], plain_metrics[k],
                                   rtol=2e-3, atol=2e-3)
    for k, v in plain_stats.items():
        torch.testing.assert_close(stats[k], v, rtol=2e-3, atol=2e-3)
    if gaps[worst] > 2e-2 or noise_gap > 1e-4:
        raise AssertionError(f'{name}: gradient gap {gaps[worst]} on '
                             f'{worst} (bias noise {noise_gap})')
    for gname in must_learn:
        if not float(grads[gname].abs().max()) > 0:
            raise AssertionError(f'{gname}: zero gradient')
    extra = {}
    dcn = dcn_parameters(model)
    if dcn:
        extra['dcn_grad_gaps'] = {k: gaps[k] for k in dcn}
        log(f'{name} train b=1 float32: DCN gradient gaps (of max-abs) '
            f'{json.dumps(extra["dcn_grad_gaps"])}')
    return dict(
        loss=float(metrics['loss']), loss_abs_err=loss_err,
        grads_compared=len(plain_grads), max_grad_err_over_max_abs=
        gaps[worst], worst_grad=worst, bias_before_bn_noise=noise_gap,
        bn_stats_max_abs_err=stats_err, positives_per_level=pos.tolist(),
        clip_grad_max=clip_grad_max, launches=counts_b1, **extra)


def dcn_parameters(model):
    """The names of the parameters of ``model``'s DCNs: each one's kernel
    and its ``conv_offset``'s weight and bias."""
    return [f'{m}.{p}' for m, mod in model.named_modules()
            if isinstance(mod, DeformConv2d)
            for p, _ in mod.named_parameters()]


def timed_steps(name, launches):
    """The preset's batch per card (``samples_per_device``) at its padded
    train size in bfloat16: a warm-up step, whose clip-backward inputs are
    recorded, then ``TRAIN_STEPS`` pipelined steps with their launch counts
    and peak memory, then one step that must not wait for the device.
    Returns the results, the timed steps' launches and the recorded clip
    inputs (the first call's, with the batch's positive count)."""
    preset = get_preset(name)
    b = preset.data.samples_per_device
    cfg16 = dataclasses.replace(preset.model, compute_dtype='bfloat16')
    model16 = build_model(cfg16, device='cuda', seed=SEED)
    dcn_offsets(model16)
    step16, _ = trainer(model16, preset)
    batch = train_batch(preset.data, b, 'cuda', seed=SEED + 1,
                        layout=cfg16.layout_head is not None)
    pos4 = positives_per_level(model16, cfg16, batch)
    if not bool((pos4 > 0).all()):
        raise AssertionError(f'{name} b={b}: a level without positives '
                             f'{pos4.tolist()}')
    seen = []
    with clip_grad_probe(seen):
        step16(batch)                           # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    clip_input = seen[0] + (int(pos4.sum()),) if seen else None
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses = [step16(batch)['loss'] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = kernels.launch_counts()
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f'{name} b={b} train: non-finite loss '
                             f'{losses}')
    per_step = {k: v / TRAIN_STEPS for k, v in c.items()}
    assert_launches(f'{name} b={b} train, per step', per_step, launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.set_sync_debug_mode('error')
    try:
        metrics = step16(batch)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    if not np.isfinite(float(metrics['loss'])):
        raise AssertionError(f'{name}: non-finite loss in the sync-free '
                             f'step')
    views = batch['images'].shape[1]
    log(f'{name} train b={b} bfloat16 ({views} view(s)): '
        f'{TRAIN_STEPS / dt:.4g} steps/s, {b * TRAIN_STEPS / dt:.4g} '
        f'scenes/s, {dt * 1e3 / TRAIN_STEPS:.4g} ms a step, peak memory '
        f'{peak_gb:.4g} GB, losses {losses}')
    del model16, step16, seen
    return dict(
        size=list(preset.data.train_size), views=views, steps=TRAIN_STEPS,
        losses=losses, steps_per_s=TRAIN_STEPS / dt,
        scenes_per_s=b * TRAIN_STEPS / dt,
        ms_per_step=dt * 1e3 / TRAIN_STEPS, peak_memory_gb=peak_gb,
        positives_per_level=pos4.tolist(), launches=c,
        launches_per_step=per_step, sync_free_step=True), c, clip_input


def one_step(name, launches):
    """One bfloat16 training step of an untimed preset at its batch per
    card, with its launch counts; every sample must have positives."""
    preset = get_preset(name)
    cfg16 = dataclasses.replace(preset.model, compute_dtype='bfloat16')
    model16 = build_model(cfg16, device='cuda', seed=SEED)
    step16, _ = trainer(model16, preset)
    b = preset.data.samples_per_device
    batch = train_batch(preset.data, b, 'cuda', seed=SEED + 1,
                        layout=cfg16.layout_head is not None)
    pos4 = positives_per_level(model16, cfg16, batch)
    if not bool((pos4.sum(1) > 0).all()):
        raise AssertionError(f'{name} b={b}: a sample without '
                             f'positives {pos4.tolist()}')
    kernels.reset_launch_counts()
    metrics = {k: float(v) for k, v in step16(batch).items()}
    c = kernels.launch_counts()
    assert_launches(f'{name} b={b} train step', c, launches)
    if not all(np.isfinite(list(metrics.values()))) or not \
            metrics['loss_bbox'] > 0:
        raise AssertionError(f'{name} b={b} train: losses {metrics}')
    log(f'{name} train b={b} bfloat16: one step, losses '
        f'{json.dumps(metrics)}, positives per level {pos4.tolist()}')
    return dict(b4_bfloat16_one_step=dict(
        losses=metrics, positives_per_level=pos4.tolist(), launches=c))


def run_indoor_train():
    """Each indoor training preset at full width and depth: one b=1 float32
    step through the kernels against one through the plain path (same
    weights, same batch), then 5 pipelined b=4 bfloat16 steps at the
    presets' 768x576 with their launch counts, and one step that must not
    wait for the device.  Returns the results, the launches of the timed
    steps and, per preset, the clip backward's inputs in a b=4 step."""
    out, counts, clip_inputs = {}, {}, {}
    for name in INDOOR_TRAIN_PRESETS:
        res = {'b1_float32_vs_plain': train_vs_plain(
            name, INDOOR_TRAIN_LAUNCHES, INDOOR_MUST_LEARN)}
        res['b4_bfloat16'], counts[name], clip_inputs[name] = timed_steps(
            name, INDOOR_TRAIN_LAUNCHES)
        out[name] = res
    for name in INDOOR_TRAIN_OTHERS:
        out[name] = one_step(name, INDOOR_TRAIN_LAUNCHES)
    return out, counts, clip_inputs


# --------------------------------------------------------------------------
# phase 7: Total3D (layout head, predicted extrinsics)
# --------------------------------------------------------------------------

TOTAL3D_PRESETS = ('imvoxelnet_total_sunrgbd', 'imvoxelnet_total_sunrgbd_fast')
TOTAL3D_LAUNCHES = INDOOR_LAUNCHES
# the detections' IoU-3D loss and the layout loss each clip once and take
# the clip's backward once
TOTAL3D_TRAIN_LAUNCHES = dict(INDOOR_TRAIN_LAUNCHES, rect_clip=2,
                              rect_clip_grad=2)
TOTAL3D_MUST_LEARN = INDOOR_MUST_LEARN + ('head_2d.angle_mlp.0.weight',
                                          'head_2d.layout_mlp.6.weight')


def run_total3d():
    """The Total3D presets: serving on predicted extrinsics (b=1 float32
    against the plain path, b=8 bfloat16 timed) and training (b=1 float32
    against the plain path, 5 timed b=4 bfloat16 steps); one step of
    _top27."""
    out, serve_counts, train_counts = {}, {}, {}
    for name in TOTAL3D_PRESETS:
        out[name], serve_counts[name] = serve_vs_plain(
            name, sunrgbd_batch(1, 'cuda', seed=SEED),
            sunrgbd_batch(8, 'cuda', seed=SEED + 1), TOTAL3D_LAUNCHES)
        out[name]['b1_float32_train_vs_plain'] = train_vs_plain(
            name, TOTAL3D_TRAIN_LAUNCHES, TOTAL3D_MUST_LEARN)
        out[name]['b4_bfloat16_train'], train_counts[name], _ = timed_steps(
            name, TOTAL3D_TRAIN_LAUNCHES)
    out['imvoxelnet_total_sunrgbd_top27'] = one_step(
        'imvoxelnet_total_sunrgbd_top27', TOTAL3D_TRAIN_LAUNCHES)
    log(f'total3d launch counts: serving {json.dumps(serve_counts)}, '
        f'training {json.dumps(train_counts)}')
    return out, serve_counts, train_counts


# --------------------------------------------------------------------------
# phase 8: multi-view ScanNet (50 views served, 20 in training)
# --------------------------------------------------------------------------

SCANNET_PRESETS = ('imvoxelnet_scannet', 'imvoxelnet_scannet_fast')
SCANNET_LAUNCHES = dict(INDOOR_LAUNCHES, rect_clip=0)
SCANNET_TRAIN_LAUNCHES = dict(INDOOR_TRAIN_LAUNCHES, rect_clip=0,
                              rect_clip_grad=0)


@contextlib.contextmanager
def scan_probe(seen):
    """Record copies of the mask and the valid rows that reach the scan
    kernel in its first call, ``(mask, valid)`` in ``seen``."""
    wrapped = clip_kernel.nms_scan

    def probe(mask, valid):
        if not seen:            # the first call only: later ones are timed
            seen.append((mask.clone(), valid.clone()))
        return wrapped(mask, valid)
    with swapped((clip_kernel, 'nms_scan', probe)):
        yield


def check_aligned_scan(mask, valid, n_expected, name):
    """The scan kernel on the class-aware axis-aligned dominance mask that
    a ScanNet forward sent it (``(1, N, ceil(N / 32))``, N = the decode's
    candidates): bit for bit against its plain version and the fixpoint
    keep, with times."""
    g, n = valid.shape
    if n != n_expected or n > clip_kernel._MAX_SCAN_N:
        raise AssertionError(f'{name}: the scan got {n} candidates, the '
                             f'decode makes {n_expected} (limit '
                             f'{clip_kernel._MAX_SCAN_N})')
    keep = clip_kernel.nms_scan(mask, valid)
    ref = nms_ops.nms_scan_plain(mask, valid)
    dominates = iou_ops.unpack_mask(mask, n)
    fix = nms_ops.greedy_nms_from_iou_batched(
        dominates.float(), valid.float(), valid, 0.5, presorted=True)
    torch.cuda.synchronize()
    if not torch.equal(keep, ref) or not torch.equal(keep, fix):
        raise AssertionError(f'{name}: nms scan differs from its plain '
                             f'version or the fixpoint')
    n_keep = int(keep.sum())
    if not 0 < n_keep < int(valid.sum()):
        raise AssertionError(f'{name}: the scan suppresses nothing')

    def run():
        return clip_kernel.nms_scan(mask, valid)
    return clip_row(
        'nms_scan', 'imvoxelnet_tpu/ops/nms.py:75',
        f'nms scan, {name} class-aware axis-aligned, G={g} N={n}',
        time_ms(run, SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: nms_ops.nms_scan_plain(mask, valid), 1),
        nbytes(mask, valid, keep), 0,
        launch_bound_ms=time_ms(run, SMALL_REPS),
        note='no Pallas counterpart: the JAX package runs the greedy step '
             'as a lax.while_loop fixpoint; the mask is plain PyTorch (XLA '
             'in the JAX package)', kept=n_keep, offered=int(valid.sum()),
        mask_bits_set=int(dominates.sum()))


def run_scannet():
    """The ScanNet presets: serving with 50 views (b=1 float32 against the
    plain path, b=1 bfloat16 timed), training with 20 views (b=1 float32
    against the plain path, 5 timed b=1 bfloat16 steps); one step of
    _top27; the scan kernel on the mask each preset's forward sent it."""
    out, serve_counts, train_counts, scan_rows = {}, {}, {}, []
    for name in SCANNET_PRESETS:
        preset = get_preset(name)
        views = preset.data.n_images_test
        seen = []
        with scan_probe(seen):
            out[name], serve_counts[name] = serve_vs_plain(
                name, serving_batch('scannet', 1, 'cuda', seed=SEED,
                                    views=views),
                serving_batch('scannet', 1, 'cuda', seed=SEED + 1,
                              views=views), SCANNET_LAUNCHES)
        hc = preset.model.indoor_head
        sizes = [int(np.prod(preset.model.n_voxels)) >> (3 * i)
                 for i in range(hc.n_scales)]
        scan_rows.append((check_aligned_scan(
            *seen[0], sum(min(hc.nms_pre, s) for s in sizes), name), name))
        del seen
        out[name]['b1_float32_train_vs_plain'] = train_vs_plain(
            name, SCANNET_TRAIN_LAUNCHES, INDOOR_MUST_LEARN)
        out[name]['b1_bfloat16_train'], train_counts[name], _ = timed_steps(
            name, SCANNET_TRAIN_LAUNCHES)
    out['imvoxelnet_scannet_top27'] = one_step('imvoxelnet_scannet_top27',
                                               SCANNET_TRAIN_LAUNCHES)
    log(f'scannet launch counts: serving {json.dumps(serve_counts)}, '
        f'training {json.dumps(train_counts)}')
    return out, serve_counts, train_counts, scan_rows


# --------------------------------------------------------------------------
# phase 9: nuScenes (six cameras, DCNv2 in the backbone, the nuScenes neck)
# --------------------------------------------------------------------------

NUSCENES = 'imvoxelnet_nuscenes'
NUSCENES_LAUNCHES = {'backproject': 1, 'backproject_grad': 0, 'conv3x3x3': 2,
                     'rect_clip': 1, 'rect_clip_grad': 0, 'nms_scan': 1}
NUSCENES_TRAIN_LAUNCHES = {'backproject': 1, 'backproject_grad': 1,
                           'conv3x3x3': 4, 'rect_clip': 0,
                           'rect_clip_grad': 0, 'nms_scan': 0}
NUSCENES_BLOCK0 = (312, 312, 12)
NUSCENES_MUST_LEARN = ('backbone.layer2.0.conv1.weight',
                       'backbone.layer3.0.conv2.weight',
                       'backbone.layer3.0.conv2.conv_offset.weight',
                       'backbone.layer3.0.conv2.conv_offset.bias',
                       'backbone.layer4.2.conv2.weight',
                       'backbone.layer4.2.conv2.conv_offset.weight',
                       'neck.lateral_convs.0.conv.weight',
                       'neck_3d.model.0.conv1.weight',
                       'neck_3d.model.0.conv2.weight',
                       'bbox_head.conv_reg.weight')


def run_nuscenes():
    """imvoxelnet_nuscenes: serving (b=1 float32 against the plain path
    with tied scores, b=1 bfloat16 timed), one b=1 float32 training step
    against the plain path, two float32 steps with ``cudnn.deterministic``
    whose gradients must repeat bit for bit (the DCNs' included: their
    gathers' backward is an accumulating ``index_put_``), and 5 timed b=1
    bfloat16 steps."""
    preset = get_preset(NUSCENES)
    out = {}
    out['serve'], serve_counts = serve_vs_plain(
        NUSCENES, serving_batch('nuscenes', 1, 'cuda', seed=SEED),
        serving_batch('nuscenes', 1, 'cuda', seed=SEED + 1),
        NUSCENES_LAUNCHES, tie=True)
    out['b1_float32_train_vs_plain'] = train_vs_plain(
        NUSCENES, NUSCENES_TRAIN_LAUNCHES, NUSCENES_MUST_LEARN)
    pristine = build_model(preset.model, device='cuda', seed=SEED)
    dcn_offsets(pristine)
    out['b1_float32_repeat'] = repeat_count(
        pristine, preset, train_batch(preset.data, 1, 'cuda', seed=SEED))
    del pristine
    out['b1_bfloat16_train'], train_counts, _ = timed_steps(
        NUSCENES, NUSCENES_TRAIN_LAUNCHES)
    log(f'nuscenes launch counts: serving {json.dumps(serve_counts)}, '
        f'training {json.dumps(train_counts)}')
    return out, serve_counts, train_counts


def nuscenes_kernel_rows(rng):
    """The kernels at the nuScenes shapes: ``(row, 'serve' or 'train')``
    for the ``kernels`` line (B1 and the NMS mask + scan at one group of
    1,000 with the serving launches, B3 forward with the serving launches
    and dx with the training ones, B1's backward with the training ones),
    and the float32 rows, logged only."""
    iou_thr = get_preset(NUSCENES).model.anchor_head.iou_thr
    mask_row, scan_row = check_nms_kernels(1, 1000, iou_thr, rng,
                                           plain_reps=3)
    rows = [
        (check_backproject(1, torch.bfloat16, 2e-2, rng, NUSCENES), 'serve'),
        (check_conv3x3x3(1, torch.bfloat16, 2e-2, rng,
                         volume=NUSCENES_BLOCK0, name=NUSCENES), 'serve'),
        (check_conv3x3x3(1, torch.bfloat16, 2e-2, rng, dx=True,
                         volume=NUSCENES_BLOCK0, name=NUSCENES), 'train'),
        (check_backproject_grad(1, torch.bfloat16, rng, NUSCENES), 'train'),
        (mask_row, 'serve'), (scan_row, 'serve')]
    logged = [check_backproject(1, torch.float32, 1e-5, rng, NUSCENES),
              check_backproject_grad(1, torch.float32, rng, NUSCENES),
              check_conv3x3x3(1, torch.float32, 1e-4, rng,
                              volume=NUSCENES_BLOCK0, name=NUSCENES),
              check_conv3x3x3(1, torch.float32, 1e-4, rng, dx=True,
                              volume=NUSCENES_BLOCK0, name=NUSCENES)]
    return rows, logged


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    # the float32 comparisons in full float32 (TF32 off); bfloat16 work is
    # untouched by the flags
    with compute_precision('float32'):
        return smoke()


def smoke():
    rng = np.random.RandomState(SEED)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')

    t0 = time.perf_counter()
    build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f} s wall, per kernel '
        f'{json.dumps({k: round(v, 1) for k, v in build.build_seconds.items()})}')
    for name, text in build.ptxas_log.items():
        for fn, info in ptxas_functions(text).items():
            log(f'ptxas {name}: {fn}: {json.dumps(info)}')
            # the clip's polygons must live in registers
            if name == 'rect_clip' and (
                    info.get('stack', 1) or info.get('spill_stores', 1)
                    or info.get('spill_loads', 1)):
                raise AssertionError(f'rect_clip: {fn}: {info}')
    # (a library found already built has no log)
    if 'stack frame' not in build.ptxas_log.get('rect_clip', 'stack frame'):
        raise AssertionError('rect_clip: ptxas reported no stack frame line')
    n_hgmma = build.sass_count('conv3x3x3', 'HGMMA')
    log(f'conv3x3x3 library: {n_hgmma} HGMMA (tensor-core warpgroup MMA) '
        f'instructions in its SASS')
    if n_hgmma == 0:
        raise AssertionError('conv3x3x3: no tensor-core instruction built')

    log(f'HBM: 1 GiB device copy at {copy_rate_tb_s():.4g} TB/s read+write '
        f'(published peak {PEAK_BYTES / 1e12:.3g} TB/s)')
    iou_thr = get_preset('imvoxelnet_kitti').model.anchor_head.iou_thr
    mask_row, scan_row = check_nms_kernels(8, 100, iou_thr, rng)
    serving = [check_backproject(8, torch.bfloat16, 2e-2, rng), mask_row,
               scan_row, check_conv3x3x3(8, torch.bfloat16, 2e-2, rng)]
    rows = serving + [check_backproject(1, torch.float32, 1e-5, rng),
                      check_rect_clip_paired(rng),
                      check_rect_clip_pairwise(8, 100, rng),
                      check_rect_clip_pairwise(1, 1024, rng),
                      check_conv3x3x3(1, torch.float32, 1e-4, rng)]
    for row in rows:
        log(json.dumps(row))

    counts = run_slice()
    bp_grad_row = check_backproject_grad(4, torch.bfloat16, rng)
    log(json.dumps(check_backproject_grad(1, torch.float32, rng)))
    log(json.dumps(bp_grad_row))
    # B1's forward and B3's forward and dx at the b=4 bfloat16 training
    # shapes
    train_rows = [check_backproject(4, torch.bfloat16, 2e-2, rng,
                                    train=True),
                  check_conv3x3x3(4, torch.bfloat16, 2e-2, rng),
                  check_conv3x3x3(4, torch.bfloat16, 2e-2, rng, dx=True)]
    for row in train_rows:
        log(json.dumps(row))
    train, train_counts = run_train()
    log(json.dumps({'train': train}))

    # the indoor kernel rows, with the presets whose b=8 forward gives
    # their launches
    indoor_thr = get_preset('imvoxelnet_sunrgbd').model.indoor_head.iou_thr
    indoor_rows = [
        (check_backproject(8, torch.bfloat16, 2e-2, rng,
                           'imvoxelnet_sunrgbd'), 'imvoxelnet_sunrgbd'),
        (check_backproject(8, torch.bfloat16, 2e-2, rng,
                           'imvoxelnet_sunrgbd_fast'),
         'imvoxelnet_sunrgbd_fast')]
    for g, preset in ((80, 'imvoxelnet_sunrgbd'),
                      (240, 'imvoxelnet_perspective_sunrgbd_fast')):
        indoor_rows += [(row, preset) for row in check_nms_kernels(
            g, 256, indoor_thr, rng, plain_reps=3)]
    for row in [check_backproject(1, torch.float32, 1e-5, rng,
                                  'imvoxelnet_sunrgbd'),
                check_backproject(1, torch.float32, 1e-5, rng,
                                  'imvoxelnet_sunrgbd_fast')] + \
            [row for row, _ in indoor_rows]:
        log(json.dumps(row))
    indoor, indoor_counts = run_indoor()
    log(json.dumps({'indoor': indoor}))

    # the SUN RGB-D training path: the clip's paired entry and its backward
    # at the b=4 IoU-3D loss shapes on a stress input (80% of the pairs
    # with an area gradient), B1's forward and backward at the training
    # shapes (768x576), then the training steps; then the clip's rows on
    # the corners and the area gradient of a b=4 step
    for n in (934400, 116800):
        for row in check_rect_clip_grad(
                *loss_pairs(rng, n), stress_area_grad(rng, n),
                'stress input, 80% nonzero area gradients', n // 2):
            log(json.dumps(row))
    log(json.dumps({'rect_clip_grad_cases':
                    check_rect_clip_grad_cases(rng)}))
    indoor_train_rows = [
        (check_backproject(4, torch.bfloat16, 2e-2, rng, p, train=True), p)
        for p in INDOOR_TRAIN_PRESETS] + [
        (check_backproject_grad(4, torch.bfloat16, rng, p), p)
        for p in INDOOR_TRAIN_PRESETS]
    for row in [check_backproject(1, torch.float32, 1e-5, rng, p, train=True)
                for p in INDOOR_TRAIN_PRESETS] + [
            check_backproject_grad(1, torch.float32, rng, p)
            for p in INDOOR_TRAIN_PRESETS] + \
            [row for row, _ in indoor_train_rows]:
        log(json.dumps(row))
    indoor_train, indoor_train_counts, clip_inputs = run_indoor_train()
    log(json.dumps({'indoor_train': indoor_train}))
    for p in INDOOR_TRAIN_PRESETS:
        c1, c2, g, positives = clip_inputs[p]
        rows = check_rect_clip_grad(c1, c2, g,
                                    f'{p} b=4 bf16 step, IoU-3D loss', 1)
        rows[1]['positives_in_the_batch'] = positives
        indoor_train_rows += [(row, p) for row in rows]
        for row in rows:
            log(json.dumps(row))
    del clip_inputs

    # Total3D: serving on predicted extrinsics and training, then the NMS
    # mask + scan at its 33 classes x 8 samples
    total3d, total3d_serve, total3d_train = run_total3d()
    log(json.dumps({'total3d': total3d}))
    total3d_rows = [(row, 'imvoxelnet_total_sunrgbd') for row in
                    check_nms_kernels(264, 256, indoor_thr, rng,
                                      plain_reps=3)]

    # ScanNet: 50 views served, 20 in training; then the backprojection
    # and its backward at those views, both widths
    scannet, scannet_serve, scannet_train, scan_rows = run_scannet()
    log(json.dumps({'scannet': scannet}))
    scannet_rows = [
        (check_backproject(1, torch.bfloat16, 2e-2, rng, p, train=train),
         p, train) for train in (False, True) for p in SCANNET_PRESETS] + [
        (check_backproject_grad(1, torch.bfloat16, rng, p), p, True)
        for p in SCANNET_PRESETS]
    for row in [check_backproject_grad(1, torch.float32, rng, p)
                for p in SCANNET_PRESETS] + \
            [row for row, _ in total3d_rows + scan_rows] + \
            [row for row, _, _ in scannet_rows]:
        log(json.dumps(row))

    # nuScenes: six views, DCNv2 backbone, B3 on the 312x312x12 block0
    t9 = time.perf_counter()
    nuscenes_rows, logged = nuscenes_kernel_rows(rng)
    for row in logged + [row for row, _ in nuscenes_rows]:
        log(json.dumps(row))
    nuscenes, nuscenes_serve, nuscenes_train = run_nuscenes()
    log(json.dumps({'nuscenes': nuscenes}))
    log(f'phase 9 (nuscenes): {time.perf_counter() - t9:.1f} s')

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    # the summary line: the kernels at the KITTI serving shapes (b=8
    # bfloat16; the NMS of 8 samples x 100 candidates) with the launches of
    # the b=8 forward; the backprojection's backward, its forward and B3's
    # forward and dx at the b=4 bfloat16 training shapes with their
    # launches in the 5 timed training steps (B3's count holds both); the
    # indoor serving rows with the launches of their preset's b=8 forward;
    # and the indoor training rows (B1 forward and backward, the clip's
    # paired entry and its backward at b=4) with the launches of their
    # preset's 5 timed b=4 training steps; the Total3D mask + scan with the
    # launches of its b=8 forward; the ScanNet rows (B1 with 50 views, the
    # scan of its forward's ~3,000 candidates) with those of its b=1
    # bfloat16 forward, and B1 and its backward with 20 views with those of
    # its 5 timed b=1 steps; the nuScenes rows (B1 with six views, B3 on
    # its block0, the mask + scan of 1,000 candidates) with those of its
    # b=1 bfloat16 forward, and B3's dx and B1's backward with those of its
    # 5 timed b=1 steps
    summary = []
    for row, launches in [(r, counts['b8_bf16'][r['name']]) for r in serving] \
            + [(r, train_counts[r['name']])
               for r in [bp_grad_row] + train_rows] \
            + [(r, indoor_counts[p][r['name']]) for r, p in indoor_rows] \
            + [(r, indoor_train_counts[p][r['name']])
               for r, p in indoor_train_rows] \
            + [(r, total3d_serve[p][r['name']]) for r, p in total3d_rows] \
            + [(r, scannet_serve[p][r['name']]) for r, p in scan_rows] \
            + [(r, (scannet_train if train else scannet_serve)[p][r['name']])
               for r, p, train in scannet_rows] \
            + [(r, (nuscenes_serve if use == 'serve'
                    else nuscenes_train)[r['name']])
               for r, use in nuscenes_rows]:
        entry = {k: row[k] for k in (
            'name', 'route', 'source', 'replaces', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}
        entry['launches'] = launches
        entry['shape'] = row['shape']
        summary.append(entry)
    log(json.dumps({'kernels': summary}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
