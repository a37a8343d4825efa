"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each failing the run on its own error:
  1. build   -- nvcc builds the kernel libraries from the sources in
                imvoxelnet_tpu_torch/kernels/csrc, in parallel; the clip
                library must need no stack frame and spill nothing, and the
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
                the 3D neck's batch-norm statistics); the backprojection's
                backward kernel against its plain version at the b=4
                bfloat16 shapes; 5 timed b=4 bfloat16 steps at 1408x416 with
                their launch counts; one step forbidden to wait for the
                device.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
Weights are random from a seed.  Needs a CUDA device; imports no JAX.
"""

import copy
import dataclasses
import json
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
from imvoxelnet_tpu_torch.models import necks3d
from imvoxelnet_tpu_torch.models.detector import (build_model,
                                                  imvoxelnet_predict)
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops
from imvoxelnet_tpu_torch.parallel import train as train_lib
from imvoxelnet_tpu_torch.utils.synthetic import (KITTI_H, KITTI_W,
                                                  kitti_batch,
                                                  kitti_train_batch)

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

def check_backproject(b, dtype, tol, rng):
    cfg = get_preset('imvoxelnet_kitti').model
    batch = kitti_batch(b, 'cuda', seed=SEED)
    hf, wf, c = KITTI_H // 4, KITTI_W // 4, cfg.fpn_out_channels
    feats = torch.tensor(rng.randn(b, 1, hf, wf, c).astype(np.float32),
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
    n_flops = b * p * (18 + 2 + c)      # 3 projections, 2 divides, C adds
    t_bound, by = bound(nbytes(feats, points, proj, hw, acc, cnt), n_flops,
                        torch.float32)
    return dict(
        name='backproject', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/backproject.cu',
        replaces='imvoxelnet_tpu/ops/backproject_pallas.py:155',
        shape=f'b={b} {str(dtype)[6:]} features {tuple(feats.shape)} '
              f'P={p}', max_abs_err=err, seen_frac=float((cnt > 0)
                                                         .float().mean()),
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
SMALL_REPS = 200
QUEUE_US = 60


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
        raise AssertionError(f'{name}: {n_diff} of {got.numel()} values not '
                             f'bit-identical to the plain version')


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
    assert_same_bits('rect_clip paired', got, ref)
    n = c1.shape[0]

    def run():
        return clip_kernel.rect_intersection_area(c1, c2)
    return clip_row(
        'rect_clip', CLIP_REPLACES, f'paired, {n} pairs float32',
        time_ms(run, SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: iou_ops.rect_intersection_area_plain(c1, c2), 20),
        nbytes(c1, c2, got), n * CLIP_FLOPS,
        launch_bound_ms=time_ms(run, SMALL_REPS))


def check_rect_clip_pairwise(g, n, rng):
    """The pairwise entry: every box of a group against every box of it."""
    corners = box_ops.bev_corners(car_boxes(rng, g, n)).contiguous()
    got = clip_kernel.rect_intersection_area_pairwise(corners, corners)
    ref = iou_ops.rect_intersection_area_pairwise_plain(corners, corners)
    torch.cuda.synchronize()
    assert_same_bits(f'rect_clip pairwise G={g} N={n}', got, ref)
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


def check_nms_kernels(g, n, iou_thr, rng):
    """The fused mask entry and the scan kernel at the main path's shape
    (b=8 KITTI: 8 samples x 1 class, nms_pre = 100), against their plain
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
                                                         iou_thr), 20),
        nbytes(corners, areas, mask),
        g * n * (n - 1) // 2 * (CLIP_FLOPS + 4),
        launch_bound_ms=time_ms(run_mask, SMALL_REPS))
    scan_row = clip_row(
        'nms_scan', 'imvoxelnet_tpu/ops/nms.py:75', f'nms scan, {shape}',
        time_ms(run_scan, SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: nms_ops.nms_scan_plain(mask, valid), 5),
        nbytes(mask, valid, keep), 0,
        launch_bound_ms=time_ms(run_scan, SMALL_REPS),
        note='no Pallas counterpart: the JAX package runs the greedy step '
             'as a lax.while_loop fixpoint', kept=n_keep,
        fixpoint_nms_ms=time_ms(fixpoint, 5))
    return mask_row, scan_row


def check_conv3x3x3(b, dtype, tol, rng):
    nx, ny, nz, c = 216, 248, 12, 64         # KITTI block0
    x = torch.tensor(rng.randn(b, nx, ny, nz, c).astype(np.float32),
                     device='cuda').to(dtype)
    w = torch.tensor((rng.randn(3, 3, 3, c, c) / np.sqrt(27 * c))
                     .astype(np.float32), device='cuda').to(dtype)
    got = conv_kernel.conv3x3x3(x, w)
    ref = conv3z.conv3x3x3_plain(x, w)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    x_ncdhw = x.permute(0, 4, 1, 2, 3)           # channels_last_3d memory
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    n_flops = 2 * b * nx * ny * nz * 27 * c * c
    t_bound, by = bound(nbytes(x, w, got), n_flops, dtype)
    reps = 10
    ms = time_ms(lambda: conv_kernel.conv3x3x3(x, w), reps)
    return dict(
        name='conv3x3x3', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/conv3x3x3.cu',
        replaces='imvoxelnet_tpu/ops/conv3z_pallas.py:91',
        shape=f'b={b} {str(dtype)[6:]} x {tuple(x.shape)}', max_abs_err=err,
        ms=ms, tflops=n_flops / (ms * 1e-3) / 1e12,
        plain_ms=time_ms(lambda: conv3z.conv3x3x3_plain(x, w), reps),
        bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: F.conv3d(x_ncdhw, w_oidhw, padding=1),
                           reps))


def check_backproject_grad(b, dtype, rng):
    """The backward kernel at the training shapes (imvoxelnet_kitti's padded
    train size): against its plain version, with the library time of
    ``index_add_`` over the forward's precomputed pixels."""
    preset = get_preset('imvoxelnet_kitti')
    cfg, size = preset.model, preset.data.train_size
    batch = kitti_train_batch(b, 'cuda', seed=SEED, size=size)
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
    ref = bp.backproject_batch_grad_plain(g, points, proj, hw, hf, wf)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    # float32 sums in another order, then one rounding to the features' type
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)

    # the same function as one library call: index_add_ of the float32
    # gradient rows at the forward's pixels (unseen rows to a spare row)
    idx, valid = bp._view_indices(points, proj, hw, hf, wf)     # (B, 1, P)
    n_valid = int(valid.sum())
    if not 0 < n_valid < b * p:
        raise AssertionError(f'backproject_grad: {n_valid} of {b * p} rows '
                             f'seen')
    base = torch.arange(b, device='cuda')[:, None] * (hf * wf)
    flat = torch.where(valid[:, 0], base + idx[:, 0], b * hf * wf)
    flat = flat.t().reshape(-1).contiguous()                   # (P * B,)
    src = g.float().reshape(p * b, c)
    table = torch.zeros((b * hf * wf + 1, c), device='cuda')
    lib = torch.zeros_like(table).index_add_(0, flat, src)[:-1]
    torch.testing.assert_close(lib.reshape(got.shape), ref.float(),
                               rtol=tol, atol=tol)
    # per row: 3 projections of 6 operations, 2 divides; per seen row C adds
    n_flops = b * p * (18 + 2) + n_valid * c
    t_bound, by = bound(nbytes(g, points, proj, hw, got), n_flops,
                        torch.float32)
    reps = 10
    return dict(
        name='backproject_grad', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/backproject.cu',
        replaces='imvoxelnet_tpu/ops/backproject_pallas.py:155 (backward; '
                 'the JAX package differentiates its XLA gather, '
                 'imvoxelnet_tpu/ops/backproject.py:166)',
        shape=f'b={b} {str(dtype)[6:]} grad_acc {tuple(g.shape)} -> '
              f'{tuple(got.shape)}', max_abs_err=err,
        seen_rows=n_valid,
        ms=time_ms(lambda: bp_kernel.backproject_batch_grad(
            g, points, proj, hw, hf, wf), reps),
        plain_ms=time_ms(lambda: bp.backproject_batch_grad_plain(
            g, points, proj, hw, hf, wf), 3),
        bound_ms=t_bound, bound_by=by,
        library_ms=time_ms(lambda: table.index_add_(0, flat, src), reps),
        library_call='index_add_ of float32 rows, indices precomputed')


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------

class plain_path:
    """Route the model's kernel call sites to their plain versions for the
    duration of the block (a smoke-run comparison device only)."""

    PLAIN = [(bp, 'backproject_batch', bp.backproject_batch_plain),
             (iou_ops, 'rect_intersection_area',
              iou_ops.rect_intersection_area_plain),
             (iou_ops, 'rect_intersection_area_pairwise',
              iou_ops.rect_intersection_area_pairwise_plain),
             (nms_ops, 'rotated_nms_presorted',
              nms_ops.rotated_nms_presorted_plain),
             (necks3d, 'conv3x3x3', conv3z.conv3x3x3_plain)]

    def __enter__(self):
        self._saved = [(m, a, getattr(m, a)) for m, a, _ in self.PLAIN]
        for mod, attr, plain in self.PLAIN:
            setattr(mod, attr, plain)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def run_slice():
    cfg = get_preset('imvoxelnet_kitti').model
    model = build_model(cfg, device='cuda', seed=SEED)
    with torch.no_grad():
        # the reference's -4.595 cls bias puts every random-weight score at
        # ~0.01 < score_thr; 0 lets detections through
        model.bbox_head.conv_cls.bias.zero_()
    counts = {}

    def forward(m, c, batch, sync_debug='default'):
        """``sync_debug='error'`` makes PyTorch raise if decode + NMS waits
        for the device (an ``.item()``, a ``bool(tensor)``, a copy to the
        host) between the head's output and the result."""
        with torch.no_grad():
            head_outs, valid = m(batch)
            torch.cuda.set_sync_debug_mode(sync_debug)
            try:
                return imvoxelnet_predict(c, head_outs), valid
            finally:
                torch.cuda.set_sync_debug_mode('default')

    # --- b=1 float32, kernel path vs plain path on the card
    batch1 = kitti_batch(1, 'cuda', seed=SEED)
    kernels.reset_launch_counts()
    res, seen = forward(model, cfg, batch1)
    torch.cuda.synchronize()
    counts['b1_f32'] = kernels.launch_counts()
    with plain_path():
        ref, ref_seen = forward(model, cfg, batch1)
    torch.cuda.synchronize()
    seen_diff = int((seen != ref_seen).sum())
    log(f'b=1 float32: {int(seen.sum())} of {seen.numel()} voxels seen; '
        f'{seen_diff} differ in seen between kernel and plain path')
    for key in ('boxes', 'scores'):
        if not torch.isfinite(res[key]).all():
            raise AssertionError(f'b=1: non-finite {key}')
    if not torch.equal(res['valid'], ref['valid']) or not torch.equal(
            res['labels'], ref['labels']):
        raise AssertionError('b=1: valid/labels differ from the plain path')
    for key in ('boxes', 'scores'):
        torch.testing.assert_close(res[key], ref[key], rtol=2e-3, atol=2e-3)
    if seen_diff or int(res['valid'].sum()) == 0:
        raise AssertionError(f'b=1: seen differs at {seen_diff} voxels or '
                             f'no valid detection')
    err = max((res[k] - ref[k]).abs().max().item() for k in ('boxes',
                                                             'scores'))
    log(f'b=1 float32: {int(res["valid"].sum())} detections, max abs err '
        f'vs plain path {err:.3g}')

    # --- b=8 bfloat16 throughput
    cfg16 = dataclasses.replace(cfg, compute_dtype='bfloat16')
    model16 = build_model(cfg16, device='cuda', seed=SEED)
    model16.load_state_dict(model.state_dict())
    b = 8
    batch8 = kitti_batch(b, 'cuda', seed=SEED + 1)
    forward(model16, cfg16, batch8)            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res8, seen8 = forward(model16, cfg16, batch8, sync_debug='error')
    torch.cuda.synchronize()
    counts['b8_bf16'] = kernels.launch_counts()
    for key in ('boxes', 'scores'):
        if not torch.isfinite(res8[key]).all():
            raise AssertionError(f'b=8: non-finite {key}')
    if int(res8['valid'].sum()) == 0:
        raise AssertionError('b=8: no valid detection')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_iters = 3
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out, _ = forward(model16, cfg16, batch8)
        out['scores'].sum().item()
    dt = time.perf_counter() - t0
    log(f'b=8 bfloat16: {int(res8["valid"].sum())} detections; '
        f'{b * n_iters / dt:.4g} scenes/s over {n_iters} batches; '
        f'peak memory {peak_gb:.4g} GB')

    for name, c in counts.items():
        want = {'backproject': 1, 'backproject_grad': 0, 'conv3x3x3': 2,
                'rect_clip': 1, 'nms_scan': 1}
        if c != want:
            raise AssertionError(f'{name}: launch counts {c} != {want}')
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


def run_train():
    preset = get_preset('imvoxelnet_kitti')
    cfg = preset.model
    out = {}

    # --- b=1 float32: one step through the kernels and one through the
    # plain versions (forward and backward), from the same weights
    model = build_model(cfg, device='cuda', seed=SEED)
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
    del model, plain_model, step, plain_step, grads, plain_grads

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
            'rect_clip': 0, 'nms_scan': 0}
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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)}')

    t0 = time.perf_counter()
    build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f} s wall, per kernel '
        f'{json.dumps({k: round(v, 1) for k, v in build.build_seconds.items()})}')
    for name, text in build.ptxas_log.items():
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'ptxas {name}: {line.strip()}')
            # the clip's polygon must live in registers
            if name == 'rect_clip' and 'stack frame' in line and not \
                    line.strip().startswith(
                        '0 bytes stack frame, 0 bytes spill stores, '
                        '0 bytes spill loads'):
                raise AssertionError(f'rect_clip: {line.strip()}')
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
    train, train_counts = run_train()
    log(json.dumps({'train': train}))
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    # the summary line: the kernels at the serving shapes (b=8 bfloat16; the
    # NMS of 8 samples x 100 candidates) with the launches of the b=8
    # forward, and the backprojection's backward at the b=4 bfloat16
    # training shapes with its launches in the 5 timed training steps
    summary = []
    for row, launches in [(r, counts['b8_bf16'][r['name']]) for r in serving] \
            + [(bp_grad_row, train_counts['backproject_grad'])]:
        entry = {k: row[k] for k in (
            'name', 'route', 'source', 'replaces', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}
        entry['launches'] = launches
        summary.append(entry)
    log(json.dumps({'kernels': summary}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
