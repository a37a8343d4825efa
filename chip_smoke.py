"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each failing the run on its own error:
  1. build   -- nvcc builds the three kernels from the sources in
                imvoxelnet_tpu_torch/kernels/csrc, in parallel; the conv
                library's SASS must hold tensor-core (HGMMA) instructions;
  2. kernels -- each kernel against its plain PyTorch version on the card at
                the shapes the KITTI main path gives it, with times;
  3. slice   -- the full-width imvoxelnet_kitti forward + decode/NMS through
                the port's entry points: b=1 float32 (held against the same
                model's plain path on the card) and b=8 bfloat16 (throughput),
                with the launch counts that show the kernels ran.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
Weights are random from a seed.  Needs a CUDA device; imports no JAX.
"""

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
from imvoxelnet_tpu_torch.utils.synthetic import KITTI_H, KITTI_W, kitti_batch

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SEED = 0


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check_rect_clip(rng):
    # KITTI NMS: 1 class x nms_pre=100 candidates -> 100 x 100 pairs; cars
    # clustered so that boxes overlap, touch and nest
    k = 100
    xy = rng.uniform(0, 8, (k, 2))
    wl = np.stack([rng.uniform(1.4, 1.8, k), rng.uniform(3.4, 4.4, k)], 1)
    yaw = rng.uniform(-np.pi, np.pi, (k, 1))
    boxes = torch.tensor(np.concatenate([xy, wl, yaw], 1).astype(np.float32),
                         device='cuda')
    boxes[1] = boxes[0]                         # identical pair
    corners = box_ops.bev_corners(boxes)
    c1 = corners[:, None].expand(k, k, 4, 2).reshape(-1, 4, 2).contiguous()
    c2 = corners[None, :].expand(k, k, 4, 2).reshape(-1, 4, 2).contiguous()
    got = clip_kernel.rect_intersection_area(c1, c2)
    ref = iou_ops.rect_intersection_area_plain(c1, c2)
    torch.cuda.synchronize()
    n_diff = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    if n_diff:
        raise AssertionError(f'rect_clip: {n_diff} areas not bit-identical')
    area = boxes[:, 2] * boxes[:, 3]

    def keep(inter):
        inter = inter.view(k, k)
        iou = inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-8)
        scores = torch.linspace(1.0, 0.1, k, device='cuda')
        return nms_ops.greedy_nms_from_iou_batched(
            iou, scores, torch.ones(k, dtype=torch.bool, device='cuda'),
            0.01, presorted=True)
    if not torch.equal(keep(got), keep(ref)):
        raise AssertionError('rect_clip: NMS keep masks differ')
    n = c1.shape[0]
    # per pair ~ 4 edges x 8 slots x 14 flops + the 8-term shoelace
    t_bound, by = bound(nbytes(c1, c2, got), n * (4 * 8 * 14 + 8 * 4),
                        torch.float32)
    return dict(
        name='rect_clip', route='cuda',
        source='imvoxelnet_tpu_torch/kernels/csrc/rect_clip.cu',
        replaces='imvoxelnet_tpu/ops/iou_pallas.py:189',
        shape=f'{n} pairs float32', max_abs_err=0.0,
        ms=time_ms(lambda: clip_kernel.rect_intersection_area(c1, c2), 200),
        plain_ms=time_ms(
            lambda: iou_ops.rect_intersection_area_plain(c1, c2), 20),
        bound_ms=t_bound, bound_by=by, library_ms=None)


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


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------

class plain_path:
    """Route the model's three kernel call sites to their plain versions
    for the duration of the block (a smoke-run comparison device only)."""

    def __enter__(self):
        self._saved = [(bp, 'backproject_batch'),
                       (iou_ops, 'rect_intersection_area'),
                       (necks3d, 'conv3x3x3')]
        self._saved = [(m, a, getattr(m, a)) for m, a in self._saved]
        bp.backproject_batch = bp.backproject_batch_plain
        iou_ops.rect_intersection_area = iou_ops.rect_intersection_area_plain
        necks3d.conv3x3x3 = conv3z.conv3x3x3_plain
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

    def forward(m, c, batch):
        with torch.no_grad():
            head_outs, valid = m(batch)
            return imvoxelnet_predict(c, head_outs), valid

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
    res8, seen8 = forward(model16, cfg16, batch8)
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
        want = {'backproject': 1, 'conv3x3x3': 2,
                'rect_clip': 1 if name == 'b1_f32' else b}
        if c != want:
            raise AssertionError(f'{name}: launch counts {c} != {want}')
    log(f'launch counts per forward: {json.dumps(counts)}')
    return counts


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
    n_hgmma = build.sass_count('conv3x3x3', 'HGMMA')
    log(f'conv3x3x3 library: {n_hgmma} HGMMA (tensor-core warpgroup MMA) '
        f'instructions in its SASS')
    if n_hgmma == 0:
        raise AssertionError('conv3x3x3: no tensor-core instruction built')

    log(f'HBM: 1 GiB device copy at {copy_rate_tb_s():.4g} TB/s read+write '
        f'(published peak {PEAK_BYTES / 1e12:.3g} TB/s)')
    rows = [check_backproject(1, torch.float32, 1e-5, rng),
            check_backproject(8, torch.bfloat16, 2e-2, rng),
            check_rect_clip(rng),
            check_conv3x3x3(1, torch.float32, 1e-4, rng),
            check_conv3x3x3(8, torch.bfloat16, 2e-2, rng)]
    for row in rows:
        log(json.dumps(row))

    counts = run_slice()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    # the summary line: the serving shapes (b=8 bfloat16; 10k NMS pairs),
    # with the launches of the b=8 forward
    summary = []
    for row in (rows[1], rows[2], rows[4]):
        entry = {k: row[k] for k in (
            'name', 'route', 'source', 'replaces', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}
        entry['launches'] = counts['b8_bf16'][row['name']]
        summary.append(entry)
    log(json.dumps({'kernels': summary}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
