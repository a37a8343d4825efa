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
                top-k's index order on both paths; then the head's raw
                outputs untied, cls, bbox and dir within 2e-3 of their
                max-abs, with the score gap at the 1,000th candidate and
                whether both paths pick the same 1,000 anchors) and b=1
                bfloat16 timed with a decode that must not wait for the
                device; one b=1
                float32 training step held against the plain path (the DCN
                and conv_offset gradients named); two float32 steps from one
                state with cudnn.deterministic, whose gradients must repeat
                bit for bit; 5 timed b=1 bfloat16 steps and one that must
                not wait for the device; launches asserted.
  10. eval  -- the evaluation path through imvoxelnet_tpu_torch.tools.test:
                splits of every family written to a temporary directory (PNG
                frames at the datasets' sizes, info files in their schemas)
                and seeded reference-style checkpoints; every run's launches
                asserted (per batch, plus the indoor protocol's pairwise
                clip once per image with detections and GT, and Total3D's
                layout_ious once); imvoxelnet_kitti on 32 frames of 1242x375
                (b=8 bfloat16; the reference's metric names, the GT as the
                prediction at the protocol's ceiling; the loader alone at 8
                workers, run_inference end to end over 4 and over 32
                batches (the split listed 8 times) and under the profiler for
                the card's busy share, the forward + decode alone on the
                same batches on the card); imvoxelnet_sunrgbd on 16 frames
                of 730x530 (b=8 bfloat16; the protocol's IoUs through the
                clip's pairwise entry on the card against the plain clip on
                the CPU, the GT as the prediction at mAP 1);
                imvoxelnet_total_sunrgbd_fast on 4 frames (layout_iou through
                the pairwise entry, the GT layout at 1);
                imvoxelnet_scannet_fast on one scene of 50 views and
                imvoxelnet_nuscenes on two samples of six 1600x900 views
                (NDS of the GT as the prediction at 1).  The port must not
                import cv2, PIL, ml_dtypes or JAX on this path; where the
                machine has cv2, a separate interpreter holds the port's
                PNG decode and resize to it bit for bit.
  11. train from files -- imvoxelnet_tpu_torch.tools.train on splits
                written to a temporary directory: imvoxelnet_kitti at full
                width, b=4 bfloat16, 48 frames of 1242x375 (3 repeats, 36
                steps an epoch), 2 epochs with validation on 16 frames at
                b=8, launches per step (B1 1, its backward 1, B3 4) and per
                validation batch (B1 1, B3 2, mask 1, scan 1) asserted from
                the CLI's own run; the same CLI for 1 epoch and then 2
                (auto-resume from latest.pth) bit for bit against the
                straight run (parameters, buffers, AdamW tensors, schedule,
                epoch 2's losses and validation; cudnn.deterministic);
                tools/test.py --checkpoint on its latest.pth equal to the
                last validation line; apis.init_detector +
                inference_detector on one frame bit for bit against
                run_inference through the loader, with the same launches;
                the steady state of training from files (bfloat16, through
                the CLI's loop, a short and a long epoch of the split listed
                more often) for imvoxelnet_kitti b=4, imvoxelnet_sunrgbd b=4
                and imvoxelnet_scannet b=1 with 20 views, beside the
                synthetic step and the loader alone over the long epoch at 8
                workers, with fill + drain, peak memory, launches per step
                and, for KITTI, the card's busy share over 10 steps between
                two log lines (profiler trace); those 10 steps and one b=8
                serving forward + decode hold no host call that waits for
                the device and no device-to-host copy; the five learning
                loops of tools/validate_learning.py (cudnn.deterministic)
                with their criteria, untimed, each through the CLI in a
                process of its own and all five at once: phase 13's
                multihost runs start before them and share the card, and
                are joined before phase 12, which times kernels and
                programs with nothing else on the card.
  12. export and the paths no preset takes -- imvoxelnet_kitti (bfloat16,
                weights as inputs) exported with torch.export at b=1 and
                with a symbolic batch, imvoxelnet_total_sunrgbd_fast at b=1
                (angles and layout), their kernels torch.ops.imvx nodes;
                saved, then loaded and run in a fresh interpreter that
                imports imvoxelnet_tpu_torch.utils.export alone (b=1 and b=8
                on the poly-batch program), each call's launches asserted
                (B1 1, B3 2, mask 1, scan 1), the detections held to the
                eager forward, the b=8 call traced for host syncs; the baked
                program through tools/export.py --verify; the untruncated
                NMS (pre_nms_k=0) of imvoxelnet_sunrgbd on a b=8 forward's
                head outputs: the clip's pairwise entry once and the scan
                once for all samples and classes, equal to the plain path
                sample by sample, no host sync, its peak memory and time
                against the truncated decode; use_rotate_nms=False at
                imvoxelnet_kitti b=8 (the scan alone) equal to the plain
                path; giou_3d_loss on 934,400 pairs (the clip's paired entry
                and its backward) against the plain path; the backbones of
                imvoxelnet_kitti and imvoxelnet_nuscenes with their frozen
                BNs folded against unfolded (float32, TF32 off); and
                tools/test.py --show-dir on a 2-frame KITTI split.
  13. converters and data parallelism -- phase 10's KITTI split (32 frames
                of 1242x375) and ScanNet scene (50 views of 640x480)
                written again, their raw trees written from them (KITTI's
                calibration and label text, a .sens stream of the frames
                re-encoded as JPEG by this machine's cv2) and converted by
                tools/create_data.py (kitti; scannet_images, scannet): the
                infos equal the splits' (the .sens poses as float32);
                tools/test.py on them (imvoxelnet_kitti b=8 bfloat16,
                imvoxelnet_scannet at 50 views), launches asserted; the SUN
                RGB-D (both class lists), Total3D and nuScenes converters
                on raw trees of their own, read through the datasets;
                tools/validate_multihost.py, two runs at a time: two gloo
                ranks on cuda:0 against one process on the same global
                batch (imvoxelnet_kitti float32 b=2; imvoxelnet_sunrgbd_fast
                under dp_loss_norm='batch_mean'): loss 1e-6, gradients
                within twice the gap that reversing the batch's order gives
                one process, BN statistics 1e-5, each rank's launches;
                one NCCL rank bit for bit as one process; imvoxelnet_scannet
                50 views over two ranks of 25 against the unsharded forward
                (head outputs 2e-3, valid exactly, B1 once a rank);
                tools/train.py --multihost --ckpt-format orbax as two ranks
                on the converted KITTI split (bfloat16, global b=4): the DCP
                directory restored bit for bit, a run resumed from it bit
                for bit as the straight run; B1 at a rank's 25 views,
                timed after phase 14, once its processes are gone.
  14. the export tool's multi-device programs and the measurement tools --
                in processes of their own, started beside phase 13:
                tools/export.py --platforms cuda,cpu
                (imvoxelnet_sunrgbd_fast b=1 float32: the card's program
                launches B1, the mask and the scan once, the CPU's
                nothing, each equal to the eager forward on its device),
                --view-sharded (imvoxelnet_scannet, 50 views over two gloo
                ranks on cuda:0, B1 once a rank at V=25) and
                --data-sharded (imvoxelnet_kitti float32, global b=2 over
                two ranks), each program's detections held to the eager
                forward on the same inputs (a sharded one's on each rank's
                share, the gaps bounded here), the sharded forward's head
                outputs to the unsharded ones (1e-5 of max-abs) and the
                detections to the unsharded eager forward (a decode that
                breaks a near tie held to the same counts, labels and
                scores), and tools/eval_nms_truncation.py (the mAP pair,
                both decodes' launches); then, alone on the card,
                tools/benchmark.py on imvoxelnet_kitti (b=8 bfloat16
                serving and a b=4 step; 10 iterations, then 5 under the
                profiler with --trace), its launches an iteration asserted,
                and tools/analyze_trace.py on each trace (--top 15
                --by-source): its device time equal to the profiler's own
                total (key_averages), the device time of the kernels
                launched in a span no more than the CUDA-event time of an
                iteration, B3's kernel among the top rows and billed to
                models/necks3d.py; bench_conv3z (B3 at block0 and at
                nuScenes' block0, forward and dx, beside this run's phase 2
                and 9 rows), bench_iou_kernel (B2's pairwise entry at
                N=256/1,000/3,000 bit for bit with its plain version, and
                the exact NMS at 3,000 candidates with its launches),
                bench_scatter (B1's backward against index_add_) and
                bench_loader; last the FLOP count (tools/flops.py, its
                counted 3D neck equal to the analytic inventory), a
                synthetic KITTI split (tools/make_synthetic_kitti.py, read
                back through the dataset) and tools/analyze_logs.py on
                phase 11's training log.
The last line is {"ok": true, "device": {...}}; any failure exits non-zero.
float32 work runs with TF32 off (utils/precision.py).  Weights are random
from a seed.  Needs a CUDA device; imports no JAX.
"""

import contextlib
import copy
import dataclasses
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from imvoxelnet_tpu_torch import apis, kernels
from imvoxelnet_tpu_torch.configs.presets import apply_overrides, get_preset
from imvoxelnet_tpu_torch.data import datasets
from imvoxelnet_tpu_torch.data import loader as loader_lib
from imvoxelnet_tpu_torch.data.image_io import load_image
from imvoxelnet_tpu_torch.eval import indoor_eval, kitti_eval, nuscenes_eval
from imvoxelnet_tpu_torch.eval import runner
from imvoxelnet_tpu_torch.kernels import backproject as bp_kernel
from imvoxelnet_tpu_torch.kernels import build
from imvoxelnet_tpu_torch.kernels import conv3x3x3 as conv_kernel
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.core import target_assign
from imvoxelnet_tpu_torch.models import necks3d
from imvoxelnet_tpu_torch.models.dcn import DeformConv2d
from imvoxelnet_tpu_torch.models.resnet import FrozenBatchNorm
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.models.detector import (build_model,
                                                  imvoxelnet_loss,
                                                  imvoxelnet_predict)
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import losses as loss_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops
from imvoxelnet_tpu_torch.parallel import mesh
from imvoxelnet_tpu_torch.parallel import train as train_lib
from imvoxelnet_tpu_torch.data.converters import nuscenes_converter
from imvoxelnet_tpu_torch.tools import analyze_trace, create_data
from imvoxelnet_tpu_torch.tools import test as test_tool
from imvoxelnet_tpu_torch.tools import train as train_tool
from imvoxelnet_tpu_torch.tools import validate_learning
from imvoxelnet_tpu_torch.tools import microbench
from imvoxelnet_tpu_torch.tools import validate_multihost
from imvoxelnet_tpu_torch.tools.profile_forward import (dcn_offsets,
                                                        level_angle_head,
                                                        zero_cls_bias)
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt_lib
from imvoxelnet_tpu_torch.utils import synthetic_raw
from imvoxelnet_tpu_torch.utils import synthetic_splits as splits
from imvoxelnet_tpu_torch.utils.precision import compute_precision
from imvoxelnet_tpu_torch.utils.synthetic import (kitti_batch,
                                                  kitti_train_batch,
                                                  serving_batch,
                                                  sunrgbd_batch, train_batch)

SEED = 0
# milliseconds a call between CUDA events (``queue_us``: the launches
# queued behind a spin kernel, so that a kernel of microseconds is timed
# and not its launches)
time_ms = microbench.cuda_ms


def log(*args):
    print(*args, flush=True)


def bound(n_bytes, n_flops, dtype):
    t_bytes = n_bytes / microbench.PEAK_BYTES * 1e3
    t_ops = n_flops / microbench.PEAK_FLOPS[dtype] * 1e3
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
                      train=False, views=None):
    """B1 at the main-path shapes of preset ``name``: its feature map,
    channels, views and voxel grid; ``train``: the preset's padded training
    size and training views; ``views``: the first of the serving views only
    (a rank's share of a view-sharded forward)."""
    preset = get_preset(name)
    cfg = preset.model
    if train:
        batch = train_batch(preset.data, b, 'cuda', seed=SEED)
    else:
        batch = serving_batch(preset.data.dataset, b, 'cuda', seed=SEED,
                              views=preset.data.n_images_test)
    if views is not None:
        batch = {k: v[:, :views] if k in mesh.VIEW_KEYS else v
                 for k, v in batch.items()}
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
         (nms_ops, 'normal_nms_presorted',
          nms_ops.normal_nms_presorted_plain),
         (nms_ops, 'nms_in_rank_order', nms_ops.nms_in_rank_order_plain),
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


def compare_head_outputs(tag, model, cfg, batch):
    """The anchor head's raw outputs, scores untied, through the kernels
    and through the plain path (same model, same batch): ``cls_score``,
    ``bbox_pred`` and ``dir_pred`` each within 2e-3 of its max-abs.  Logs
    the gap between the ``nms_pre``-th and the next score of each path's
    stable descending sort, and whether both paths put the same anchors
    above it (how many differ if not)."""
    with torch.no_grad():
        outs, _ = model(batch)
        with plain_path():
            ref, _ = model(batch)
    torch.cuda.synchronize()
    head = {}
    for key, got, want in zip(('cls_score', 'bbox_pred', 'dir_pred'), outs,
                              ref):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > 2e-3 * scale:
            raise AssertionError(f'{tag}: {key} differs from the plain path '
                                 f'by {err:.3g} (max-abs {scale:.3g})')
        head[key] = dict(max_abs_err=err, max_abs=scale,
                         relative=err / scale)
    k = cfg.anchor_head.nms_pre

    def ranked(cls_score):
        scores = torch.sigmoid(cls_score.reshape(
            cls_score.shape[0], -1, cfg.anchor_head.num_classes)).amax(-1)[0]
        return torch.sort(scores, descending=True, stable=True)

    vals, idx = ranked(outs[0])
    ref_vals, ref_idx = ranked(ref[0])
    common = len(set(idx[:k].tolist()) & set(ref_idx[:k].tolist()))
    out = dict(head=head, k=k, n_anchors=int(vals.numel()),
               kth_score=float(vals[k - 1]),
               gap_at_k=float(vals[k - 1] - vals[k]),
               plain_gap_at_k=float(ref_vals[k - 1] - ref_vals[k]),
               same_top_k=common == k, top_k_differing=k - common)
    log(f'{tag} untied head vs plain path: {json.dumps(out)}')
    return out


def serve_vs_plain(name, b1, b_timed, launches, tie=False):
    """Preset ``name`` served at full width and depth: ``b1`` (a b=1
    batch) float32 through the kernels against the plain path, then
    ``b_timed`` bfloat16 timed with a decode that must not wait for the
    device; launches per forward asserted at both sizes.  ``tie``: the
    float32 comparison with :func:`tied_scores`, for a decode whose
    random-weight candidates' scores may lie closer together than the
    float32 kernel path's rounding moves them (nuScenes: 1,000 of 48,672
    anchors, against 100 on KITTI); then the head's raw outputs untied
    (:func:`compare_head_outputs`)."""
    cfg = get_preset(name).model
    model = build_model(cfg, device='cuda', seed=SEED)
    zero_cls_bias(model)
    level_angle_head(model)
    dcn_offsets(model)
    with tied_scores(model) if tie else contextlib.nullcontext():
        c1, res1 = compare_with_plain_path(f'{name} b=1 float32', model,
                                           cfg, b1)
    if tie:
        res1['untied_head_outputs'] = compare_head_outputs(
            f'{name} b=1 float32', model, cfg, b1)
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
    noise = set(validate_multihost.biases_before_bn(model))
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


# --------------------------------------------------------------------------
# phase 10: the evaluation path (tools/test.py on splits written to disk)
# --------------------------------------------------------------------------

# the launches of one forward batch: B1 once, B3 twice on the KITTI and
# nuScenes necks, the clip's NMS-mask entry where the NMS is rotated
# (ScanNet's is axis-aligned) and the scan once
_BATCH = dict(backproject=1, backproject_grad=0, rect_clip=1,
              rect_clip_grad=0, nms_scan=1)
EVAL_BATCH_LAUNCHES = {
    'kitti': dict(_BATCH, conv3x3x3=2),
    'sunrgbd': dict(_BATCH, conv3x3x3=0),
    'total3d': dict(_BATCH, conv3x3x3=0),
    'scannet': dict(_BATCH, conv3x3x3=0, rect_clip=0),
    'nuscenes': dict(_BATCH, conv3x3x3=2),
}
# the 8x-listed KITTI split, for run_inference's steady state
EVAL_KITTI_REPEAT = 8
# preset, split writer, its arguments, batch size
EVAL_SPLITS = {
    'kitti': ('imvoxelnet_kitti', splits.kitti_split, dict(n=32), 8),
    'sunrgbd': ('imvoxelnet_sunrgbd', splits.sunrgbd_split, dict(n=16), 8),
    'total3d': ('imvoxelnet_total_sunrgbd_fast', splits.sunrgbd_split,
                dict(n=4, n_classes=33, total3d=True), 4),
    'scannet': ('imvoxelnet_scannet_fast', splits.scannet_split,
                dict(n_scenes=1, views=50), 1),
    'nuscenes': ('imvoxelnet_nuscenes', splits.nuscenes_split, dict(n=2),
                 1),
}
BF16 = 'model.compute_dtype=bfloat16'
REPO = os.path.dirname(os.path.abspath(__file__))


def card_modules():
    """Which of cv2, PIL and ml_dtypes this machine has (each imported in a
    fresh interpreter, so that none enters this one)."""
    out = {}
    for name in ('cv2', 'PIL', 'ml_dtypes'):
        proc = subprocess.run(
            [sys.executable, '-c', f'import {name}; print(getattr({name}, '
             f'"__version__", "present"))'], capture_output=True, text=True)
        out[name] = (proc.stdout.strip() if proc.returncode == 0 else
                     'missing: ' + (proc.stderr.strip().splitlines() or
                                    ['?'])[-1])
    return out


def write_splits(root):
    """Every family's split under ``root``, written in parallel:
    ``{key: (data_root, ann_file)}``."""
    def write(key):
        data_root = os.path.join(root, key)
        _, writer, kwargs, _ = EVAL_SPLITS[key]
        return data_root, writer(data_root, seed=SEED, **kwargs)
    with ThreadPoolExecutor(len(EVAL_SPLITS)) as pool:
        futures = {k: pool.submit(write, k) for k in EVAL_SPLITS}
        return {k: f.result() for k, f in futures.items()}


def eval_weights(name, path):
    """The preset's seeded weights as a reference-style checkpoint
    (``{'state_dict': ...}``), with the cls bias at 0 (detections pass the
    score threshold), a level Total3D angle head and nonzero DCN offsets."""
    model = build_model(get_preset(name).model, device='cpu', seed=SEED)
    zero_cls_bias(model)
    level_angle_head(model)
    dcn_offsets(model)
    torch.save({'state_dict': model.state_dict(),
                'meta': {'seed': SEED}}, path)


def protocol_clip_calls(key, dataset, results):
    """The clip's pairwise launches that the split's protocol makes: one per
    image with detections and GT (indoor), one for ``layout_ious``
    (Total3D); KITTI's overlaps are on the host, nuScenes' are distances."""
    if key in ('kitti', 'nuscenes'):
        return dict(per_image=0, layout=0)
    gt = runner._gt_annos(dataset)
    return dict(per_image=sum(len(r['boxes']) > 0 and len(g['boxes']) > 0
                              for r, g in zip(results, gt)),
                layout=int(key == 'total3d'))


def run_test_tool(key, split, pth, workers=8, name=None):
    """``imvoxelnet_tpu_torch.tools.test``'s ``main`` on a split, bfloat16,
    with the kernels' launch counts over the run, asserted: a forward
    batch's launches per batch, and the protocol's pairwise clip calls
    (:func:`protocol_clip_calls`).  ``name``: another preset of the
    family than ``EVAL_SPLITS``'.  The tool's printout is kept out of the
    log."""
    name, batch = name or EVAL_SPLITS[key][0], EVAL_SPLITS[key][3]
    args = [name, '--data-root', split[0], '--ann-file', split[1],
            '--torch-checkpoint', pth, '--batch-size', str(batch),
            '--num-workers', str(workers), '--override', BF16]
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = test_tool.main(args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    metrics = summary['metrics']
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad or not metrics:
        raise AssertionError(f'{key}: non-finite metrics {bad}')
    dataset, _ = runner.build_val_dataset(get_preset(name), name, *split)
    calls = protocol_clip_calls(key, dataset, summary['results'])
    want = {k: v * summary['n_batches']
            for k, v in EVAL_BATCH_LAUNCHES[key].items()}
    want['rect_clip'] += calls['per_image'] + calls['layout']
    assert_launches(f'eval {key}', counts, want)
    log(f'eval {key}: {name} {summary["n_samples"]} samples in '
        f'{summary["n_batches"]} batches of {batch}: inference '
        f'{summary["inference_s"]:.3f} s, protocol {summary["eval_s"]:.3f} '
        f's, {sum(len(r["scores"]) for r in summary["results"])} '
        f'detections; launches {json.dumps(counts)}')
    return summary, counts, calls


def gt_as_prediction(dataset, kitti=False):
    """The GT of each sample as its detections, each with its own score;
    KITTI's boxes with the yaw that the conversion's -pi hack undoes."""
    out, n = [], 0
    for i in range(len(dataset.data_infos)):
        ann = dataset.get_ann_info(i)
        boxes = ann['gt_bboxes_3d'].copy()
        if kitti:
            boxes[:, 6] += np.pi
        scores = 0.9 - 1e-4 * np.arange(n, n + len(boxes))
        n += len(boxes)
        out.append(dict(boxes=boxes, labels=ann['gt_labels_3d'],
                        scores=scores.astype(np.float32)))
    return out


def busy_share(prof, wall_ms):
    """The share of ``wall_ms`` in which the card ran a kernel: the union of
    the kernels' intervals (copies and memsets left out) from the trace,
    and the sum of their times as ``key_averages`` gives it."""
    spans = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation
        and not ev.name.startswith(('Memcpy', 'Memset')))
    union, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and not ev.is_user_annotation
                and not ev.key.startswith(('Memcpy', 'Memset')))
    return dict(union=union / 1e3 / wall_ms, summed=total / 1e3 / wall_ms,
                kernels=len(spans))


def repeated_split(split, times):
    """The split's info file listed ``times`` over, beside it."""
    data_root, ann_file = split
    path = ann_file.replace('.pkl', f'_x{times}.pkl')
    with open(path, 'wb') as f:
        pickle.dump(datasets.load_infos(ann_file) * times, f)
    return data_root, path


def timed_inference(model, cfg, loader, n, profile=False):
    """One ``run_inference`` epoch: seconds on the host clock to the last
    result, and with ``profile`` the card's busy share of them."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with (torch.profiler.profile(activities=acts) if profile
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        runner.run_inference(model, cfg, loader, n)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return seconds, (busy_share(prof, seconds * 1e3) if profile else None)


def kitti_eval_timing(split, pth):
    """imvoxelnet_kitti's serving from files, b=8 bfloat16, on the split (4
    batches) and on it listed ``EVAL_KITTI_REPEAT`` times (32 batches): the
    loader alone at 8 workers, ``run_inference`` warm (host clock to
    the last result) and under the profiler (the card's busy share), and
    the forward + decode alone on the long epoch's batches already on the
    card.  The two epochs' difference is the steady state: its frames/s,
    its busy share, and the fill + drain seconds that the short epoch
    holds beyond its batches at that rate."""
    name = EVAL_SPLITS['kitti'][0]
    preset = apply_overrides(get_preset(name), [BF16])
    cfg = preset.model
    long_split = repeated_split(split, EVAL_KITTI_REPEAT)
    out = dict(cpu_count=os.cpu_count())
    _, loader = runner.build_val_dataset(preset, name, *long_split,
                                         num_workers=8, batch_size=8)
    t0 = time.perf_counter()
    n = sum(b['images'].shape[0] for b in loader.epoch(0))
    out['loader_frames_per_s_8_workers'] = n / (time.perf_counter() - t0)
    model = build_model(cfg, device='cpu', seed=SEED)
    model.load_state_dict(ckpt_lib.load_reference_state_dict(pth),
                          strict=True)
    model.to('cuda')
    epochs = {}
    for key, sp in (('short', split), ('long', long_split)):
        dataset, loader = runner.build_val_dataset(preset, name, *sp,
                                                   num_workers=8,
                                                   batch_size=8)
        epochs[key] = (loader, len(dataset.data_infos))
    timed_inference(model, cfg, *epochs['short'])          # warm
    wall, busy = {}, {}
    for key in ('short', 'long'):
        wall[key], _ = timed_inference(model, cfg, *epochs[key])
        out[f'run_inference_frames_per_s_{key}'] = epochs[key][1] / wall[key]
    for key in ('short', 'long'):
        seconds, busy[key] = timed_inference(model, cfg, *epochs[key],
                                             profile=True)
        out[f'profiled_frames_per_s_{key}'] = epochs[key][1] / seconds
        out[f'busy_share_{key}'] = busy[key]
        busy[key] = (busy[key]['union'] * seconds, seconds)
    n_short, n_long = epochs['short'][1], epochs['long'][1]
    per_frame = (wall['long'] - wall['short']) / (n_long - n_short)
    out['steady_frames_per_s'] = 1 / per_frame
    out['fill_drain_s'] = wall['short'] - n_short * per_frame
    out['fill_drain_share_of_long'] = out['fill_drain_s'] / wall['long']
    out['steady_busy_share'] = ((busy['long'][0] - busy['short'][0])
                                / (busy['long'][1] - busy['short'][1]))
    loader, n = epochs['long']
    batches = [loader_lib.to_device(b, 'cuda') for b in loader.epoch(0)]
    runner.forward(model, cfg, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        runner.forward(model, cfg, b)
    torch.cuda.synchronize()
    out['forward_decode_frames_per_s'] = n / (time.perf_counter() - t0)
    out['frames'] = dict(short=n_short, long=n_long)
    del model, batches
    log(f'eval kitti serving from files: {json.dumps(out)}')
    return out


CV2_CHECK = r"""
import json, os, sys
import numpy as np
try:
    import cv2
except ImportError as e:
    print(json.dumps({'cv2': f'missing: {e}'}))
    sys.exit(0)
from imvoxelnet_tpu_torch.data import image_io
from imvoxelnet_tpu_torch.utils.synthetic import write_png
paths, resizes, tmp = json.loads(sys.argv[1])
rng = np.random.RandomState(0)
for c in (1, 2, 3, 4):
    img = rng.randint(0, 256, (37, 53, c)).astype(np.uint8)
    paths.append(os.path.join(tmp, f'port_{c}.png'))
    write_png(paths[-1], img[..., 0] if c == 1 else img)
    if c != 2:
        paths.append(os.path.join(tmp, f'libpng_{c}.png'))
        cv2.imwrite(paths[-1], img[..., 0] if c == 1 else img)
out = dict(cv2=cv2.__version__, decoded=0, resized=0, pixels=0)
for path in paths:
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    got = image_io.load_image(path)
    if got.shape != ref.shape or (got != ref).any():
        sys.exit(f'{path}: load_image differs from cv2.imread')
    out['decoded'] += 1
for path, factor in resizes:
    img = image_io.load_image(path)
    got = image_io.imresize(img, factor)
    ref = cv2.resize(img, got.shape[1::-1], interpolation=cv2.INTER_LINEAR)
    if got.shape != (int(img.shape[0] * factor + 0.5),
                     int(img.shape[1] * factor + 0.5), 3) or (
            got != ref).any():
        sys.exit(f'{path} x {factor}: imresize differs from cv2.resize')
    out['resized'] += 1
    out['pixels'] += got.size
print(json.dumps(out))
"""
# a frame of each split and its test resize (the KITTI train scales'
# extremes on the KITTI frame; ScanNet's and nuScenes' are identities)
CV2_RESIZES = {'kitti': (1.024, min(1173 / 1242, 352 / 375),
                         min(1387 / 1242, 416 / 375)),
               'sunrgbd': (min(640 / 730, 480 / 530),),
               'scannet': (1.0,), 'nuscenes': (1.0,)}


def check_image_io_against_cv2(data):
    """Where this machine has cv2: the port's PNG decode and resize against
    it, bit for bit, in a separate interpreter (cv2 never enters this one):
    frames of the splits (the port's writer), the port's and libpng's files
    of 1-4 channels, and each split's test resize."""
    paths, resizes = [], []
    for key, factors in CV2_RESIZES.items():
        frames = sorted(
            os.path.join(d, f) for d, _, files in os.walk(data[key][0])
            for f in files if f.endswith(('.png', '.jpg')))[:2]
        paths += frames
        resizes += [(frames[0], f) for f in factors]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, '-c', CV2_CHECK,
             json.dumps([paths, resizes, tmp])],
            capture_output=True, text=True, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f'eval: image_io against cv2: '
                             f'{proc.stderr.strip()[-2000:]}')
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f'eval: image_io against this machine\'s cv2: {json.dumps(out)}')
    return out


def kitti_ap_ceiling(infos, difficulty):
    """The 11-point AP of a perfect detector on these GT: the protocol
    fills ``T = len(get_thresholds)`` recall positions (at most 41), so it
    reaches ``ceil(T / 4) / 11 * 100``."""
    empty = dict(name=np.array([]), bbox=np.zeros((0, 4)))
    n = sum(kitti_eval.clean_data(info['annos'], empty, 0, difficulty)[0]
            for info in infos)
    t = len(kitti_eval.get_thresholds(np.linspace(0.9, 0.5, n), n))
    return 100.0 * len(range(0, t, 4)) / 11


def check_kitti_eval(summary, split):
    """The reference's metric names, and the GT as the prediction at the
    protocol's ceiling (AOS too)."""
    names = {f'KITTI/Car_{t}_{d}' for t in ('BBOX', 'BEV', '3D')
             for d in ('easy', 'moderate', 'hard')}
    missing = names - set(summary['metrics'])
    if missing:
        raise AssertionError(f'eval kitti: metrics missing {sorted(missing)}')
    dataset, _ = runner.build_val_dataset(
        get_preset(EVAL_SPLITS['kitti'][0]), 'imvoxelnet_kitti', *split)
    t0 = time.perf_counter()
    dt = kitti_eval.convert_to_kitti_annos(gt_as_prediction(dataset, True),
                                           dataset.data_infos, ('Car',))
    gt = [info['annos'] for info in dataset.data_infos]
    metrics = kitti_eval.kitti_eval(gt, dt, ['Car'],
                                    eval_types=('bbox', 'bev', '3d', 'aos'))
    seconds = time.perf_counter() - t0
    for d, diff in enumerate(('easy', 'moderate', 'hard')):
        ceiling = kitti_ap_ceiling(dataset.data_infos, d)
        got = metrics[f'KITTI/Car_3D_{diff}']
        if abs(got - ceiling) > 1e-6 or f'KITTI/Car_AOS_{diff}' not in \
                metrics:
            raise AssertionError(f'eval kitti: GT as prediction 3D {diff} '
                                 f'{got} != ceiling {ceiling}, or no AOS')
    out = {k: metrics[f'KITTI/Car_{k}'] for k in
           ('3D_easy', '3D_moderate', '3D_hard', 'AOS_moderate')}
    log(f'eval kitti: GT as prediction {json.dumps(out)} '
        f'({seconds:.3f} s of protocol)')
    return out


def pairwise_row(c1, c2, shape, launches):
    """A ``kernels`` row of the clip's pairwise entry on ``(G, N, 4, 2)``
    and ``(G, M, 4, 2)`` corners, against its plain version."""
    got = clip_kernel.rect_intersection_area_pairwise(c1, c2)
    ref = iou_ops.rect_intersection_area_pairwise_plain(c1, c2)
    torch.cuda.synchronize()
    assert_same_bits(f'rect_clip pairwise {shape}', got, ref)
    g, n, m = got.shape
    row = clip_row(
        'rect_clip', CLIP_REPLACES, f'pairwise, {shape}, {g * n * m} pairs '
        f'float32',
        time_ms(lambda: clip_kernel.rect_intersection_area_pairwise(c1, c2),
                SMALL_REPS, queue_us=QUEUE_US),
        time_ms(lambda: iou_ops.rect_intersection_area_pairwise_plain(
            c1, c2), 5),
        nbytes(c1, c2, got), g * n * m * CLIP_FLOPS,
        launch_bound_ms=time_ms(
            lambda: clip_kernel.rect_intersection_area_pairwise(c1, c2),
            SMALL_REPS))
    row['eval_launches'] = launches
    return row


def corners_of(boxes):
    return box_ops.bev_corners(box_ops.bev(torch.as_tensor(
        np.asarray(boxes, np.float32), device='cuda')))


def check_indoor_eval(summary, calls, split):
    """The SUN RGB-D protocol on the card (the clip's pairwise entry, one
    launch per image with detections and GT: ``calls``, asserted in the
    test tool's run) against the same call on CPU tensors (the plain clip):
    IoU matrices within 1e-5, metrics within 1e-6; the GT as the
    prediction at mAP 1.  Returns the pairwise entry's row at the largest
    image's shape, with the run's launches."""
    name = EVAL_SPLITS['sunrgbd'][0]
    preset = get_preset(name)
    dataset, _ = runner.build_val_dataset(preset, name, *split)
    gt = runner._gt_annos(dataset)
    results = summary['results']
    launches = calls['per_image']
    ious = indoor_eval.image_ious(gt, results, 'cuda')
    ref = indoor_eval.image_ious(gt, results, 'cpu')
    if sum(i is not None for i in ref) != launches or launches == 0:
        raise AssertionError(f'eval sunrgbd: {launches} launches in the run '
                             f'for {sum(i is not None for i in ref)} IoU '
                             f'calls')
    err = max(float(np.abs(a - b).max()) for a, b in zip(ious, ref)
              if b is not None)
    if err > 1e-5:
        raise AssertionError(f'eval sunrgbd: IoU on the card differs from '
                             f'the plain clip by {err:.3g}')
    thrs = (0.25, 0.5)
    metrics = indoor_eval.indoor_eval(gt, results, preset.data.classes, thrs,
                                      device='cuda')
    cpu = indoor_eval.indoor_eval(gt, results, preset.data.classes, thrs,
                                  device='cpu')
    gap = max(abs(metrics[k] - cpu[k]) for k in cpu)
    if set(metrics) != set(cpu) or gap > 1e-6 or metrics != \
            summary['metrics']:
        raise AssertionError(f'eval sunrgbd: card and CPU protocols differ '
                             f'by {gap:.3g}')
    perfect = indoor_eval.indoor_eval(gt, gt_as_prediction(dataset),
                                      preset.data.classes, thrs)
    if not perfect['mAP_0.25'] == perfect['mAP_0.50'] == 1.0:
        raise AssertionError(f'eval sunrgbd: GT as prediction {perfect}')
    big = max(range(len(ref)), key=lambda i: 0 if ref[i] is None
              else ref[i].size)
    row = pairwise_row(corners_of(results[big]['boxes'])[None],
                       corners_of(gt[big]['boxes'])[None],
                       f'G=1 N={ref[big].shape[0]} M={ref[big].shape[1]}, '
                       f'the largest of the SUN RGB-D split\'s {launches} '
                       f'per-image IoU calls', launches)
    out = dict(iou_calls=launches, max_iou_err_vs_cpu=err,
               max_metric_gap_vs_cpu=gap, mAP_025=metrics['mAP_0.25'],
               gt_as_prediction_mAP=[perfect['mAP_0.25'],
                                     perfect['mAP_0.50']],
               pairs=sum(i.size for i in ref if i is not None))
    log(f'eval sunrgbd protocol on the card: {json.dumps(out)}')
    return out, row


def check_layout_ious(summary, calls, split):
    """Total3D's layout_iou through the clip's pairwise entry, one launch
    in the test tool's run (``calls``, asserted there): the served layouts'
    IoUs against the plain clip on the CPU within 1e-5, and the GT layout
    against itself at 1.  Returns the entry's row on the served layouts
    and the GT, the inputs of the run's call."""
    name = EVAL_SPLITS['total3d'][0]
    dataset, _ = runner.build_val_dataset(get_preset(name), name, *split)
    gt = np.stack([info['layout'] for info in dataset.data_infos])
    pred = np.stack([r['layout'] for r in summary['results']])
    served = runner.layout_ious(pred, gt, 'cuda')
    err = float(np.abs(served - runner.layout_ious(pred, gt, 'cpu')).max())
    if err > 1e-5 or abs(float(np.mean(served))
                         - summary['metrics']['layout_iou']) > 1e-6:
        raise AssertionError(f'eval total3d: layout IoU gap {err:.3g}, or '
                             f'the run\'s layout_iou differs')
    perfect = runner.layout_ious(gt, gt, 'cuda')
    if np.abs(perfect - 1).max() > 1e-5:
        raise AssertionError(f'eval total3d: GT layout IoU {perfect}')
    # the bottoms that layout_ious hands the clip
    pred = pred.astype(np.float32)
    pred[:, 2] -= pred[:, 5] / 2
    gt = gt.astype(np.float32)
    gt[:, 2] -= gt[:, 5] / 2
    row = pairwise_row(corners_of(pred)[:, None].contiguous(),
                       corners_of(gt)[:, None].contiguous(),
                       f'G={len(gt)} N=M=1, layout_ious of the Total3D '
                       f'split\'s served layouts', calls['layout'])
    log(f'eval total3d: layout_iou {summary["metrics"]["layout_iou"]:.4g}, '
        f'GT layout {perfect.tolist()}, card vs CPU {err:.3g}')
    return dict(layout_iou=summary['metrics']['layout_iou'],
                gt_layout_iou=perfect.tolist(), max_err_vs_cpu=err), row


def check_nuscenes_eval(split):
    """NDS of the GT as the prediction: 1, as ``tests/test_e2e_nuscenes.py``
    has it."""
    name = EVAL_SPLITS['nuscenes'][0]
    dataset, _ = runner.build_val_dataset(get_preset(name), name, *split)
    gt = runner._gt_annos(dataset)
    metrics = nuscenes_eval.nuscenes_nds(gt, gt_as_prediction(dataset),
                                         ('car',))
    if abs(metrics['mAP'] - 1) > 1e-6 or abs(metrics['NDS'] - 1) > 1e-6:
        raise AssertionError(f'eval nuscenes: GT as prediction {metrics}')
    return dict(mAP=metrics['mAP'], NDS=metrics['NDS'],
                gt_boxes=sum(len(g['boxes']) for g in gt))


def run_eval():
    """Phase 10: splits of every family written to a temporary directory,
    seeded reference-style checkpoints, and the test tool on each; then
    the KITTI loader and serving rates, the protocols' checks on the card,
    and the pairwise clip rows.  Returns the summary, the KITTI launch
    counts and the new ``kernels`` rows."""
    out, counts = {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = write_splits(root)
        out['write_splits_s'] = time.perf_counter() - t0
        log(f'eval: splits written in {out["write_splits_s"]:.1f} s')
        out['image_io_vs_cv2'] = check_image_io_against_cv2(data)
        summaries, calls = {}, {}
        for key in EVAL_SPLITS:
            pth = os.path.join(root, f'{key}.pth')
            eval_weights(EVAL_SPLITS[key][0], pth)
            summaries[key], counts[key], calls[key] = run_test_tool(
                key, data[key], pth)
            if key == 'kitti':
                out['kitti_serving'] = kitti_eval_timing(data[key], pth)
        out['kitti'] = check_kitti_eval(summaries['kitti'], data['kitti'])
        out['sunrgbd'], indoor_row = check_indoor_eval(
            summaries['sunrgbd'], calls['sunrgbd'], data['sunrgbd'])
        out['total3d'], layout_row = check_layout_ious(
            summaries['total3d'], calls['total3d'], data['total3d'])
        out['nuscenes_gt_as_prediction'] = check_nuscenes_eval(
            data['nuscenes'])
        for key, s in summaries.items():
            out.setdefault('runs', {})[key] = dict(
                samples=s['n_samples'], batches=s['n_batches'],
                inference_s=s['inference_s'], protocol_s=s['eval_s'],
                frames_per_s=s['n_samples'] / s['inference_s'],
                launches=counts[key], protocol_clip_calls=calls[key])
    leaked = sorted(m for m in ('cv2', 'ml_dtypes', 'jax', 'PIL')
                    if m in sys.modules)
    if leaked:
        raise AssertionError(f'eval: the port imported {leaked}')
    return out, counts['kitti'], [indoor_row, layout_row]


# --------------------------------------------------------------------------
# phase 11: training from files (tools/train.py on splits written to disk)
# --------------------------------------------------------------------------

# a KITTI training step: B1, its backward, B3 forward twice and dx twice
TRAIN_STEP_LAUNCHES = {
    'kitti': dict(backproject=1, backproject_grad=1, conv3x3x3=4,
                  rect_clip=0, rect_clip_grad=0, nms_scan=0),
    'sunrgbd': dict(INDOOR_TRAIN_LAUNCHES),
    'scannet': dict(SCANNET_TRAIN_LAUNCHES),
}
# family: preset, split writer and its arguments, batch per card, how often
# the split is listed for the short and the long epoch (repeat_times 1)
TRAIN_SPLITS = {
    'kitti': ('imvoxelnet_kitti', splits.kitti_split, dict(n=48), 4,
              (1, 3)),
    'sunrgbd': ('imvoxelnet_sunrgbd', splits.sunrgbd_split, dict(n=16), 4,
                (2, 8)),
    'scannet': ('imvoxelnet_scannet', splits.scannet_split,
                dict(n_scenes=2, views=20), 1, (4, 16)),
}
KITTI_VAL_FRAMES = 16
CLI_EPOCHS = 2
LOG_INTERVAL = 10
STEP_SPAN = 'phase11_step'


@contextlib.contextmanager
def cli_probe(prof=None):
    """Within the block, each step that ``tools/train.py`` builds runs in a
    ``STEP_SPAN`` profiler span (and steps ``prof``'s schedule after it),
    and each ``run_inference`` call (the CLI's validation) records the
    launch counts it adds and its batches: ``probe['val']``,
    ``probe['val_batches']``.  The counts are the CLI run's own."""
    probe = dict(val={k: 0 for k in kernels.WRAPPERS}, val_batches=0)
    make_step, run_inference = train_lib.make_train_step, runner.run_inference

    def make(*args):
        step = make_step(*args)

        def spanned(batch):
            with torch.profiler.record_function(STEP_SPAN):
                out = step(batch)
            if prof is not None:
                prof.step()
            return out
        return spanned

    def inference(model, cfg, loader, n, device='cuda'):
        before = kernels.launch_counts()
        out = run_inference(model, cfg, loader, n, device)
        for k, v in kernels.launch_counts().items():
            probe['val'][k] += v - before[k]
        probe['val_batches'] += len(loader)
        return out

    train_lib.make_train_step, runner.run_inference = make, inference
    try:
        yield probe
    finally:
        train_lib.make_train_step, runner.run_inference = (make_step,
                                                           run_inference)


def run_train_tool(args, prof=None):
    """``tools.train.main(args)``, its printout kept out of the log, with
    the launches of its steps and of its validation batches apart."""
    kernels.reset_launch_counts()
    with cli_probe(prof) as probe, contextlib.redirect_stdout(io.StringIO()):
        summary = train_tool.main(args)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    summary['step_launches'] = {k: total[k] - probe['val'][k] for k in total}
    summary['val_launches'] = probe['val']
    summary['val_batches'] = probe['val_batches']
    return summary


def assert_cli_launches(tag, summary, step, val=None):
    steps = sum(e['steps'] for e in summary['epochs'])
    assert_launches(f'{tag}: per step', {
        k: v / steps for k, v in summary['step_launches'].items()}, step)
    if val is not None:
        if not summary['val_batches']:
            raise AssertionError(f'{tag}: no validation batch')
        assert_launches(f'{tag}: per validation batch', {
            k: v / summary['val_batches']
            for k, v in summary['val_launches'].items()}, val)


def check_train_lines(tag, summary, keys):
    for line in summary['train']:
        if set(line) != keys or not all(
                np.isfinite(line[k]) for k in keys - {'epoch', 'iter',
                                                      'step'}):
            raise AssertionError(f'{tag}: log line {line}')
    for line in summary['val']:
        if line['mode'] != 'val' or not all(
                np.isfinite(v) for k, v in line.items() if k != 'mode'):
            raise AssertionError(f'{tag}: validation line {line}')


def same_tensors(a, b):
    """How many of the tensors of ``a`` equal ``b``'s bit for bit, and the
    names of those that do not."""
    differ = [k for k, v in a.items() if not torch.equal(v, b[k])]
    return len(a) - len(differ), differ


def compare_train_states(straight, resumed):
    """Two train states (``latest.pth`` files, ``latest.dcp`` directories
    or their payloads): parameters, buffers and every AdamW tensor (moments
    and steps) bit for bit, and the schedule's count and step."""
    def read(state):
        if isinstance(state, dict):
            return state
        if os.path.isdir(state):
            return ckpt_lib.read_checkpoint_sharded(state)
        return ckpt_lib.load_checkpoint(state)
    a, b = read(straight), read(resumed)
    params = {k for k in a['state_dict']
              if not k.endswith(('running_mean', 'running_var',
                                 'num_batches_tracked'))}
    out = {}
    for name, keys in (('parameters', params),
                       ('buffers', set(a['state_dict']) - params)):
        n, differ = same_tensors({k: a['state_dict'][k] for k in keys},
                                 b['state_dict'])
        out[name] = dict(equal=n, total=len(keys), differ=differ[:10])
    flat = {(i, k): v for i, st in a['optimizer']['state'].items()
            for k, v in st.items()}
    other = {(i, k): v for i, st in b['optimizer']['state'].items()
             for k, v in st.items()}
    n, differ = same_tensors(flat, other)
    out['adamw'] = dict(equal=n, total=len(flat), differ=differ[:10])
    out['same_schedule_and_step'] = (
        a['scheduler'] == b['scheduler'] and a['step'] == b['step']
        and a['optimizer']['param_groups'] == b['optimizer']['param_groups'])
    return out


def write_train_splits(root):
    """The three families' splits and KITTI's val split, in parallel:
    ``{key: (data_root, ann_file)}``."""
    jobs = {key: (writer, os.path.join(root, key), dict(kw, seed=SEED))
            for key, (_, writer, kw, _, _) in TRAIN_SPLITS.items()}
    jobs['kitti_val'] = (splits.kitti_split, os.path.join(root, 'kitti_val'),
                         dict(n=KITTI_VAL_FRAMES, seed=SEED + 1))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(w, r, **kw) for k, (w, r, kw) in
                   jobs.items()}
        return {k: (jobs[k][1], f.result()) for k, f in futures.items()}


def kitti_cli(data, work, epochs, *extra):
    """``tools/train.py`` on imvoxelnet_kitti at full width, b=4 bfloat16,
    the 48-frame split with the preset's 3 repeats, validation every epoch
    on the 16-frame split at b=8."""
    return ['imvoxelnet_kitti', '--data-root', data['kitti'][0],
            '--ann-file', data['kitti'][1], '--work-dir', work, '--epochs',
            str(epochs), '--batch-size', '4', '--num-workers', '8',
            '--log-interval', str(LOG_INTERVAL), '--override', BF16,
            '--val-data-root', data['kitti_val'][0], '--val-ann-file',
            data['kitti_val'][1], '--val-batch-size', '8', *extra]


def kitti_cli_runs(data, root):
    """(a): the CLI for 2 epochs with validation; the same for 1 epoch and
    then for 2 in a second work dir (auto-resume), held to the first bit
    for bit; ``tools/test.py --checkpoint`` on the val split, held to the
    last validation line.  Under ``cudnn.deterministic``, as the repeat
    checks of phases 4 and 9 run, so that two runs of one step give the
    same bits."""
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        straight = run_train_tool(kitti_cli(
            data, os.path.join(root, 'straight'), CLI_EPOCHS))
        out['straight_s'] = time.perf_counter() - t0
        keys = {'epoch', 'iter', 'step', 'data_time', 'time', 'loss_cls',
                'loss_bbox', 'loss_dir', 'loss'}
        check_train_lines('train cli kitti', straight, keys)
        assert_cli_launches('train cli kitti', straight,
                            TRAIN_STEP_LAUNCHES['kitti'],
                            EVAL_BATCH_LAUNCHES['kitti'])
        if not os.path.exists(straight['latest']) or \
                len(straight['val']) != CLI_EPOCHS:
            raise AssertionError('train cli kitti: no latest.pth or a '
                                 'validation line missing')
        resumed_dir = os.path.join(root, 'resumed')
        first = run_train_tool(kitti_cli(data, resumed_dir, 1))
        second = run_train_tool(kitti_cli(data, resumed_dir, CLI_EPOCHS))
        if second['start_epoch'] != 1:
            raise AssertionError(f'train cli kitti: resumed at epoch '
                                 f'{second["start_epoch"]}, not 1')
        same = compare_train_states(straight['latest'], second['latest'])
        epoch2 = [line for line in straight['train'] if line['epoch'] == 1]
        strip = lambda lines: [{k: v for k, v in x.items()  # noqa: E731
                                if k not in ('data_time', 'time')}
                               for x in lines]
        same['epoch2_losses_equal'] = strip(epoch2) == strip(second['train'])
        same['epoch2_validation_equal'] = straight['val'][-1] == \
            second['val'][-1]
        bad = [k for k in ('parameters', 'buffers', 'adamw')
               if same[k]['equal'] != same[k]['total']] + [
            k for k in ('same_schedule_and_step', 'epoch2_losses_equal',
                        'epoch2_validation_equal') if not same[k]]
        log(f'train cli kitti: resume against the straight run '
            f'{json.dumps(same)}')
        if bad:
            raise AssertionError(f'train cli kitti: the resumed run differs '
                                 f'from the straight run in {bad}')
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            tested = test_tool.main([
                'imvoxelnet_kitti', '--data-root', data['kitti_val'][0],
                '--ann-file', data['kitti_val'][1], '--checkpoint',
                straight['latest'], '--batch-size', '8', '--num-workers', '8',
                '--override', BF16])
        last = {k: v for k, v in straight['val'][-1].items()
                if k not in ('mode', 'epoch', 'step')}
        if {k: float(v) for k, v in tested['metrics'].items()} != last:
            raise AssertionError('train cli kitti: tools/test.py '
                                 '--checkpoint differs from the last '
                                 'validation line')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    epochs = straight['epochs']
    out.update(
        steps_per_epoch=straight['steps_per_epoch'],
        epochs=epochs, losses_first=straight['train'][0],
        losses_last=straight['train'][-1], val=straight['val'],
        launches_per_step={k: v / sum(e['steps'] for e in epochs)
                           for k, v in straight['step_launches'].items()},
        launches_per_val_batch={k: v / straight['val_batches'] for k, v in
                                straight['val_launches'].items()},
        val_batches=straight['val_batches'], resume=same,
        first_run_epochs=first['epochs'],
        test_tool_checkpoint_equals_last_val=True,
        test_tool_detections=sum(len(r['scores'])
                                 for r in tested['results']))
    log(f'train cli kitti: {json.dumps(out)}')
    return out, straight['latest']


def trace_window(path, n_steps):
    """The ``n_steps`` ``STEP_SPAN`` spans of a chrome trace as one window
    (``tools/analyze_trace.py:window``)."""
    return analyze_trace.window(analyze_trace.load_events(path), STEP_SPAN,
                                n_steps)


def profiled_cli(args, trace_path):
    """``run_train_tool(args)`` under the profiler, recording the steps
    ``LOG_INTERVAL + 1`` to ``2 * LOG_INTERVAL`` (between the first two
    log lines) into ``trace_path``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=LOG_INTERVAL - 1, warmup=1, active=LOG_INTERVAL,
                repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(
                trace_path)) as prof:
        summary = run_train_tool(args, prof)
    return summary, trace_window(trace_path, LOG_INTERVAL)


LOADER_WARM_BATCHES = 2


def loader_rate(preset, split, b, workers):
    """The train-mode loader alone over one whole epoch of ``split``
    (pinned bfloat16 batches, as the CLI's): scenes/s after its first
    ``LOADER_WARM_BATCHES`` (thread start and the first decodes), and the
    number of batches that rate covers."""
    dataset = train_tool.build_train_dataset(preset, *split)
    loader = loader_lib.DataLoader(dataset, b, train=True, seed=SEED,
                                   num_workers=workers,
                                   images_dtype=torch.bfloat16,
                                   pin_memory=True)
    n = batches = 0
    for i, batch in enumerate(loader.epoch(0)):
        if i + 1 == LOADER_WARM_BATCHES:
            t0 = time.perf_counter()
        elif i >= LOADER_WARM_BATCHES:
            n += batch['images'].shape[0]
            batches += 1
    if batches < 30:
        raise AssertionError(f'loader alone: {batches} batches timed')
    return dict(scenes_per_s=n / (time.perf_counter() - t0),
                batches=batches)


def synthetic_steps(name, n=10):
    """The same step on a synthetic batch already on the card (b per card,
    bfloat16): steps/s over ``n`` after two warm-up steps."""
    preset = apply_overrides(get_preset(name), [BF16])
    model = build_model(preset.model, device='cuda', seed=SEED)
    opt, sched = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, 1000, preset.lr_steps)
    step = train_lib.make_train_step(model, opt, sched)
    batch = train_batch(preset.data, preset.data.samples_per_device, 'cuda',
                        seed=SEED)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def steady_training(key, data, root):
    """(b): one family's bfloat16 training from files through the CLI's
    loop: a short and a long epoch (the split listed more often,
    ``repeat_times`` 1) for the steady state (steps/s, scenes/s) and the
    fill + drain seconds, for KITTI the long epoch again under the profiler
    for the busy share of 10 steps between two log lines and their host
    syncs (the other families' busy shares were measured once), the
    launches per step of the long run, its peak memory; beside it the
    loader alone at 8 workers and the synthetic step."""
    name, _, _, b, (short_x, long_x) = TRAIN_SPLITS[key]
    preset = apply_overrides(get_preset(name),
                             [BF16, 'data.repeat_times=1'])
    out = dict(preset=name, batch=b, views=preset.data.n_images_train)
    runs = {}

    def cli(split, work):
        return [name, '--data-root', split[0], '--ann-file', split[1],
                '--work-dir', os.path.join(root, work), '--epochs', '1',
                '--batch-size', str(b), '--num-workers', '8',
                '--log-interval', str(LOG_INTERVAL), '--override', BF16,
                '--override', 'data.repeat_times=1']
    for tag, times in (('short', short_x), ('long', long_x)):
        split = repeated_split(data[key], times)
        torch.cuda.reset_peak_memory_stats()
        runs[tag] = run_train_tool(cli(split, f'{key}_{tag}'))
        if tag == 'long':
            out['peak_memory_gb'] = torch.cuda.max_memory_allocated() / 1e9
            assert_cli_launches(f'train from files {key}', runs[tag],
                                TRAIN_STEP_LAUNCHES[key])
            if key == 'kitti':
                profiled, window = profiled_cli(
                    cli(split, f'{key}_profiled'),
                    os.path.join(root, f'{key}_trace.json'))
                out['profiled_window'] = window
                out['profiled_steps_per_s'] = profiled['epochs'][0][
                    'steps'] / profiled['epochs'][0]['seconds']
    n = {t: runs[t]['epochs'][0]['steps'] for t in runs}
    s = {t: runs[t]['epochs'][0]['seconds'] for t in runs}
    per_step = (s['long'] - s['short']) / (n['long'] - n['short'])
    lines = runs['long']['train']
    if not all(np.isfinite(x['loss']) for x in lines):
        raise AssertionError(f'train from files {key}: non-finite loss')
    synth = synthetic_steps(name)
    out.update(
        steps=n, seconds=s, steady_steps_per_s=1 / per_step,
        steady_scenes_per_s=b / per_step,
        fill_drain_s=s['short'] - n['short'] * per_step,
        long_steps_per_s=n['long'] / s['long'],
        synthetic_steps_per_s=synth,
        loader_8_workers=loader_rate(
            preset, repeated_split(data[key], long_x), b, 8),
        launches_per_step={k: v / n['long'] for k, v in
                           runs['long']['step_launches'].items()},
        log_lines=[{k: line[k] for k in ('step', 'data_time', 'time',
                                         'loss')} for line in lines])
    out['host_bound'] = bool(out['steady_steps_per_s']
                             < 0.9 * out['synthetic_steps_per_s'])
    log(f'train from files {key}: {json.dumps(out)}')
    return out


def serving_sync_check(root):
    """(e), serving: one KITTI b=8 bfloat16 forward + decode on a batch
    already on the card, profiled: no host call that waits for the device
    and no device-to-host copy between its first and its last kernel."""
    cfg = apply_overrides(get_preset('imvoxelnet_kitti'), [BF16]).model
    model = build_model(cfg, device='cuda', seed=SEED)
    batch = kitti_batch(8, 'cuda', seed=SEED)
    runner.forward(model, cfg, batch)
    torch.cuda.synchronize()
    path = os.path.join(root, 'serving_trace.json')
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STEP_SPAN):
            runner.forward(model, cfg, batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    del model
    return trace_window(path, 1)


def check_apis(latest, data, root):
    """(d): ``apis.init_detector('imvoxelnet_kitti', checkpoint=...)`` and
    ``inference_detector`` on one 1242x375 val frame against
    ``runner.run_inference`` on the same frame through the loader, float32:
    the same boxes, scores and labels bit for bit and the same launches.
    The checkpoint is the CLI's ``latest.pth`` with the cls bias at 0, so
    that detections pass the score threshold."""
    name = 'imvoxelnet_kitti'
    one = os.path.join(root, 'one_frame.pkl')
    with open(one, 'wb') as f:
        pickle.dump(datasets.load_infos(data['kitti_val'][1])[:1], f)
    payload = ckpt_lib.load_checkpoint(latest)
    payload['state_dict']['bbox_head.conv_cls.bias'].zero_()
    latest = os.path.join(root, 'apis.pth')
    torch.save(payload, latest)
    preset = get_preset(name)
    dataset, loader = runner.build_val_dataset(
        preset, name, data['kitti_val'][0], one, num_workers=1)
    sample = dataset.get_sample(0, False, np.random.RandomState(SEED))
    _, model = apis.init_detector(name, checkpoint=latest)
    kernels.reset_launch_counts()
    res = apis.inference_detector(
        preset, model, sample['images'], sample['intrinsics'],
        sample['extrinsics'], sample['origin'], sample['ori_shape'],
        sample['img_shape'])
    api_counts = kernels.launch_counts()
    ref_model = build_model(preset.model, device='cpu', seed=SEED)
    ref_model.load_state_dict(ckpt_lib.load_checkpoint(latest)[
        'state_dict'], strict=True)
    ref_model.to('cuda')
    kernels.reset_launch_counts()
    with compute_precision(preset.model.compute_dtype):
        ref = runner.run_inference(ref_model, preset.model, loader, 1)[0]
    torch.cuda.synchronize()
    runner_counts = kernels.launch_counts()
    same = {k: bool(res[k].dtype == ref[k].dtype
                    and np.array_equal(res[k], ref[k])) for k in ref}
    if not all(same.values()) or api_counts != runner_counts or \
            set(res) != set(ref):
        raise AssertionError(f'apis: {same}, launches {api_counts} against '
                             f'{runner_counts}')
    assert_launches('apis', api_counts, EVAL_BATCH_LAUNCHES['kitti'])
    if not len(res['scores']):
        raise AssertionError('apis: no detection to compare')
    out = dict(detections=int(len(res['scores'])), bit_equal=same,
               launches=api_counts)
    log(f'apis: {json.dumps(out)}')
    return out


def run_train_from_files(before_loops=None, keep_log=None):
    """Phase 11: (a) the KITTI training CLI at full width with validation,
    resume and ``tools/test.py --checkpoint``; (b) the steady state of
    training from files for KITTI, SUN RGB-D and ScanNet beside the
    synthetic step and the loader alone; (c) the five learning loops, all
    at once, each through ``tools/validate_learning.py`` in a process of
    its own (``before_loops`` called before them: work of its own that the
    untimed loops may share the card with); (d) the API against the
    runner; (e) no
    host sync in the profiled steady steps and in a serving forward +
    decode.  Returns the summary and the KITTI CLI's launches per step and
    per validation batch; ``keep_log``: where the KITTI CLI's
    ``train_log.jsonl`` is copied (phase 14 reads it)."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        data = write_train_splits(root)
        out['write_splits_s'] = time.perf_counter() - t0
        log(f'train from files: splits written in {out["write_splits_s"]:.1f}'
            f' s')
        out['kitti_cli'], latest = kitti_cli_runs(data, root)
        if keep_log:
            shutil.copy(os.path.join(root, 'straight', 'train_log.jsonl'),
                        keep_log)
        out['apis'] = check_apis(latest, data, root)
        for key in TRAIN_SPLITS:
            out[key] = steady_training(key, data, root)
        sync = dict(training=out['kitti']['profiled_window'],
                    serving=serving_sync_check(root))
        for tag, window in sync.items():
            if window['sync_calls'] or window['device_to_host_copies'] or \
                    window['kernels'] < 100:
                raise AssertionError(f'gap 2, {tag}: {window}')
        out['sync_free'] = sync
        log(f'train from files: no host sync in 10 steady KITTI steps '
            f'between two log lines nor in a b=8 forward + decode '
            f'{json.dumps(sync)}')
    if before_loops is not None:
        before_loops()
    out['learning'] = {}
    # the five loops at once, each through the CLI in a process of its own
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'imvoxelnet_tpu_torch.tools.'
         'validate_learning', '--family', family, '--device', 'cuda'],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for family in validate_learning.FAMILIES]
    try:
        outs = mesh.wait_ranks(procs, 900)
    except RuntimeError as e:
        raise AssertionError(f'learning loops: {e}') from None
    for family, text in zip(validate_learning.FAMILIES, outs):
        r = tool_line(f'learning loop {family}', text)
        log(f'learning loop {family}: {json.dumps(r)}')
        if not r['passed']:
            raise AssertionError(f'learning loop {family} failed its '
                                 f'criterion: {r["metrics"]}')
        out['learning'][family] = {k: r[k] for k in (
            'steps', 'seconds', 'metrics', 'detections')}
    leaked = sorted(m for m in ('cv2', 'ml_dtypes', 'jax', 'PIL')
                    if m in sys.modules)
    if leaked:
        raise AssertionError(f'train from files: the port imported {leaked}')
    cli = out['kitti_cli']
    return out, dict(per_step=cli['launches_per_step'],
                     per_val_batch=cli['launches_per_val_batch'])


# --------------------------------------------------------------------------
# phase 12: serving export, visualization, BN folding, and the NMS and loss
# paths no preset takes
# --------------------------------------------------------------------------

EXPORT_PRESET = 'imvoxelnet_kitti'
TOTAL3D_EXPORT = 'imvoxelnet_total_sunrgbd_fast'
# the torch.ops.imvx nodes of an exported KITTI program, and the launches
# of one call of it
EXPORT_OPS = {'imvx.backproject.default': 1, 'imvx.conv3x3x3.default': 2,
              'imvx.nms_mask.default': 1, 'imvx.nms_scan.default': 1}
EXPORT_LAUNCHES = EVAL_BATCH_LAUNCHES['kitti']
EXPORT_REPS = 5
# the exact NMS: the clip's pairwise entry once for all samples, the scan
# once for all samples and classes
EXACT_LAUNCHES = dict(backproject=0, backproject_grad=0, conv3x3x3=0,
                      rect_clip=1, rect_clip_grad=0, nms_scan=1)
NORMAL_NMS_LAUNCHES = dict(EXACT_LAUNCHES, rect_clip=0)
GIOU_LAUNCHES = dict(EXACT_LAUNCHES, rect_clip_grad=1, nms_scan=0)
GIOU_PAIRS = 934400
FOLD_TOL = 1e-4

# Run in a fresh interpreter that imports imvoxelnet_tpu_torch.utils.export
# alone: each program loaded (load_exported registers torch.ops.imvx), run
# on its batches with the launches it made counted, timed, and the KITTI
# program's b=8 call profiled for the host-sync check.
EXPORT_RUN = r"""
import json, sys, time
import torch
from imvoxelnet_tpu_torch.utils import export as export_lib
spec = json.loads(sys.argv[1])
before = sorted(m for m in sys.modules if m.startswith('imvoxelnet_tpu_torch'))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {'modules_before_load': before, 'runs': {}}
for prog in spec['programs']:
    t0 = time.perf_counter()
    program = export_lib.load_exported(prog['path']).module()
    kernels = sys.modules['imvoxelnet_tpu_torch.kernels']
    state = torch.load(prog['state'], map_location='cuda')
    load_s = time.perf_counter() - t0
    for tag, path in prog['batches'].items():
        batch = torch.load(path, map_location='cuda')
        with torch.no_grad():
            program(state, batch)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            res = program(state, batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            t0 = time.perf_counter()
            for _ in range(spec['reps']):
                program(state, batch)['scores'].sum().item()
            ms = (time.perf_counter() - t0) * 1e3 / spec['reps']
            if (tag, prog['name']) == (spec['trace_batch'], spec['trace']):
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    with torch.profiler.record_function(spec['span']):
                        program(state, batch)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(spec['trace_path'])
        torch.save({k: v.cpu() for k, v in res.items()},
                   prog['out'] + f'.{tag}.pt')
        out['runs'][f"{prog['name']} {tag}"] = dict(
            launches=counts, ms=ms, load_s=load_s)
print(json.dumps(out))
"""


def imvx_nodes(exported):
    """How many times each ``torch.ops.imvx`` operator is called in a
    program's graph."""
    counts = {}
    for node in exported.graph.nodes:
        if node.op == 'call_function' and str(node.target).startswith('imvx'):
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


def same_detections(tag, got, ref):
    """A program's detections against the eager forward's: labels and
    valid exactly, boxes and scores (angles, layout) within 2e-3; whether
    they are bit-identical too."""
    for key in ('labels', 'valid'):
        if not torch.equal(got[key].cpu(), ref[key].cpu()):
            raise AssertionError(f'{tag}: {key} differs from eager')
    keys = [k for k in ('boxes', 'scores', 'angles', 'layout') if k in ref]
    if set(got) != set(ref):
        raise AssertionError(f'{tag}: outputs {sorted(got)} != '
                             f'{sorted(ref)}')
    err = 0.0
    for key in keys:
        a, b = got[key].cpu(), ref[key].cpu()
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
        err = max(err, float((a - b).abs().max()))
    if int(ref['valid'].sum()) == 0:
        raise AssertionError(f'{tag}: no detection to compare')
    return dict(detections=int(ref['valid'].sum()), max_abs_err=err,
                bit_identical=all(torch.equal(got[k].cpu(), ref[k].cpu())
                                  for k in keys))


def timed_eager(model, cfg, batch, reps=EXPORT_REPS):
    """The eager forward + decode's ms per call (host clock, a score
    fetched each call), as the loaded programs are timed."""
    runner.forward(model, cfg, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.forward(model, cfg, batch)['scores'].sum().item()
    return (time.perf_counter() - t0) * 1e3 / reps


def run_export(root):
    """(1), (2), (7b), (8a): KITTI (bfloat16, weights as inputs) exported at
    b=1 and with a symbolic batch, Total3D at b=1, loaded and run in a fresh
    interpreter and held to the eager forward; the baked KITTI program
    through tools/export.py --verify."""
    from imvoxelnet_tpu_torch.tools import export as export_tool
    from imvoxelnet_tpu_torch.utils import export as export_lib

    preset = apply_overrides(get_preset(EXPORT_PRESET), [BF16])
    cfg = preset.model
    model = build_model(cfg, device='cuda', seed=SEED)
    zero_cls_bias(model)
    batches = {'b1': kitti_batch(1, 'cuda', seed=SEED),
               'b8': kitti_batch(8, 'cuda', seed=SEED + 1)}
    tcfg = get_preset(TOTAL3D_EXPORT).model
    tmodel = build_model(tcfg, device='cuda', seed=SEED)
    zero_cls_bias(tmodel)
    level_angle_head(tmodel)
    tbatch = sunrgbd_batch(1, 'cuda', seed=SEED)

    out, progs = {}, []
    for tag, m, c, b, size in (
            ('kitti b=1', model, cfg, batches['b1'], 1),
            ('kitti poly', model, cfg, kitti_batch(2, 'cuda', seed=SEED),
             None),
            ('total3d b=1', tmodel, tcfg, tbatch, 1)):
        t0 = time.perf_counter()
        exported = export_lib.export_serving(c, m, b, batch_size=size)
        export_s = time.perf_counter() - t0
        path = os.path.join(root, tag.replace(' ', '_') + '.pt2')
        nodes = imvx_nodes(exported)
        want = EXPORT_OPS if tag.startswith('kitti') else dict(
            EXPORT_OPS, **{'imvx.conv3x3x3.default': 0})
        if {k: nodes.get(k, 0) for k in want} != want:
            raise AssertionError(f'export {tag}: imvx nodes {nodes}')
        out[tag] = dict(export_s=export_s,
                        bytes=export_lib.save_exported(exported, path),
                        imvx_nodes=nodes,
                        outputs=export_lib.output_shapes(exported))
        state = os.path.join(root, tag.replace(' ', '_') + '.state.pt')
        torch.save(m.state_dict(), state)
        runs = ({'b1': batches['b1']} if tag == 'kitti b=1' else
                batches if tag == 'kitti poly' else {'b1': tbatch})
        bpaths = {}
        for k, v in runs.items():
            bpaths[k] = os.path.join(
                root, f'batch_{tag.replace(" ", "_")}_{k}.pt')
            torch.save(v, bpaths[k])
        progs.append(dict(name=tag, path=path, state=state, batches=bpaths,
                          out=os.path.join(root, tag.replace(' ', '_'))))
        log(f'export {tag}: {json.dumps(out[tag])}')
    trace = os.path.join(root, 'exported_trace.json')
    spec = dict(programs=progs, reps=EXPORT_REPS, trace='kitti poly',
                trace_batch='b8', trace_path=trace, span=STEP_SPAN)
    proc = subprocess.run([sys.executable, '-c', EXPORT_RUN,
                           json.dumps(spec)], capture_output=True, text=True,
                          cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f'export: the fresh interpreter failed: '
                             f'{proc.stderr.strip()[-3000:]}')
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    with compute_precision('float32'):
        refs = {('kitti', k): runner.forward(model, cfg, v)
                for k, v in batches.items()}
        refs[('total3d', 'b1')] = runner.forward(tmodel, tcfg, tbatch)
        eager_ms = {'kitti b1': timed_eager(model, cfg, batches['b1']),
                    'kitti b8': timed_eager(model, cfg, batches['b8']),
                    'total3d b1': timed_eager(tmodel, tcfg, tbatch)}
    for prog in progs:
        family = prog['name'].split()[0]
        for k in prog['batches']:
            run = fresh['runs'][f"{prog['name']} {k}"]
            want = (EXPORT_LAUNCHES if family == 'kitti'
                    else EVAL_BATCH_LAUNCHES['total3d'])
            assert_launches(f'loaded {prog["name"]} {k}', run['launches'],
                            want)
            got = torch.load(prog['out'] + f'.{k}.pt')
            run.update(same_detections(f'loaded {prog["name"]} {k}', got,
                                       refs[(family, k)]),
                       eager_ms=eager_ms[f'{family} {k}'])
            out[prog['name']][k] = run
    sync = trace_window(trace, 1)
    if sync['sync_calls'] or sync['device_to_host_copies']:
        raise AssertionError(f'loaded kitti poly b=8 waits for the device: '
                             f'{sync}')
    out['kitti poly']['b8']['host_sync'] = sync
    out['fresh_interpreter_modules_before_load'] = \
        fresh['modules_before_load']

    # the baked program through the tool, verified in the same process
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        baked = export_tool.main([EXPORT_PRESET, '--out',
                                  os.path.join(root, 'kitti_baked.pt2'),
                                  '--bake-weights', '--verify',
                                  '--override', BF16])
    baked['tool_s'] = time.perf_counter() - t0
    if not baked['verified']:
        raise AssertionError('tools/export.py --verify did not verify')
    out['kitti baked (tools/export.py --verify)'] = baked
    del model, tmodel
    return out


def per_sample(head_outs, i):
    """Sample ``i`` of an indoor head's level lists (or a KITTI head's
    maps), batch dim kept."""
    return tuple([t[i:i + 1] for t in x] if isinstance(x, (list, tuple))
                 else x[i:i + 1] for x in head_outs)


def cat_results(results):
    return {k: torch.cat([r[k] for r in results]) for k in results[0]}


@contextlib.contextmanager
def pairwise_probe(seen):
    """Record the corners that reach the clip's pairwise entry."""
    wrapped = clip_kernel.rect_intersection_area_pairwise

    def probe(c1, c2):
        seen.append((c1.clone(), c2.clone()))
        return wrapped(c1, c2)
    with swapped((clip_kernel, 'rect_intersection_area_pairwise', probe)):
        yield


def scan_row(mask, valid, label, launches):
    """A ``kernels`` row of the scan kernel on a mask a decode sent it."""
    keep = clip_kernel.nms_scan(mask, valid)
    if not torch.equal(keep, nms_ops.nms_scan_plain(mask, valid)):
        raise AssertionError(f'nms scan {label}: differs from the plain '
                             f'version')
    g, n = valid.shape
    row = clip_row(
        'nms_scan', 'imvoxelnet_tpu/ops/nms.py:75',
        f'nms scan, {label}, G={g} N={n}',
        time_ms(lambda: clip_kernel.nms_scan(mask, valid), 20,
                queue_us=QUEUE_US * 4),
        time_ms(lambda: nms_ops.nms_scan_plain(mask, valid), 1),
        nbytes(mask, valid, keep), 0,
        launch_bound_ms=time_ms(lambda: clip_kernel.nms_scan(mask, valid),
                                20), kept=int(keep.sum()))
    row['launches'] = launches
    return row


def exact_pairwise_row(c1, c2, launches):
    """A ``kernels`` row of the clip's pairwise entry on the exact NMS's
    ``(B, N, 4, 2)`` corners, one launch for all samples; the plain version
    runs sample by sample (one sample's 9 M pairs at a time)."""
    got = clip_kernel.rect_intersection_area_pairwise(c1, c2)
    for i in range(c1.shape[0]):
        assert_same_bits(
            f'rect_clip pairwise, exact NMS, sample {i}', got[i:i + 1],
            iou_ops.rect_intersection_area_pairwise_plain(c1[i:i + 1],
                                                          c2[i:i + 1]))
    g, n, m = got.shape

    def plain():
        for i in range(g):
            iou_ops.rect_intersection_area_pairwise_plain(c1[i:i + 1],
                                                          c2[i:i + 1])
    row = clip_row(
        'rect_clip', CLIP_REPLACES, f'pairwise, exact NMS of '
        f'{EXACT_PRESET} b={g}, G={g} N=M={n}, {g * n * m} pairs float32',
        time_ms(lambda: clip_kernel.rect_intersection_area_pairwise(c1, c2),
                5), time_ms(plain, 1),
        nbytes(c1, c2, got), g * n * m * CLIP_FLOPS,
        plain_note='the plain clip one sample at a time')
    row['launches'] = launches
    return row


EXACT_PRESET = 'imvoxelnet_sunrgbd'


def run_exact_nms(root):
    """(3), (8b): the untruncated NMS (``pre_nms_k=0``) of imvoxelnet_sunrgbd
    on one b=8 bfloat16 forward's head outputs: the kernel path against the
    plain path (sample by sample), launches, no wait for the device, its
    peak memory and ms against the truncated decode's, and how many
    detections differ from the truncated path's."""
    preset = apply_overrides(get_preset(EXACT_PRESET), [BF16])
    cfg = preset.model
    model = build_model(cfg, device='cuda', seed=SEED)
    zero_cls_bias(model)
    batch = sunrgbd_batch(8, 'cuda', seed=SEED)
    with torch.no_grad():
        head_outs, valid = model(batch)
    del model
    origins = batch['origins']
    exact = dataclasses.replace(cfg.indoor_head, pre_nms_k=0)

    def decode(hcfg, outs=head_outs, v=valid, o=origins):
        return ivh.indoor_head_get_bboxes(outs, v, o, hcfg)
    decode(exact)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    pairs, scans = [], []
    with pairwise_probe(pairs), scan_probe(scans):
        torch.cuda.set_sync_debug_mode('error')
        try:
            res = decode(exact)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    assert_launches('exact nms', counts, EXACT_LAUNCHES)
    path = os.path.join(root, 'exact_nms_trace.json')
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STEP_SPAN):
            decode(exact)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    sync = trace_window(path, 1)
    if sync['sync_calls'] or sync['device_to_host_copies']:
        raise AssertionError(f'exact nms waits for the device: {sync}')
    with plain_path():
        ref = cat_results([decode(exact, per_sample(head_outs, i),
                                  valid[i:i + 1], origins[i:i + 1])
                           for i in range(valid.shape[0])])
    torch.cuda.synchronize()
    for key in ('boxes', 'scores', 'labels', 'valid'):
        if not torch.equal(res[key], ref[key]):
            raise AssertionError(f'exact nms: {key} differs from the plain '
                                 f'path')
    trunc = decode(cfg.indoor_head)
    differ = ((res['valid'] != trunc['valid']) | (res['valid'] & (
        (res['labels'] != trunc['labels'])
        | (res['boxes'] != trunc['boxes']).any(-1))))
    n_cand = pairs[0][0].shape[1]
    out = dict(
        candidates=n_cand, classes=cfg.indoor_head.n_classes,
        detections=int(res['valid'].sum()),
        detections_truncated=int(trunc['valid'].sum()),
        rows_differing_from_truncated=int(differ.sum()),
        equal_to_plain_path=True, launches=counts,
        peak_memory_gb=peak_gb, rank_chunk_bools=nms_ops._RANK_CHUNK,
        decode_ms=time_ms(lambda: decode(exact), 3),
        truncated_decode_ms=time_ms(lambda: decode(cfg.indoor_head), 5),
        host_sync=sync, sync_free=True)
    if not out['detections']:
        raise AssertionError('exact nms: no detection')
    log(f'exact nms: {json.dumps(out)}')
    rows = [exact_pairwise_row(*pairs[0], counts['rect_clip']),
            scan_row(*scans[0], f'exact NMS of {EXACT_PRESET} b=8',
                     counts['nms_scan'])]
    return out, rows


def run_normal_nms():
    """(4): ``use_rotate_nms=False`` at imvoxelnet_kitti b=8 bfloat16: the
    axis-aligned BEV NMS (a plain mask and the scan kernel) against the
    plain path, exactly, with its launches."""
    preset = apply_overrides(get_preset(EXPORT_PRESET), [BF16])
    cfg = preset.model
    model = build_model(cfg, device='cuda', seed=SEED)
    zero_cls_bias(model)
    with torch.no_grad():
        head_outs, _ = model(kitti_batch(8, 'cuda', seed=SEED + 1))
    del model
    hcfg = dataclasses.replace(cfg.anchor_head, use_rotate_nms=False)
    a3d.anchor3d_head_get_bboxes(head_outs, hcfg)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    scans = []
    with scan_probe(scans):
        torch.cuda.set_sync_debug_mode('error')
        try:
            res = a3d.anchor3d_head_get_bboxes(head_outs, hcfg)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert_launches('use_rotate_nms=False', counts, NORMAL_NMS_LAUNCHES)
    with plain_path():
        ref = a3d.anchor3d_head_get_bboxes(head_outs, hcfg)
    rotated = a3d.anchor3d_head_get_bboxes(head_outs, cfg.anchor_head)
    for key in ('boxes', 'scores', 'labels', 'valid'):
        if not torch.equal(res[key], ref[key]):
            raise AssertionError(f'use_rotate_nms=False: {key} differs from '
                                 f'the plain path')
    out = dict(detections=int(res['valid'].sum()),
               detections_rotated=int(rotated['valid'].sum()),
               equal_to_plain_path=True, launches=counts, sync_free=True)
    if not out['detections']:
        raise AssertionError('use_rotate_nms=False: no detection')
    log(f'use_rotate_nms=False: {json.dumps(out)}')
    return out, [scan_row(*scans[0], f'axis-aligned BEV NMS of '
                          f'{EXPORT_PRESET} b=8', counts['nms_scan'])]


def giou_pairs(rng, n):
    """``n`` aligned pairs of gravity-center furniture boxes as the IoU-3D
    loss sees them over a b=4 step's points (``loss_pairs``' mix: near
    pairs and 5% each disjoint, identical and nested), with a positive
    weight on 1.1% of them, as a step's positives."""
    target = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                             rng.uniform(0.2, 1.5, (n, 1)),
                             rng.uniform(0.3, 2.5, (n, 3)),
                             rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    pred = target + np.concatenate([0.2 * rng.randn(n, 3),
                                    0.15 * rng.randn(n, 3),
                                    0.3 * rng.randn(n, 1)], -1)
    pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.05
    k = n // 20
    pred[:k, :2] += 20.0
    pred[k:2 * k] = target[k:2 * k]
    pred[2 * k:3 * k, 3:6] = target[2 * k:3 * k, 3:6] * 0.5
    weight = (rng.uniform(size=n) < 0.011).astype(np.float32)
    return [torch.tensor(x.astype(np.float32), device='cuda')
            for x in (pred, target, weight)]


def run_giou():
    """(5): ``giou_3d_loss`` on 934,400 pairs, the kernel path (the clip's
    paired entry and its backward kernel) against the plain path: the loss
    within 2e-3, both gradients within 2e-2 of their max-abs; launches."""
    rng = np.random.RandomState(SEED)
    pred, target, weight = giou_pairs(rng, GIOU_PAIRS)
    avg = float(weight.sum())

    def loss_and_grads():
        p = pred.clone().requires_grad_(True)
        t = target.clone().requires_grad_(True)
        loss = loss_ops.giou_3d_loss(p, t, weight, avg_factor=avg)
        return (loss.detach(), *torch.autograd.grad(loss, (p, t)))
    kernels.reset_launch_counts()
    seen = []
    with clip_grad_probe(seen):
        got = loss_and_grads()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert_launches('giou_3d_loss', counts, GIOU_LAUNCHES)
    with plain_path():
        ref = loss_and_grads()
    torch.cuda.synchronize()
    loss_err = abs(float(got[0]) - float(ref[0]))
    if not loss_err <= 2e-3 * max(1.0, abs(float(ref[0]))):
        raise AssertionError(f'giou_3d_loss: {float(got[0])} against '
                             f'{float(ref[0])}')
    gaps = []
    for name, a, b in (('pred', got[1], ref[1]), ('target', got[2], ref[2])):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max()) / scale
        if not (scale > 0 and gap <= 2e-2):
            raise AssertionError(f'giou_3d_loss: {name} gradient gap {gap} '
                                 f'of max-abs {scale}')
        gaps.append(gap)
    out = dict(pairs=GIOU_PAIRS, weighted=int(weight.sum()),
               loss=float(got[0]), loss_abs_err=loss_err,
               grad_gap_of_max_abs=dict(pred=gaps[0], target=gaps[1]),
               launches=counts)
    log(f'giou_3d_loss: {json.dumps(out)}')
    c1, c2, g = seen[0]
    rows = check_rect_clip_grad(c1, c2, g, f'giou_3d_loss, {GIOU_PAIRS} '
                                f'pairs', 1)
    for row in rows:
        row['launches'] = counts[row['name']]
    return out, list(rows)


def random_frozen_bn(model, seed=SEED):
    """Seeded statistics and affines for the backbone's frozen BNs (the
    init's identity BNs would make the fold a no-op)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.backbone.modules():
            if isinstance(mod, FrozenBatchNorm):
                c = mod.weight.shape[0]
                for t, lo, hi in ((mod.weight, 0.5, 1.5), (mod.running_var,
                                                           0.5, 1.5)):
                    t.copy_(torch.rand(c, generator=gen) * (hi - lo) + lo)
                mod.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                mod.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)


def run_fold():
    """(6): the backbones of imvoxelnet_kitti and imvoxelnet_nuscenes (DCN
    offsets nonzero) with their frozen BNs folded
    (``utils/fuse.py:fuse_backbone``) against the unfolded ones, float32
    with TF32 off (the gap of every stage within ``FOLD_TOL`` of its
    max-abs), and the bfloat16 gap logged."""
    from imvoxelnet_tpu_torch.utils.fuse import fuse_backbone

    out = {}
    for name in (EXPORT_PRESET, NUSCENES):
        preset = get_preset(name)
        model = build_model(preset.model, device='cpu', seed=SEED)
        dcn_offsets(model)
        random_frozen_bn(model)
        fused = build_model(preset.model, device='cpu', seed=SEED)
        fused.load_state_dict(fuse_backbone(model.state_dict()), strict=True)
        model.cuda()
        fused.cuda()
        w, h = preset.data.test_size
        v = preset.data.n_images_test
        x = torch.tensor(np.random.RandomState(SEED).randn(
            v, 3, h, w).astype(np.float32), device='cuda')
        gaps = {}
        for dtype in (torch.float32, torch.bfloat16):
            with torch.no_grad(), compute_precision('float32'):
                a = model.backbone(x.to(dtype))
                b = fused.backbone(x.to(dtype))
            gaps[str(dtype).split('.')[1]] = max(
                float((p.float() - q.float()).abs().max()
                      / q.float().abs().max()) for p, q in zip(a, b))
        if not gaps['float32'] <= FOLD_TOL:
            raise AssertionError(f'fold {name}: float32 gap {gaps}')
        out[name] = dict(gap_of_max_abs=gaps, tolerance_float32=FOLD_TOL)
        del model, fused
    log(f'fold: {json.dumps(out)}')
    return out


def run_show_dir(root):
    """(7a): tools/test.py --show-dir on a 2-frame KITTI split (1242x375):
    one PNG a frame, decoded by the port at the frame's size, differing from
    the frame where a detection above the threshold was drawn and equal to
    it where none was."""
    data_root = os.path.join(root, 'kitti_show')
    ann = splits.kitti_split(data_root, n=2, seed=SEED)
    pth = os.path.join(root, 'kitti_show.pth')
    eval_weights(EXPORT_PRESET, pth)
    show = os.path.join(root, 'show')
    thr = 0.05
    with contextlib.redirect_stdout(io.StringIO()):
        summary = test_tool.main([
            EXPORT_PRESET, '--data-root', data_root, '--ann-file', ann,
            '--torch-checkpoint', pth, '--batch-size', '2', '--num-workers',
            '2', '--override', BF16, '--show-dir', show, '--show-num', '2',
            '--show-score-thr', str(thr)])
    dataset, _ = runner.build_val_dataset(get_preset(EXPORT_PRESET),
                                          EXPORT_PRESET, data_root, ann)
    drawn = []
    for idx, r in enumerate(summary['results']):
        png = os.path.join(show, f'{idx}_0.png')
        frame = load_image(os.path.join(
            data_root, dataset.get_data_info(idx)['img_paths'][0]))
        img = load_image(png)
        if img.shape != frame.shape:
            raise AssertionError(f'--show-dir: {png} is {img.shape}, the '
                                 f'frame {frame.shape}')
        n_boxes = int((r['scores'] > thr).sum())
        changed = int((img != frame).any(-1).sum())
        if (changed > 0) != (n_boxes > 0):
            raise AssertionError(f'--show-dir: {png}: {n_boxes} boxes, '
                                 f'{changed} pixels changed')
        drawn.append(dict(boxes=n_boxes, pixels_changed=changed))
    if not any(d['boxes'] for d in drawn) or \
            sorted(summary['shown']) != sorted(
                os.path.join(show, f'{i}_0.png') for i in range(2)):
        raise AssertionError(f'--show-dir: {drawn}, {summary["shown"]}')
    out = dict(frames=drawn, score_thr=thr)
    log(f'show-dir: {json.dumps(out)}')
    return out


def run_phase12():
    """Phase 12; returns its summary and its ``kernels`` rows (each with
    its launches)."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out = {'export': run_export(root)}
        out['exact_nms'], rows = run_exact_nms(root)
        out['normal_nms'], more = run_normal_nms()
        rows += more
        out['giou_3d_loss'], more = run_giou()
        rows += more
        out['fold'] = run_fold()
        out['show_dir'] = run_show_dir(root)
        out['seconds'] = time.perf_counter() - t0
    return out, rows


# --------------------------------------------------------------------------
# phase 13: converted splits, and data parallelism on one card
# --------------------------------------------------------------------------

VALIDATE = [sys.executable, '-m',
            'imvoxelnet_tpu_torch.tools.validate_multihost', '--device',
            'cuda', '--timeout', '300']
# tools/validate_multihost.py runs: arguments, launches of each rank
MULTIHOST_RUNS = {
    # two gloo ranks on cuda:0, float32, a global b=2, against one process
    'kitti_2_ranks': (['--preset', 'imvoxelnet_kitti', '--world', '2',
                       '--batch', '2'], TRAIN_STEP_LAUNCHES['kitti']),
    'sunrgbd_fast_batch_mean_2_ranks': (
        ['--preset', 'imvoxelnet_sunrgbd_fast', '--world', '2', '--batch',
         '2', '--override', "model.dp_loss_norm='batch_mean'"],
        TRAIN_STEP_LAUNCHES['sunrgbd']),
    # one NCCL rank: the step bit for bit as without a group
    'kitti_1_rank_nccl': (['--preset', 'imvoxelnet_kitti', '--world', '1',
                           '--batch', '1', '--exact'],
                          TRAIN_STEP_LAUNCHES['kitti']),
    # 50 views over 2 ranks of 25, against the unsharded forward
    'scannet_50_views_2_ranks': (
        ['--preset', 'imvoxelnet_scannet', '--world', '2', '--views', '50'],
        dict(backproject=1, backproject_grad=0, rect_clip=0,
             rect_clip_grad=0, nms_scan=0, conv3x3x3=0)),
}
CLI_RANK = r"""
import json, sys
import torch
torch.backends.cudnn.deterministic = True
from imvoxelnet_tpu_torch.tools import train
summary = train.main(sys.argv[1:])
if summary['rank'] == 0:
    print('SUMMARY ' + json.dumps({k: summary[k] for k in (
        'start_epoch', 'steps_per_epoch', 'step', 'world', 'epochs',
        'train')}))
"""
CLI13_EPOCHS = 2


def check_multihost(tag, out, launches):
    """A validate_multihost verdict: ok, and every rank's launches."""
    verdict = json.loads(out.strip().splitlines()[-1])
    if not verdict['ok']:
        raise AssertionError(f'{tag}: {json.dumps(verdict)}')
    for r, counts in enumerate(verdict['launches']):
        assert_launches(f'{tag} rank {r}', counts, launches)
    log(f'multihost {tag}: {json.dumps(verdict)}')
    return verdict


def convert_and_compare(key, root, raw_writer, commands):
    """Phase 10's split of ``key`` written again (the same writer,
    arguments and seed), its raw tree written from it, converted by
    ``tools/create_data.py`` (``commands``); the converted infos against
    the split's: returns ``(split, comparison)``."""
    _, writer, kwargs, _ = EVAL_SPLITS[key]
    data_root = os.path.join(root, key)
    with open(writer(data_root, seed=SEED, **kwargs), 'rb') as f:
        written = pickle.load(f)
    t0 = time.perf_counter()
    raw_writer(data_root, written)
    raw_s = time.perf_counter() - t0
    for argv in commands:
        with contextlib.redirect_stdout(io.StringIO()):
            create_data.main([*argv, '--root-path', data_root])
    convert_s = time.perf_counter() - t0 - raw_s
    ann = os.path.join(data_root, {
        'kitti': 'kitti_infos_val.pkl',
        'scannet': 'scannet_imvoxelnet_infos_val.pkl'}[key])
    with open(ann, 'rb') as f:
        converted = pickle.load(f)

    def same(a, b):
        if isinstance(b, dict):
            return all(same(a[k], v) for k, v in b.items())
        if isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(b, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b
    if key == 'kitti':
        fields = {i: same(c['image'], w['image']) and same(
            c['calib'], w['calib']) and same(c['annos'], w['annos'])
            for i, (c, w) in enumerate(zip(converted, written))}
    else:
        # the .sens format stores the poses and the intrinsic as float32
        f32 = lambda m: np.asarray(m, np.float32).astype(np.float64)  # noqa
        fields = {i: c['img_paths'] == w['img_paths'] and same(
            c['extrinsics'], [f32(p) for p in w['extrinsics']]) and same(
            c['intrinsics'], f32(w['intrinsics'])) and same(
            c['annos'], w['annos'])
            for i, (c, w) in enumerate(zip(converted, written))}
    if len(converted) != len(written) or not all(fields.values()):
        raise AssertionError(f'create_data {key}: the converted infos '
                             f'differ from the split\'s: {fields}')
    return (data_root, ann), dict(samples=len(converted), raw_s=raw_s,
                                  convert_s=convert_s, equal=True)


def read_converted(name, data_root, ann):
    """Every sample of a converted split through the port's dataset of the
    preset: finite images, GT boxes."""
    dataset, _ = runner.build_val_dataset(get_preset(name), name, data_root,
                                          ann, device='cuda')
    dataset.test_mode = False
    rng = np.random.RandomState(SEED)
    n_gt = 0
    for i in range(len(dataset)):
        sample = dataset.get_sample(i, False, rng)
        if not np.isfinite(sample['images']).all():
            raise AssertionError(f'{name}: non-finite sample {i}')
        n_gt += int(sample['gt_mask'].sum())
    if not n_gt:
        raise AssertionError(f'{name}: no GT box in the converted split')
    return dict(samples=len(dataset), gt_boxes=n_gt)


def other_converters(root):
    """The SUN RGB-D (both class lists), Total3D and nuScenes converters on
    raw trees of their own, each split read through the port's dataset."""
    out = {}
    sun = os.path.join(root, 'sunrgbd_raw')
    synthetic_raw.sunrgbd_raw(sun, 4, seed=SEED)
    total = synthetic_raw.total3d_raw(os.path.join(root, 'total3d_raw'), 2,
                                      seed=SEED)
    nus = os.path.join(root, 'nuscenes_raw')
    val_scenes = synthetic_raw.nuscenes_raw(nus, 2, seed=SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        for cmd in ('sunrgbd', 'sunrgbd_monocular'):
            create_data.main([cmd, '--root-path', sun, '--splits', 'val'])
        create_data.main(['sunrgbd_total', '--root-path',
                          os.path.dirname(total), '--splits', 'val'])
        nuscenes_converter.create_nuscenes_infos(nus, 'v1.0-mini',
                                                 val_scenes)
    for name, data_root, ann in (
            ('imvoxelnet_sunrgbd', sun,
             'sunrgbd_imvoxelnet_infos_val.pkl'),
            ('imvoxelnet_perspective_sunrgbd', sun,
             'sunrgbd_monocular_infos_val.pkl'),
            ('imvoxelnet_total_sunrgbd', os.path.dirname(total),
             'sunrgbd_total_infos_val.pkl'),
            ('imvoxelnet_nuscenes', nus, 'nuscenes_infos_train.pkl'),
            ('imvoxelnet_nuscenes', nus, 'nuscenes_infos_val.pkl')):
        out[f'{name}:{ann}'] = read_converted(name, data_root,
                                              os.path.join(data_root, ann))
    return out


def multihost_cli(split, work, epochs, port):
    """``tools/train.py --multihost --ckpt-format orbax`` as two processes
    on cuda:0 with torchrun's environment: imvoxelnet_kitti at full width,
    bfloat16, a global b=4, the converted split listed once,
    ``cudnn.deterministic``."""
    argv = ['imvoxelnet_kitti', '--data-root', split[0], '--ann-file',
            split[1], '--work-dir', work, '--epochs', str(epochs),
            '--batch-size', '4', '--num-workers', '4', '--log-interval', '4',
            '--override', BF16, '--override', 'data.repeat_times=1',
            '--multihost', '--ckpt-format', 'orbax']
    return mesh.start_ranks([sys.executable, '-c', CLI_RANK, *argv], 2,
                            port, cwd=REPO)


def cli_summary(tag, procs, timeout=600):
    try:
        outs = mesh.wait_ranks(procs, timeout)
    except RuntimeError as e:
        raise AssertionError(f'{tag}: {e}') from None
    lines = [x for x in outs[0].splitlines() if x.startswith('SUMMARY ')]
    if len(lines) != 1:
        raise AssertionError(f'{tag}: no summary\n{outs[0][-4000:]}')
    return json.loads(lines[0][len('SUMMARY '):])


def dcp_restore_check(dcp, steps_per_epoch):
    """The resume path in this process: the directory's tensors back into
    a model and optimizer of another seed, against the directory's own
    tensors read as they are saved."""
    preset = apply_overrides(get_preset('imvoxelnet_kitti'), [BF16])
    model = build_model(preset.model, device='cpu', seed=SEED + 1).cuda()
    optimizer, scheduler = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch, preset.lr_steps)
    step, meta = ckpt_lib.load_checkpoint_sharded(dcp, model, optimizer,
                                                  scheduler)
    restored = dict(state_dict={k: v.cpu() for k, v in
                                model.state_dict().items()},
                    optimizer=optimizer.state_dict(),
                    scheduler={'last_epoch': scheduler.last_epoch},
                    step=step)
    restored['optimizer']['state'] = {
        i: {k: v.cpu() for k, v in st.items()}
        for i, st in restored['optimizer']['state'].items()}
    same = compare_train_states(ckpt_lib.read_checkpoint_sharded(dcp),
                                restored)
    same['epoch'] = meta['epoch']
    return same


def assert_same_states(tag, same):
    bad = [k for k in ('parameters', 'buffers', 'adamw')
           if same[k]['equal'] != same[k]['total']]
    if bad or not same['same_schedule_and_step']:
        raise AssertionError(f'{tag}: {json.dumps(same)}')


def start_multihost_runs():
    """The ``MULTIHOST_RUNS`` in their own processes, two runs at a time
    (all of them at once overfill the card's memory), in two threads;
    returns ``(threads, outputs)``: each run's output or exception."""
    ports = dict(zip(MULTIHOST_RUNS, mesh.free_ports(len(MULTIHOST_RUNS))))
    outputs = {}

    def validate_runs(tags):
        for tag in tags:
            args = MULTIHOST_RUNS[tag][0] + ['--master-port',
                                             str(ports[tag])]
            try:
                proc = subprocess.Popen(
                    VALIDATE + args, cwd=REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                outputs[tag] = mesh.wait_ranks([proc], 900)[0]
            except Exception as e:          # raised again in phase 13
                outputs[tag] = e
    tags = list(MULTIHOST_RUNS)
    threads = [threading.Thread(target=validate_runs, args=(tags[i::2],))
               for i in range(2)]
    for thread in threads:
        thread.start()
    return threads, outputs


def run_phase13(runs=None):
    """Phase 13; returns its summary and the launches of each rank of the
    view-sharded forward (B1's row at a rank's 25 views is timed apart).
    ``runs``: the ``MULTIHOST_RUNS`` as :func:`start_multihost_runs`
    started them (else it starts them).  Every part runs; a failed part
    fails the phase at its end, with every error."""
    out, errors = {}, []

    def attempt(tag, fn, *args):
        try:
            return fn(*args)
        except Exception as e:              # raised again below
            log(f'phase 13: {tag} failed: {e}')
            errors.append(f'{tag}: {e}')

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if not runs:
        runs = start_multihost_runs()
    ports = mesh.free_ports(3)
    with tempfile.TemporaryDirectory() as root:
        kitti, out['create_data_kitti'] = convert_and_compare(
            'kitti', root, synthetic_raw.kitti_raw,
            [['kitti', '--splits', 'val']])
        log(f'create_data kitti: {json.dumps(out["create_data_kitti"])}')
        # the CLI over two ranks: 1 epoch, then resumed to 2; and 2
        # straight, meanwhile
        first = multihost_cli(kitti, os.path.join(root, 'resumed'), 1,
                              ports[0])
        straight = multihost_cli(kitti, os.path.join(root, 'straight'),
                                 CLI13_EPOCHS, ports[1])
        scannet, out['create_data_scannet'] = convert_and_compare(
            'scannet', root, synthetic_raw.scannet_raw,
            [['scannet_images', '--max-frames', '50'],
             ['scannet', '--splits', 'val']])
        log(f'create_data scannet: '
            f'{json.dumps(out["create_data_scannet"])}')
        for key, split, name in (('kitti', kitti, 'imvoxelnet_kitti'),
                                 ('scannet', scannet, 'imvoxelnet_scannet')):
            pth = os.path.join(root, f'{name}.pth')
            eval_weights(name, pth)
            summary, counts, _ = run_test_tool(key, split, pth, name=name)
            out[f'test_tool_{key}'] = dict(
                preset=name, samples=summary['n_samples'],
                batches=summary['n_batches'], launches=counts,
                metrics=summary['metrics'],
                detections=sum(len(r['scores'])
                               for r in summary['results']))
        out['other_converters'] = attempt('other converters',
                                          other_converters, root)
        log(f'converters read through the datasets: '
            f'{json.dumps(out["other_converters"])}')
        torch.cuda.empty_cache()

        cli = {'first': attempt('multihost cli, 1 epoch', cli_summary,
                                'multihost cli, 1 epoch', first),
               'straight': attempt('multihost cli, 2 epochs', cli_summary,
                                   'multihost cli, 2 epochs', straight)}
        if cli['first'] is not None:
            dcp = os.path.join(root, 'resumed', 'latest.dcp')
            out['dcp_restore'] = attempt(
                'dcp restore', dcp_restore_check, dcp,
                cli['first']['steps_per_epoch'])
            cli['resumed'] = attempt(
                'multihost cli, resumed', cli_summary,
                'multihost cli, resumed', multihost_cli(
                    kitti, os.path.join(root, 'resumed'), CLI13_EPOCHS,
                    ports[2]))
        if cli['straight'] is not None and cli.get('resumed') is not None:
            if cli['resumed']['start_epoch'] != 1:
                errors.append(f'multihost cli: resumed at epoch '
                              f'{cli["resumed"]["start_epoch"]}')
            out['dcp_resume_vs_straight'] = compare_train_states(
                os.path.join(root, 'straight', 'latest.dcp'),
                os.path.join(root, 'resumed', 'latest.dcp'))
        out['multihost_cli'] = cli
        for key in ('dcp_restore', 'dcp_resume_vs_straight',
                    'multihost_cli'):
            log(f'{key}: {json.dumps(out.get(key))}')
    for check in ('dcp_restore', 'dcp_resume_vs_straight'):
        if out.get(check) is not None:
            attempt(check, assert_same_states, check, out[check])
    threads, outputs = runs
    for thread in threads:
        thread.join()

    def verdict(tag):
        if isinstance(outputs[tag], Exception):
            raise outputs[tag]
        return check_multihost(tag, outputs[tag], MULTIHOST_RUNS[tag][1])
    out['multihost'] = {tag: attempt(tag, verdict, tag)
                        for tag in MULTIHOST_RUNS}
    out['seconds'] = time.perf_counter() - t0
    if errors:
        raise AssertionError('phase 13: ' + '\n'.join(errors))
    return out, out['multihost']['scannet_50_views_2_ranks']['launches'][0]


# --------------------------------------------------------------------------
# phase 14: the export tool's multi-device programs and the measurement tools
# --------------------------------------------------------------------------

PLATFORM_PRESET = 'imvoxelnet_sunrgbd_fast'
# a call of each program: the platforms' (b=1 float32 SUN RGB-D _fast), a
# rank of the view-sharded ScanNet (25 of 50 views) and of the
# data-sharded KITTI (b=1 of 2)
PLATFORM_LAUNCHES = {'cuda': EVAL_BATCH_LAUNCHES['sunrgbd'],
                     'cpu': dict.fromkeys(EVAL_BATCH_LAUNCHES['sunrgbd'], 0)}
VIEW_RANK_LAUNCHES = EVAL_BATCH_LAUNCHES['scannet']
DATA_RANK_LAUNCHES = EVAL_BATCH_LAUNCHES['kitti']
# the benchmark's launches an iteration: KITTI b=8 serving, a b=4 step
BENCH_LAUNCHES = {'fwd': EVAL_BATCH_LAUNCHES['kitti'],
                  'train': TRAIN_STEP_LAUNCHES['kitti']}
BENCH_ITERS = 10
TRACED_ITERS = 5
# the decodes of the truncation study: the NMS-mask entry and the scan;
# the exact one B2's pairwise entry and the scan
TRUNCATION_LAUNCHES = dict(backproject=0, backproject_grad=0, rect_clip=1,
                           rect_clip_grad=0, nms_scan=1, conv3x3x3=0)
B3_KERNEL = 'conv_wgmma'
NECK_SOURCE = 'imvoxelnet_tpu_torch/models/necks3d.py'


def tool_line(tag, out):
    """The last JSON line a tool printed."""
    lines = [x for x in out.splitlines() if x.startswith('{')]
    if not lines:
        raise AssertionError(f'{tag}: no JSON line\n{out[-3000:]}')
    return json.loads(lines[-1])


def start_untimed_tools(root):
    """The phase's untimed runs, in processes of their own on the card:
    the export of ``PLATFORM_PRESET`` for the card and the CPU, the
    view-sharded ScanNet and data-sharded KITTI exports over two gloo ranks
    each, and the truncation study.  Returns ``{tag: processes}``."""
    weights = {}
    for name in (PLATFORM_PRESET, 'imvoxelnet_scannet', 'imvoxelnet_kitti'):
        weights[name] = os.path.join(root, f'{name}.pth')
        eval_weights(name, weights[name])

    def tool(name, *args):
        # at a lower CPU priority than phase 13's own work, which they share
        # the host with
        return ['nice', '-n', '10', sys.executable, '-m',
                f'imvoxelnet_tpu_torch.tools.{name}', *args]

    def export(name, *flags):
        return tool('export', name, '--out', os.path.join(
            root, f'{name}.pt2'), '--torch-checkpoint', weights[name],
            '--verify', *flags)

    def start(cmd):
        return [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)]
    ports = mesh.free_ports(2)
    return {
        'platforms': start(export(PLATFORM_PRESET, '--platforms',
                                  'cuda,cpu')),
        'truncation': start(tool(
            'eval_nms_truncation', '--scenes', '16', '--train-scenes', '8',
            '--steps', '40', '--root', os.path.join(root, 'truncation'))),
        'view': mesh.start_ranks(export('imvoxelnet_scannet',
                                        '--view-sharded'), 2, ports[0],
                                 cwd=REPO),
        'data': mesh.start_ranks(export('imvoxelnet_kitti', '--data-sharded',
                                        '--batch-size', '2'), 2, ports[1],
                                 cwd=REPO)}


def check_exports(outs):
    """The three export runs' verdicts, read from their lines and bounded
    here: each program's largest gap from the eager forward on its device
    or, for a sharded one, on each rank's share; a sharded forward's head
    outputs against the unsharded ones; where a sharded decode broke a near
    tie, that it was held to the same detection counts, labels and scores;
    with the launches of a call (a rank's), and detections to compare."""
    from imvoxelnet_tpu_torch.tools.export import DET_TOL, OUT_TOL

    out = {}
    line = tool_line('export --platforms', outs['platforms'][0])
    for platform, want in PLATFORM_LAUNCHES.items():
        got = line['per_platform'][platform]
        assert_launches(f'export --platforms, the {platform} program',
                        got['launches'], want)
        if not got['program_gap'] <= DET_TOL or not got['detections']:
            raise AssertionError(f'export --platforms, the {platform} '
                                 f'program: {got}')
    out['platforms'] = line
    for tag, want in (('view', VIEW_RANK_LAUNCHES),
                      ('data', DATA_RANK_LAUNCHES)):
        line = tool_line(f'export --{tag}-sharded', outs[tag][0])
        for r, counts in enumerate(line['launches']):
            assert_launches(f'export --{tag}-sharded rank {r}', counts, want)
        if line['devices'] != 2 or line['collectives'] != (
                2 if tag == 'view' else 0) or line['error'] or \
                len(line['program_gaps']) != 2 or \
                not max(line['program_gaps']) <= DET_TOL or \
                not line['head_outputs_gap'] <= OUT_TOL or \
                not line['detections']:
            raise AssertionError(f'export --{tag}-sharded: {line}')
        out[tag] = line
    for tag, line in out.items():
        if not line['verified']:
            raise AssertionError(f'export {tag}: not verified: {line}')
    return out


def traced_benchmark(mode, root):
    """The benchmark CLI on ``imvoxelnet_kitti`` (bfloat16; b=8 serving or
    a b=4 step): untimed by the profiler first, then with ``--trace``, and
    ``tools/analyze_trace.py --top 15 --by-source`` on the trace."""
    from imvoxelnet_tpu_torch.tools import benchmark

    b = '8' if mode == 'fwd' else '4'
    argv = ['imvoxelnet_kitti', '--batch-size', b] + (
        ['--train'] if mode == 'train' else [])
    with contextlib.redirect_stdout(io.StringIO()):
        plain = benchmark.main(argv + ['--iters', str(BENCH_ITERS)])
        traced = benchmark.main(argv + ['--iters', str(TRACED_ITERS),
                                        '--trace',
                                        os.path.join(root, mode)])
    for run in (plain, traced):
        assert_launches(f'benchmark {mode}', {
            k: round(v, 6) for k, v in run['launches_per_iter'].items()},
            BENCH_LAUNCHES[mode])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        digest = analyze_trace.main([traced['traced'], '--top', '15',
                                     '--by-source', '--steps',
                                     str(TRACED_ITERS)])
        kernels_top = analyze_trace.main([traced['traced'], '--top', '15'])
    log(f'analyze_trace {mode}:\n{text.getvalue()}')
    # the digest's device time against the profiler's own total
    # (key_averages), and its kernels launched in the spans against the
    # CUDA-event window of the same run: on one stream the kernels of an
    # iteration take no more than the iteration
    own = traced['profiler_device_ms']
    span_ms, window_ms = digest['spans']['device_ms'], traced['ms_per_batch']
    if abs(digest['device_ms'] - own) > 1e-3 * own or \
            digest['spans']['count'] != TRACED_ITERS or \
            not 0 < span_ms <= window_ms:
        raise AssertionError(f'analyze_trace {mode}: {digest["device_ms"]} '
                             f'ms of device time against the profiler\'s '
                             f'{own}, {digest["spans"]} against '
                             f'{window_ms} ms a batch')
    in_spans = span_ms * TRACED_ITERS / digest['device_ms']
    # B3's kernel among the top rows, billed to the KITTI neck (its dx
    # kernels to the neck's forward code)
    b3 = [r for r in kernels_top['table'] if B3_KERNEL in r['name']]
    b3_sources = {src.replace(' (backward)', '')
                  for name, billed in digest['sources'].items()
                  if B3_KERNEL in name for src in billed}
    if not b3 or b3_sources != {NECK_SOURCE}:
        raise AssertionError(f'analyze_trace {mode}: B3 rows {b3}, billed to '
                             f'{b3_sources}')
    return dict(
        scenes_per_sec=plain['scenes_per_sec'], ms_per_batch=plain[
            'ms_per_batch'], traced_ms_per_batch=traced['ms_per_batch'],
        launches_per_iter=plain['launches_per_iter'], card=plain['card'],
        device_ms_per_iter=digest['device_ms'] / TRACED_ITERS,
        profiler_device_ms_per_iter=own / TRACED_ITERS,
        span_device_ms=digest['spans']['device_ms'],
        span_host_ms=digest['spans']['host_ms'],
        device_ms_in_spans_share=in_spans,
        b3_rank=kernels_top['table'].index(b3[0]) + 1, b3_row=b3[0],
        top_sources=digest['table'][:6])


def microbenchmarks(refs):
    """The four ``bench_*`` tools at reduced repetitions, each checking
    its kernel against its reference; B3's and B2's times beside the same
    kernels' rows of this run's phases 2 and 9 (``refs``)."""
    from imvoxelnet_tpu_torch.tools import (bench_conv3z, bench_iou_kernel,
                                            bench_loader, bench_scatter)

    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        conv = bench_conv3z.main(['--iters', '10'])
        iou = bench_iou_kernel.main(['--iters', '10'])
        nms = bench_iou_kernel.main(['--nms', '--iters', '5'])
        scatter = bench_scatter.main(['--iters', '5'])
        loader = bench_loader.main(['--samples', '64', '--workers', '1,8',
                                    '--target', '136'])
    chosen = {(s['name'], r['pass']): r for s in conv['shapes']
              for r in s['rows'] if r['impl'].endswith('(chosen)')}
    for r in chosen.values():
        if r['max_rel_err'] > 2e-2:
            raise AssertionError(f'bench_conv3z: {r}')
    out['bench_conv3z'] = conv
    out['b3_against_this_run'] = {
        key: dict(bench_ms=chosen[key]['ms'], phase_ms=refs[key],
                  ratio=chosen[key]['ms'] / refs[key])
        for key in (('block0', 'forward'), ('nuscenes', 'forward'),
                    ('nuscenes', 'dx')) if key in refs}
    out['b3_against_this_run'] = {
        ' '.join(k): v for k, v in out['b3_against_this_run'].items()}
    for row in iou['pairwise']:
        if 'bit_identical' in row and not row['bit_identical']:
            raise AssertionError(f'bench_iou_kernel: {row}')
    assert_launches('bench_iou_kernel --nms', nms['nms']['launches'],
                    EXACT_LAUNCHES)
    out['bench_iou_kernel'] = dict(pairwise=iou['pairwise'], nms=nms['nms'])
    out['bench_scatter'] = scatter['runs']
    out['bench_loader'] = loader
    return out


def run_phase14(refs, train_log, untimed=None):
    """Phase 14; returns its summary.  ``refs``: the ms of B3's rows of
    phases 2 and 9 (block0 forward, nuScenes forward and dx), which the
    microbenchmarks' times are set beside; ``train_log``: phase 11's
    ``train_log.jsonl`` (``None`` when the phase runs alone: no summary);
    ``untimed``: ``(root, processes)`` of :func:`start_untimed_tools`, as
    ``smoke`` starts them beside phase 13 (else they start here).  Their
    results are read first; then the timed tools run alone on the card,
    and last the FLOP count, the synthetic KITTI split and the log
    summary."""
    from imvoxelnet_tpu_torch.tools import (analyze_logs, flops,
                                            make_synthetic_kitti)

    out = {}
    t0 = time.perf_counter()
    if untimed is None:
        root = tempfile.mkdtemp(prefix='phase14_')
        untimed = (root, start_untimed_tools(root))
    root, procs = untimed
    try:
        try:
            outs = {tag: mesh.wait_ranks(group, 900)
                    for tag, group in procs.items()}
        finally:
            for group in procs.values():
                for proc in group:
                    if proc.poll() is None:
                        proc.kill()
        out['untimed_wait_s'] = time.perf_counter() - t0
        out['exports'] = check_exports(outs)
        for tag, line in out['exports'].items():
            log(f'export {tag}: {json.dumps(line)}')
        study = tool_line('eval_nms_truncation', outs['truncation'][0])
        for decode in ('truncated', 'exact'):
            assert_launches(f'eval_nms_truncation {decode}',
                            study['launches'][decode], TRUNCATION_LAUNCHES)
        out['truncation'] = study
        log(f'eval_nms_truncation: {json.dumps(study)}')

        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        for mode in ('fwd', 'train'):
            out[f'benchmark_{mode}'] = traced_benchmark(mode, root)
            log(f'benchmark {mode}: {json.dumps(out[f"benchmark_{mode}"])}')
        out.update(microbenchmarks(refs))
        for key in ('b3_against_this_run', 'bench_iou_kernel',
                    'bench_scatter', 'bench_loader'):
            log(f'{key}: {json.dumps(out[key])}')
        out['timed_s'] = time.perf_counter() - t1

        with contextlib.redirect_stdout(io.StringIO()):
            out['flops'] = flops.main(['imvoxelnet_kitti'])
            syn = os.path.join(root, 'synthetic_kitti')
            make_synthetic_kitti.main(['--out', syn, '--train', '8',
                                       '--val', '4'])
            if train_log:
                out['analyze_logs'] = analyze_logs.main(
                    [train_log, '--keys', 'loss', 'loss_cls', 'loss_bbox',
                     'loss_dir'])
        log(f'flops: {json.dumps(out["flops"])}')
        if abs(out['flops']['counted_neck_tf'] -
               out['flops']['analytic_neck_tf']) > 1e-9:
            raise AssertionError(f'flops: the counted neck differs from the '
                                 f'inventory {out["flops"]}')
        out['synthetic_kitti'] = {
            split: read_converted('imvoxelnet_kitti', syn, os.path.join(
                syn, f'kitti_infos_{split}.pkl'))
            for split in ('train', 'val')}
        log(f'synthetic kitti read back: '
            f'{json.dumps(out["synthetic_kitti"])}')
        if train_log:
            if out['analyze_logs']['loss']['n'] < 2:
                raise AssertionError(f'analyze_logs: {out["analyze_logs"]}')
            log(f'analyze_logs on phase 11\'s log: '
                f'{json.dumps(out["analyze_logs"])}')
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out['seconds'] = time.perf_counter() - t0
    return out


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
    # the port's data path needs none of these; say which the machine has
    log(f'modules on this machine: {json.dumps(card_modules())}')

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
        f'(published peak {microbench.PEAK_BYTES / 1e12:.3g} TB/s)')
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

    # the evaluation path: tools/test.py on splits written to disk
    t10 = time.perf_counter()
    evaluation, eval_counts, eval_rows = run_eval()
    for row in eval_rows:
        log(json.dumps(row))
    log(json.dumps({'eval': evaluation}))
    log(f'phase 10 (eval): {time.perf_counter() - t10:.1f} s')

    # training from files: tools/train.py on splits written to disk
    t11 = time.perf_counter()
    # phase 13's data-parallel runs share the card with the learning loops
    # (beside phase 13 itself and phase 14's untimed runs they overfill
    # the card's memory)
    multihost = []
    keep = tempfile.mkdtemp(prefix='phase11_log_')
    train_log = os.path.join(keep, 'train_log.jsonl')
    from_files, cli_counts = run_train_from_files(
        lambda: multihost.extend(start_multihost_runs()), train_log)
    log(json.dumps({'train_from_files': from_files}))
    log(f'phase 11 (train from files): {time.perf_counter() - t11:.1f} s')
    # phase 12 times kernels and programs: nothing else on the card then
    t_join = time.perf_counter()
    for thread in multihost[0]:
        thread.join()
    log(f'phase 13\'s multihost runs joined {time.perf_counter() - t_join:.1f}'
        f' s after phase 11; nothing else runs on the card in phase 12')

    # serving export, --show-dir, the fold, and the paths no preset takes
    t12 = time.perf_counter()
    phase12, phase12_rows = run_phase12()
    for row in phase12_rows:
        log(json.dumps(row))
    log(json.dumps({'phase12': phase12}))
    log(f'phase 12 (export, show-dir, fold, exact NMS, GIoU): '
        f'{time.perf_counter() - t12:.1f} s')

    # converted splits, and data parallelism on one card; phase 14's
    # untimed exports and truncation study run beside it
    untimed_root = tempfile.mkdtemp(prefix='phase14_')
    untimed = (untimed_root, start_untimed_tools(untimed_root))
    phase13, views_launches = run_phase13(multihost)
    log(json.dumps({'phase13': phase13}))
    log(f'phase 13 (converters, data parallelism): '
        f'{phase13["seconds"]:.1f} s')

    # the export tool's multi-device programs and the measurement tools
    refs = {('block0', 'forward'): serving[3]['ms'],
            ('nuscenes', 'forward'): nuscenes_rows[1][0]['ms'],
            ('nuscenes', 'dx'): nuscenes_rows[2][0]['ms']}
    try:
        phase14 = run_phase14(refs, train_log, untimed)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    log(json.dumps({'phase14': phase14}))
    log(f'phase 14 (multi-device export, measurement tools): '
        f'{phase14["seconds"]:.1f} s (the untimed runs started with phase '
        f'13: {phase14["untimed_wait_s"]:.1f} s more; the timed tools '
        f'{phase14["timed_s"]:.1f} s)')
    # B1 at a rank's 25 views of phase 13's view-sharded ScanNet, timed
    # once phase 14's processes are gone
    views_row = check_backproject(1, torch.float32, 1e-5, rng,
                                  'imvoxelnet_scannet', views=25)
    log(json.dumps(views_row))

    log(microbench.card())
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
    # (the KITTI serving rows also carry their launches in phase 10's
    # tools/test.py run over 4 batches of 8 frames, the pairwise rows the
    # protocol's launches in the tool's run on their split, all asserted);
    # phase 12's rows (the pairwise entry and the scan of the exact NMS at
    # imvoxelnet_sunrgbd b=8, the scan of the axis-aligned BEV NMS at
    # imvoxelnet_kitti b=8, the paired entry and its backward under
    # giou_3d_loss) with the launches of the run that gave their inputs
    for r in serving:
        r['eval_launches'] = eval_counts[r['name']]
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
               for r, use in nuscenes_rows] \
            + [(r, r['eval_launches']) for r in eval_rows] \
            + [(r, r['launches']) for r in phase12_rows] \
            + [(views_row, views_launches['backproject'])]:
        entry = {k: row[k] for k in (
            'name', 'route', 'source', 'replaces', 'max_abs_err', 'ms',
            'plain_ms', 'bound_ms', 'bound_by', 'library_ms')}
        entry['launches'] = launches
        entry['shape'] = row['shape']
        if 'eval_launches' in row:
            entry['eval_launches'] = row['eval_launches']
        if any(row is r for r in [bp_grad_row] + train_rows):
            entry['cli_launches'] = {
                use: counts_of[row['name']]
                for use, counts_of in cli_counts.items()}
        summary.append(entry)
    log(json.dumps({'kernels': summary}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
