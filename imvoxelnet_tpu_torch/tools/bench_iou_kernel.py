"""Microbenchmark of kernel B2 (``kernels/csrc/rect_clip.cu``, the rotated
rectangles' intersection areas) against its plain version, on the card.

    python -m imvoxelnet_tpu_torch.tools.bench_iou_kernel [--iters 10]
        [--sizes 256,1000,3000] [--plain-max 1000]
    python -m imvoxelnet_tpu_torch.tools.bench_iou_kernel --nms

Counterpart of the JAX package's ``tools/bench_iou_kernel.py``.  For each
N it times with CUDA events (the launches queued behind a spin kernel,
``microbench.cuda_ms``) B2's pairwise entry on N x N pairs of random
rectangles (centres within 40 m, sides 0.5-5 m, any yaw; the JAX tool's)
and, up to ``--plain-max`` (the plain clip over 9 M pairs takes seconds),
``ops/iou.py:rect_intersection_area_pairwise_plain`` on the same corners,
with the largest gap between the two and whether they agree bit for bit.
``--nms`` times ``ops/nms.py:multiclass_nms_3d_exact`` end to end instead:
3,000 candidates of 10 classes, ``score_thr`` 0 (every candidate in every
class), with the kernel launches of one call (B2's pairwise entry once, the
scan once).  The JAX tool's ``--tile`` and ``--skip-xla`` select among its
Pallas variants and have no counterpart: B2 has one pairwise entry.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import kernels
from ..kernels import rect_clip as clip_kernel
from ..ops import boxes as box_ops
from ..ops import iou as iou_ops
from ..ops import nms as nms_ops
from . import microbench

QUEUE_US = 30


def rects(rng, n):
    xy = rng.uniform(-40, 40, (n, 2))
    wh = rng.uniform(0.5, 5.0, (n, 2))
    r = rng.uniform(-np.pi, np.pi, (n, 1))
    return torch.tensor(np.concatenate([xy, wh, r], 1), dtype=torch.float32,
                        device='cuda')


def bench_pairwise(n, iters, plain_max, rng):
    c1 = box_ops.bev_corners(rects(rng, n))[None].contiguous()
    c2 = box_ops.bev_corners(rects(rng, n))[None].contiguous()
    got = clip_kernel.rect_intersection_area_pairwise(c1, c2)
    # the launches queued behind a spin kernel: a small call is faster
    # than the host launches it
    row = dict(n=n, pairs=n * n, ms=microbench.cuda_ms(
        lambda: clip_kernel.rect_intersection_area_pairwise(c1, c2), iters,
        queue_us=QUEUE_US), overlapping=int((got > 0).sum()))
    row['ns_per_pair'] = row['ms'] * 1e6 / (n * n)
    if n <= plain_max:
        ref = iou_ops.rect_intersection_area_pairwise_plain(c1, c2)
        row.update(plain_ms=microbench.cuda_ms(
            lambda: iou_ops.rect_intersection_area_pairwise_plain(c1, c2),
            max(2, iters // 5)),
            max_abs_err=float((got - ref).abs().max()),
            bit_identical=bool(torch.equal(got, ref)))
    return row


def bench_nms(iters, rng, n=3000, n_cls=10):
    base = rects(rng, n)
    boxes = torch.cat([base[:, :2], torch.zeros_like(base[:, :1]),
                       base[:, 2:4], torch.ones_like(base[:, :1]),
                       base[:, 4:5]], dim=1)
    bev = torch.cat([boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6:7]], dim=1)
    scores = torch.tensor(rng.uniform(0, 1, (n, n_cls)), dtype=torch.float32,
                          device='cuda')
    valid = torch.ones(n, dtype=torch.bool, device='cuda')

    def run():
        return nms_ops.multiclass_nms_3d_exact(
            boxes, bev, scores, valid, score_thr=0.0, max_num=1000,
            iou_thr=0.25)
    run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    return dict(candidates=n, classes=n_cls, ms=microbench.cuda_ms(
        run, iters), launches=launches, kept=int(out['valid'].sum()),
        top_score=float(out['scores'][0]))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--iters', type=int, default=10)
    parser.add_argument('--sizes', default='256,1000,3000',
                        help='comma list of N for N x N pairs')
    parser.add_argument('--plain-max', type=int, default=1000,
                        help='the largest N the plain clip runs at')
    parser.add_argument('--nms', action='store_true',
                        help='time multiclass_nms_3d_exact end to end '
                             '(3,000 candidates, score_thr 0) instead')
    args = parser.parse_args(argv)
    microbench.require_cuda('bench_iou_kernel')
    rng = np.random.RandomState(0)
    out = dict(card=microbench.card())
    print(out['card'])
    if args.nms:
        out['nms'] = res = bench_nms(args.iters, rng)
        print(f'exact NMS {res["candidates"]} candidates x {res["classes"]} '
              f'classes: {res["ms"]:.3f} ms, {res["kept"]} kept, launches '
              f'{json.dumps(res["launches"])}')
    else:
        out['pairwise'] = []
        for n in (int(s) for s in args.sizes.split(',')):
            row = bench_pairwise(n, args.iters, args.plain_max, rng)
            out['pairwise'].append(row)
            plain = (f'  plain {row["plain_ms"]:.3f} ms, max abs gap '
                     f'{row["max_abs_err"]:.2e}, bit identical '
                     f'{row["bit_identical"]}' if 'plain_ms' in row else '')
            print(f'B2 pairwise {n}x{n} ({row["pairs"] / 1e6:.2f} M pairs): '
                  f'{row["ms"]:.4f} ms ({row["ns_per_pair"]:.3f} ns/pair)'
                  f'{plain}')
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
