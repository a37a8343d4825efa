"""Microbenchmark of the backprojection's backward (B1's backward,
``kernels/csrc/backproject.cu``) against ``index_add_``, on the card.

    python -m imvoxelnet_tpu_torch.tools.bench_scatter [--iters 10]

Counterpart of the JAX package's ``tools/bench_scatter.py``, on its index
pattern: the KITTI grid (216 x 248 x 12 voxels of 0.64 x 0.64 x 0.33 m)
seen by B = 8 stride-4 cameras (fx/4 = 177 px, the principal point moved a
pixel a sample, the camera 70-77 m behind the grid looking along its x
axis) on a 96 x 320 feature map, C = 64; the rows in the joint-table
layout of the JAX ``backproject_batch`` (voxel-major, batch-minor, each
sample's table offset by its H*W rows).  Its gradient rows are random.

It times with CUDA events, in bfloat16 and in float32, B1's backward kernel
(``kernels/backproject.py:backproject_batch_grad``: a pixel-major gather,
no atomics) and ``Tensor.index_add_`` of the seen voxels' rows into the
table, once in that layout (unsorted) and once on rows sorted by their
table row beforehand (the sort not timed).  For each it reports the bytes
the backward must move (the seen voxels' gradient rows read once, the
table written once) over its time against the card's 3.35 TB/s, and it
holds the kernel's result, and float32 ``index_add_``'s on unsorted and
sorted rows, to float32 ``index_add_`` (float32: 1e-5 of the max-abs;
bfloat16: the kernel rounds a float32 sum once, 8e-3); the gap of
bfloat16 ``index_add_``, which adds in bfloat16, is reported.  The JAX tool's
other formulations (vmap, segment_sum, cumulative sums) are XLA rewrites
of the scatter and have no counterpart; B1's backward is the port's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..kernels import backproject as bp_kernel
from ..ops import backproject as bp
from . import microbench

B, HF, WF, C = 8, 96, 320, 64
N_VOXELS, VOXEL_SIZE = (216, 248, 12), (0.64, 0.64, 0.33)
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def index_pattern(device='cuda'):
    """``points (B, P, 3)``, ``projections (B, 1, 3, 4)``, ``valid_hw (B,
    2)`` of the KITTI grid and the JAX tool's B cameras."""
    pts = bp.get_points(N_VOXELS, VOXEL_SIZE, torch.zeros(
        1, 3, device=device)).reshape(-1, 3)
    projs = []
    for b in range(B):
        k = np.array([[177.0, 0, 160.0 + b], [0, 177.0, 48.0], [0, 0, 1.0]])
        e = np.eye(4)
        # the camera looks along +x of the grid (grid x -> camera z)
        e[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
        e[:3, 3] = [0.0, 0.8, 70.0 + b]
        projs.append(k @ e[:3])
    projections = torch.tensor(np.stack(projs)[:, None], dtype=torch.float32,
                               device=device)
    valid_hw = torch.tensor([[HF, WF]] * B, dtype=torch.int32, device=device)
    return pts[None].expand(B, -1, -1).contiguous(), projections, valid_hw


def bench(dtype, iters, points, projections, valid_hw, seed=0):
    p = points.shape[1]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    grad = torch.randn((p, B, C), generator=gen, device='cuda').to(dtype)
    idx, valid = bp._view_indices(points, projections, valid_hw, HF, WF)
    # voxel-major, batch-minor rows, each sample's table offset by H*W
    joint = (idx[:, 0] + torch.arange(B, device='cuda')[:, None] * HF * WF
             ).transpose(0, 1)                                 # (P, B)
    seen = valid[:, 0].transpose(0, 1)
    rows, data = joint[seen], grad[seen]
    order = torch.argsort(rows, stable=True)
    rows_sorted, data_sorted = rows[order], data[order]
    table_shape = (B * HF * WF, C)
    n_bytes = (data.numel() + B * HF * WF * C) * data.element_size()

    def kernel():
        return bp_kernel.backproject_batch_grad(grad, points, projections,
                                                valid_hw, HF, WF)

    def index_add(r, d):
        return torch.zeros(table_shape, dtype=dtype,
                           device='cuda').index_add_(0, r, d)
    ref = torch.zeros(table_shape, device='cuda').index_add_(
        0, rows, data.float())
    scale = float(ref.abs().max())
    out = {}
    for name, fn in (('B1 backward', kernel),
                     ('index_add_', lambda: index_add(rows, data)),
                     ('index_add_ sorted',
                      lambda: index_add(rows_sorted, data_sorted))):
        got = fn().reshape(table_shape).float()
        gap = float((got - ref).abs().max()) / scale
        # bfloat16 index_add_ adds in bfloat16 (its gap is reported)
        if gap > TOL[dtype] and (name == 'B1 backward'
                                 or dtype == torch.float32):
            raise AssertionError(f'bench_scatter {name} {dtype}: {gap:.3g} '
                                 f'of the max-abs from float32 index_add_')
        ms = microbench.cuda_ms(fn, iters)
        out[name] = dict(ms=ms, gap=gap,
                         tb_per_s=n_bytes / (ms * 1e-3) / 1e12,
                         bound_share=n_bytes / microbench.PEAK_BYTES
                         / (ms * 1e-3))
    return dict(dtype=str(dtype).split('.')[-1], rows=int(seen.sum()),
                voxels=p, bytes=n_bytes, impls=out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--iters', type=int, default=10)
    args = parser.parse_args(argv)
    microbench.require_cuda('bench_scatter')
    points, projections, valid_hw = index_pattern()
    out = dict(card=microbench.card(), runs=[])
    print(out['card'])
    for dtype in (torch.bfloat16, torch.float32):
        res = bench(dtype, args.iters, points, projections, valid_hw)
        out['runs'].append(res)
        print(f'{res["dtype"]}: {res["rows"]} seen (voxel, sample) rows of '
              f'{B} x {res["voxels"]}, {res["bytes"] / 1e9:.3f} GB to move')
        for name, r in res['impls'].items():
            print(f'  {name:18s} {r["ms"]:8.3f} ms  {r["tb_per_s"]:.3f} '
                  f'TB/s ({100 * r["bound_share"]:.1f}% of 3.35)  gap '
                  f'{r["gap"]:.2e}')
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
