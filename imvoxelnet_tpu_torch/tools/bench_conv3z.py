"""Microbenchmark of kernel B3 (``kernels/csrc/conv3x3x3.cu``, the 3x3x3
64 -> 64 conv) against the library conv, on the card.

    python -m imvoxelnet_tpu_torch.tools.bench_conv3z [--iters 20]
        [--shapes block0,nuscenes] [--dtype bfloat16]

Counterpart of the JAX package's ``tools/bench_conv3z.py``.  At each shape
(``block0``: the KITTI neck's (8, 216, 248, 12, 64); ``nuscenes``: its
(1, 312, 312, 12, 64)) it times with CUDA events B3's forward and its
``dx`` (the conv on the transposed kernel, as ``ops/conv3z.py`` runs it)
on the tilings the wrapper takes (``kernels/conv3x3x3.py:tile_plan``: the
one it chooses, then 2x18 and 4x8 forced, where they fit), and the
library's ``F.conv3d`` and ``convolution_backward`` (its input gradient) on
the same operands.  It reports each time, the share of the card's dense
peak for the dtype, and the largest error against the library's result
relative to its max-abs.  The JAX tool's sweep of Pallas tiles has no other
counterpart: B3's tile is chosen by the volume's shape.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..kernels import conv3x3x3 as conv_kernel
from ..ops import conv3z
from . import microbench

SHAPES = {'block0': (8, 216, 248, 12, 64), 'nuscenes': (1, 312, 312, 12, 64)}
TILES = ((2, 18), (4, 8))


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max())


def bench_shape(shape, dtype, iters, seed=0):
    """The rows of one shape: B3's forward and ``dx`` on each tiling, and
    the library's, with times, peak shares and errors."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(*shape), dtype=dtype, device='cuda')
    k = torch.tensor(rng.randn(3, 3, 3, 64, 64) * 0.05, dtype=dtype,
                     device='cuda')
    g = torch.tensor(rng.randn(*shape), dtype=dtype, device='cuda')
    kt = conv3z.transpose_kernel(k)
    flops = 2 * 27 * 64 * 64 * int(np.prod(shape[:4]))
    peak = microbench.PEAK_FLOPS[dtype]

    def share(ms):
        return flops / (ms * 1e-3) / peak

    ref = conv3z.conv3x3x3_plain(x, k)
    xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)

    def library_dx():
        return torch.ops.aten.convolution_backward(
            g.permute(0, 4, 1, 2, 3), xc, kc, None, [1, 1, 1], [1, 1, 1],
            [1, 1, 1], False, [0, 0, 0], 1, [True, False, False])[0]
    ref_dx = library_dx().permute(0, 2, 3, 4, 1)
    rows = [dict(impl='F.conv3d', pass_='forward', ms=microbench.cuda_ms(
                 lambda: conv3z.conv3x3x3_plain(x, k), iters)),
            dict(impl='convolution_backward', pass_='dx',
                 ms=microbench.cuda_ms(library_dx, iters))]
    chosen = conv_kernel.tile_plan(*shape[1:4])
    for tile in [None] + [t for t in TILES if t != (chosen.tx, chosen.ty)]:
        try:
            plan = conv_kernel.tile_plan(*shape[1:4], tile)
        except ValueError:
            continue
        name = f'B3 {plan.tx}x{plan.ty}' + (' (chosen)' if tile is None
                                             else '')
        for pass_, a, w, want in (('forward', x, k, ref),
                                  ('dx', g, kt, ref_dx)):
            got = conv_kernel.conv3x3x3(a, w, tile)
            rows.append(dict(impl=name, pass_=pass_, ms=microbench.cuda_ms(
                lambda: conv_kernel.conv3x3x3(a, w, tile), iters),
                max_rel_err=rel_err(got, want)))
    for row in rows:
        row['peak_share'] = share(row['ms'])
        row['pass'] = row.pop('pass_')
    return dict(shape=list(shape), dtype=str(dtype).split('.')[-1],
                tflop=flops / 1e12, rows=rows)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--shapes', default='block0,nuscenes',
                        help=f'comma list of {sorted(SHAPES)}')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=('bfloat16', 'float32'))
    args = parser.parse_args(argv)
    microbench.require_cuda('bench_conv3z')
    dtype = getattr(torch, args.dtype)
    out = dict(card=microbench.card(), shapes=[])
    print(out['card'])
    for name in args.shapes.split(','):
        res = bench_shape(SHAPES[name], dtype, args.iters)
        res['name'] = name
        out['shapes'].append(res)
        print(f'{name} {tuple(res["shape"])} {res["dtype"]}: '
              f'{res["tflop"]:.3f} TFLOP a pass')
        for row in res['rows']:
            err = (f'  max rel err {row["max_rel_err"]:.2e}'
                   if 'max_rel_err' in row else '')
            print(f'  {row["impl"]:24s} {row["pass"]:8s} {row["ms"]:8.3f} '
                  f'ms  {100 * row["peak_share"]:5.1f}% of peak{err}')
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
