"""Wrapper of the 3x3x3 64->64 conv kernel (``csrc/conv3x3x3.cu``).

Replaces ``imvoxelnet_tpu/ops/conv3z_pallas.py:conv3z_lanepack``.  The plain
version is ``ops/conv3z.py:conv3x3x3_plain`` (``F.conv3d``).

What the kernel needs from the host is done here and is testable without a
card: the weight pack (``pack_weights``), the tiling plan (``tile_plan``) and
``conv3x3x3_rows_plain``, which walks the plan's tiles, rows and tap offsets
exactly as the bfloat16 kernel does, in plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import build
from ._checks import require, same_device, stream_of

launches = 0
CHANNELS = 64

# The bfloat16 kernel's fixed sizes (``csrc/conv3x3x3.cu``).
ROW_BYTES = 128                   # one site: 64 bfloat16 channels
GROUP_ROWS = 256                  # rows of one wgmma, one consumer warpgroup
MAX_GROUPS = 2                    # consumer warpgroups of a block
_W_RING_BYTES = 4 * CHANNELS * ROW_BYTES
_BARRIER_BYTES = 9 * 8
SMEM_LIMIT = 232448               # dynamic shared memory of one H100 block
# The C entry point's own error codes, beside CUDA's.
_ERRORS = {10001: 'cuTensorMapEncodeTiled not found in libcuda',
           10002: 'cuTensorMapEncodeTiled refused the tensor map',
           10003: 'the tile does not fit the kernel'}


def pack_weights(kernel):
    """``(3, 3, 3, ci, co)`` -> ``(27, co, ci)`` contiguous: tap-major
    (``tap = (dx*3 + dy)*3 + dz``), each tap K-major (input channel
    innermost), the layout both matrix operands of the kernel take."""
    _, _, _, ci, co = kernel.shape
    return kernel.reshape(27, ci, co).transpose(1, 2).contiguous()


def unpack_weights(packed):
    """Inverse of :func:`pack_weights`."""
    _, co, ci = packed.shape
    return packed.transpose(1, 2).reshape(3, 3, 3, ci, co).contiguous()


def split3_bf16(t):
    """float32 ``t`` as three bfloat16 parts, stacked on a new first axis,
    that sum to it: the nearest bfloat16, the nearest to what is left, and
    the nearest to what is left then (each difference is exact in float32).
    The float32 path multiplies such parts on the tensor cores."""
    parts, rest = [], t.float()
    for _ in range(3):
        part = rest.to(torch.bfloat16)
        parts.append(part)
        rest = rest - part.float()
    return torch.stack(parts)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the bfloat16 kernel cuts a ``(nx, ny, nz)`` volume.

    A block owns ``tx x ty`` columns of the (x, y) plane over all of z and
    holds them with a one-site halo as ``halo_rows`` rows of 128 bytes,
    ``(tx+2)(ty+2)`` columns of ``nz+1`` rows (z = -1 .. nz-1).  It computes
    the ``rows`` consecutive rows from ``first_row`` on (``n_groups``
    warpgroups of 256) and stores those that are sites of its tile.
    """
    tx: int
    ty: int
    n_groups: int
    rows: int             # n_groups * 256
    first_row: int        # row of site (0, 0, 0) of the tile
    halo_rows: int
    alloc_rows: int       # rows of the shared buffer (zero beyond the halo)
    grid: tuple           # blocks along (x, y)
    smem_bytes: int

    def tap_offset(self, dx: int, dy: int, dz: int, nz: int) -> int:
        """Row offset of tap ``(dx, dy, dz)``, each in -1..1."""
        return (dx * (self.ty + 2) + dy) * (nz + 1) + dz


def _plan(nx: int, ny: int, nz: int, tx: int, ty: int):
    zp, cols = nz + 1, ty + 2
    n_rows = ((tx - 1) * cols + ty) * zp - 1     # first to last site
    n_groups = -(-n_rows // GROUP_ROWS)
    first_row = (cols + 1) * zp + 1
    halo_rows = (tx + 2) * cols * zp
    # the last tap of the last computed row, and the zero row after the halo
    alloc_rows = max(2 * first_row + GROUP_ROWS * n_groups, halo_rows + 1)
    alloc_rows = -(-alloc_rows // 8) * 8
    smem = 1024 + alloc_rows * ROW_BYTES + _W_RING_BYTES + _BARRIER_BYTES
    return TilePlan(tx=tx, ty=ty, n_groups=n_groups,
                    rows=n_groups * GROUP_ROWS,
                    first_row=first_row, halo_rows=halo_rows,
                    alloc_rows=alloc_rows,
                    grid=(-(-nx // tx), -(-ny // ty)), smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def tile_plan(nx: int, ny: int, nz: int, tile=None) -> TilePlan:
    """The tile ``(tx, ty)`` of the (x, y) plane for a ``(nx, ny, nz)``
    volume, and what follows from it.

    Among the tiles whose rows fit the block's ``MAX_GROUPS`` warpgroups and
    whose buffers fit shared memory, takes the one with the least estimated
    work: per block the MMA rows, a quarter of that per halo row loaded, and
    a constant for the weights every block streams.  ``tile`` forces
    ``(tx, ty)``.  Raises ``ValueError`` for a volume no tile can take.
    """
    if min(nx, ny, nz) < 1 or nz + 1 > 256:
        raise ValueError(f'no tiling for volume {(nx, ny, nz)}')
    if tile is not None:
        plans = [_plan(nx, ny, nz, *tile)]
    else:
        plans = [_plan(nx, ny, nz, tx, ty)
                 for tx in range(1, min(nx, 16) + 1)
                 for ty in range(1, min(ny, 64) + 1)]
    plans = [p for p in plans if p.n_groups <= MAX_GROUPS
             and p.smem_bytes <= SMEM_LIMIT]
    if not plans:
        raise ValueError(f'no tiling for volume {(nx, ny, nz)}, tile {tile}')

    def cost(p):
        return p.grid[0] * p.grid[1] * (p.rows + p.halo_rows // 4 + 64)
    return min(plans, key=lambda p: (cost(p), p.tx, p.ty))


def conv3x3x3_rows_plain(x, packed, plan=None):
    """The bfloat16 kernel's algorithm in plain PyTorch (float32 sums).

    ``x (B, nx, ny, nz, C)``, ``packed (27, co, ci)``.  For every block of
    the plan: the haloed tile as linear rows, ``plan.rows`` output rows from
    ``plan.first_row`` on as the sum over taps of the rows at the tap's
    offset times the tap's weights, and the store of the rows that are sites
    of the tile.
    """
    b, nx, ny, nz, c = x.shape
    plan = plan or tile_plan(nx, ny, nz)
    tx, ty, zp, cols = plan.tx, plan.ty, nz + 1, plan.ty + 2
    out = torch.zeros((b, nx, ny, nz, packed.shape[1]), dtype=x.dtype,
                      device=x.device)
    written = torch.zeros((b, nx, ny, nz), dtype=torch.int32, device=x.device)
    # the volume with the zeros the TMA fills in: z = -1, and a tile of halo
    px, py = plan.grid[0] * tx + 2, plan.grid[1] * ty + 2
    padded = torch.zeros((b, px, py, zp, c), dtype=torch.float32,
                         device=x.device)
    padded[:, 1:nx + 1, 1:ny + 1, 1:] = x.float()
    w = packed.float()
    r = plan.first_row + torch.arange(plan.rows, device=x.device)
    xh = r // (cols * zp)
    yh = (r % (cols * zp)) // zp
    zh = r % zp
    for ix in range(plan.grid[0]):
        for iy in range(plan.grid[1]):
            x0, y0 = ix * tx, iy * ty
            halo = padded[:, x0:x0 + tx + 2, y0:y0 + ty + 2]
            buf = torch.zeros((b, plan.alloc_rows, c), dtype=torch.float32,
                              device=x.device)
            buf[:, :plan.halo_rows] = halo.reshape(b, plan.halo_rows, c)
            acc = torch.zeros((b, plan.rows, w.shape[1]), dtype=torch.float32,
                              device=x.device)
            for tap in range(27):
                off = plan.tap_offset(tap // 9 - 1, (tap // 3) % 3 - 1,
                                      tap % 3 - 1, nz)
                lo = plan.first_row + off
                acc += buf[:, lo:lo + plan.rows] @ w[tap].T
            gx, gy = x0 + xh - 1, y0 + yh - 1
            keep = ((xh >= 1) & (xh <= tx) & (yh >= 1) & (yh <= ty)
                    & (zh >= 1) & (gx < nx) & (gy < ny))
            out[:, gx[keep], gy[keep], zh[keep] - 1] = acc[:, keep].to(x.dtype)
            written[:, gx[keep], gy[keep], zh[keep] - 1] += 1
    if not bool((written == 1).all()):
        raise AssertionError('tiling does not cover every site exactly once')
    return out


def conv3x3x3(x, kernel, tile=None):
    """3x3x3 SAME stride-1 conv, ``(B, nx, ny, nz, 64) x (3, 3, 3, 64, 64)``.

    Both in channels-last (NDHWC / DHWIO) layout, both float32 or both
    bfloat16; accumulates in float32 and returns ``x.dtype``.  Runs on the
    tensor cores over :func:`tile_plan`'s tiles (``tile`` forces
    ``(tx, ty)``); float32 as six products of bfloat16 parts
    (:func:`split3_bf16`), which keeps float32's accuracy.
    """
    global launches
    require(x, 'x', (torch.float32, torch.bfloat16), 5)
    require(kernel, 'kernel', (x.dtype,), 5)
    same_device(x, kernel)
    b, nx, ny, nz, cin = x.shape
    if cin != CHANNELS or kernel.shape != (3, 3, 3, CHANNELS, CHANNELS):
        raise ValueError(f'kernel takes 64 -> 64 channels, got x '
                         f'{tuple(x.shape)} and kernel {tuple(kernel.shape)}')
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = tile_plan(nx, ny, nz, tile)
    if b * plan.grid[0] * plan.grid[1] >= 2 ** 31:
        raise ValueError(f'too many blocks for x {tuple(x.shape)}')
    packed = pack_weights(kernel)
    if x.dtype == torch.bfloat16:
        x_parts = None
    else:
        packed = split3_bf16(packed)
        x_parts = torch.empty((3,) + tuple(x.shape), dtype=torch.bfloat16,
                              device=x.device)
    err = build.kernel('conv3x3x3')(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(),
        None if x_parts is None else x_parts.data_ptr(),
        int(x.dtype == torch.bfloat16), b, nx, ny, nz, plan.tx, plan.ty,
        stream_of(x))
    if err in _ERRORS:
        raise RuntimeError(f'conv3x3x3 kernel not launched: {_ERRORS[err]}')
    build.check(err, 'conv3x3x3')
    launches += 1
    return out
