"""The SUN RGB-D training slice of the PyTorch port against the JAX package,
on the CPU.

Module by module (the box helpers, the centerness, the rotated 3D IoU, the
BCE and IoU-3D losses, the backward of the rotated-rect clip, the v1 / v1
top-k / v2 target assignment, the head loss) and then the slice as a
whole: ``make_train_step`` for 3 steps against ``jax.jit`` of the JAX
``make_train_step`` on the tiny indoor configs of
``tests/_torch_port_fixtures.py`` (v1, v1 with ``centerness_topk`` set as
in the ``_top27`` presets, and ``fast`` with head v2), from the same
weights (``from_jax_variables``) and the same numpy batch
(``utils/synthetic.py:sunrgbd_train_batch`` at 128x96).

The clip's backward on the card is a kernel (``kernels/csrc/rect_clip.cu``,
``imvx_rect_clip_grad``); here a plain-PyTorch emulation of its reverse
sweep is held to autograd of the plain clip, which is held to ``jax.vjp`` of
the JAX package's jnp clip, and the kernel's two passes (zeros, then the
sweep over the listed live pairs) are held to the sweep over every pair.
One known difference: at a clipped area of exactly 0 with 3 or more
vertices (touching rects), PyTorch takes the derivative of ``|x|`` at 0 as
0, JAX (``jax.grad(jnp.abs)(0.)``) as 1; the port, kernel included, follows
PyTorch.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from imvoxelnet_tpu.models import detector as jax_det
from imvoxelnet_tpu.models.heads import imvoxel_heads as jax_ivh
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops import losses as jax_losses
from imvoxelnet_tpu.parallel import train as jax_train

from imvoxelnet_tpu_torch.models import detector
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import losses
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import synthetic
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

from _torch_port_fixtures import (jax_variables, port_model,
                                  projection_margin, tiny_indoor_cfgs,
                                  to_torch)

TOL = 1e-5                 # module parity (float32, another op order)
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-5
GRAD_TOL = 2e-2            # test_full_train_loss_parity.py:205
STATS_TOL = 1e-3
# float64 distances of every point from a face, a regress-range edge and a
# box's k-th centerness stay clear of float32 noise
MARGIN = 1e-4
PIXEL_MARGIN = 1e-4
STEPS = 3
MAX_GT = 12
TOPK_V1 = 5                # the tiny stand-in for the _top27 presets' 28


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


# --------------------------------------------------------------------------
# geometry and losses
# --------------------------------------------------------------------------

def _rand_boxes(rng, n, spread=3.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 3)),
                           rng.uniform(0.2, 2.5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


def test_box_helpers_match_jax():
    rng = np.random.RandomState(0)
    boxes = _rand_boxes(rng, 64)
    for name in ('volume', 'gravity_center'):
        np.testing.assert_allclose(
            getattr(box_ops, name)(_t(boxes)).numpy(),
            np.asarray(getattr(jax_boxes, name)(_j(boxes))),
            rtol=TOL, atol=TOL, err_msg=name)
    bev = boxes[:, [0, 1, 3, 4, 6]]
    got = box_ops.bev_corners_loss(_t(bev)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_boxes.bev_corners_loss(_j(bev))),
        rtol=TOL, atol=TOL)
    # the loss convention rotates the other way from bev_corners
    flipped = bev.copy()
    flipped[:, 4] *= -1
    np.testing.assert_allclose(
        got, box_ops.bev_corners(_t(flipped)).numpy(), rtol=TOL, atol=TOL)


def test_compute_centerness_matches_jax():
    rng = np.random.RandomState(1)
    t = rng.uniform(-0.5, 2.0, (300, 7)).astype(np.float32)
    t[:20, :6] = np.abs(t[:20, :6])
    got = ivh.compute_centerness(_t(t)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_ivh.compute_centerness(_j(t))), rtol=TOL,
        atol=TOL)
    assert (got > 0).sum() >= 20 and (got == 0).any()


def _aligned_pairs(rng, n):
    """Predicted gravity-center boxes near their targets, as in the v1
    loss, with some disjoint, nested and identical pairs."""
    target = _rand_boxes(rng, n)
    pred = target + np.concatenate(
        [0.2 * rng.randn(n, 3), 0.1 * rng.randn(n, 3), 0.3 * rng.randn(n, 1)],
        -1).astype(np.float32)
    pred[:10, :2] += 20.0                                  # disjoint
    pred[10:20] = target[10:20]                            # identical
    pred[20:30] = target[20:30]                            # nested
    pred[20:30, 3:6] *= 0.5
    return pred, target


def test_iou_3d_aligned_matches_jax():
    pred, target = _aligned_pairs(np.random.RandomState(2), 400)
    got = iou_ops.iou_3d_aligned(_t(pred), _t(target)).numpy()
    ref = np.asarray(jax_iou.iou_3d_aligned(_j(pred), _j(target)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert (got[:10] == 0).all() and np.allclose(got[10:20], 1, atol=1e-5)
    np.testing.assert_allclose(got[20:30], 0.125, atol=1e-5)


@pytest.mark.parametrize('name', ['binary_cross_entropy', 'iou_3d_loss'])
def test_indoor_loss_matches_jax(name):
    rng = np.random.RandomState(3)
    n = 300
    weight = (rng.uniform(size=n) > 0.3).astype(np.float32) * rng.uniform(
        0.2, 1.0, n).astype(np.float32)
    if name == 'binary_cross_entropy':
        args = (rng.randn(n).astype(np.float32) * 3,
                rng.uniform(0, 1, n).astype(np.float32))
    else:
        args = _aligned_pairs(rng, n)
    kw = dict(avg_factor=17.0, loss_weight=1.0)
    ref = getattr(jax_losses, name)(*map(_j, args), weight=_j(weight), **kw)
    got = getattr(losses, name)(*map(_t, args), weight=_t(weight), **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=TOL, atol=TOL)
    # a (B,) avg_factor normalizes each sample by its own factor
    factors = torch.tensor([17.0, 5.0, 0.0])
    per = getattr(losses, name)(
        *(_t(a).reshape(3, 100, *a.shape[1:]) for a in args),
        weight=_t(weight).reshape(3, 100), avg_factor=factors)
    for i in range(3):
        one = getattr(jax_losses, name)(
            *(_j(a[100 * i:100 * (i + 1)]) for a in args),
            weight=_j(weight[100 * i:100 * (i + 1)]),
            avg_factor=float(factors[i]))
        np.testing.assert_allclose(float(per[i]), float(one), rtol=TOL,
                                   atol=TOL)


# --------------------------------------------------------------------------
# the clip's backward (kernel B2, paired entry)
# --------------------------------------------------------------------------

def _clip_pairs(rng, n=600):
    """Corner pairs ``(P, 4, 2)``: overlapping rotated rects, then nested,
    identical, touching and disjoint ones, and area gradients with zeros."""
    a = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                        rng.uniform(0.3, 3.0, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    b = a + np.concatenate([0.5 * rng.randn(n, 2), 0.3 * rng.randn(n, 2),
                            0.5 * rng.randn(n, 1)], -1)
    b[:, 2:4] = np.abs(b[:, 2:4]) + 0.1
    special = [  # rect1, rect2
        ([0, 0, 2, 2, 0.3], [0, 0, 2, 2, 0.3]),          # identical
        ([0, 0, 2, 2, 0.0], [0, 0, 2, 2, 0.0]),
        ([0, 0, 4, 3, 0.2], [0.1, 0.2, 1, 1, 1.1]),      # nested
        ([0.1, 0.2, 1, 1, 1.1], [0, 0, 4, 3, 0.2]),
        ([0, 0, 2, 2, 0.0], [2, 0, 2, 2, 0.0]),          # touching edges
        ([0, 0, 2, 2, 0.0], [2, 2, 2, 2, 0.0]),          # touching corners
        ([0, 0, 2, 2, 0.0], [1.0, 0.5, 1, 3, 0.0]),      # collinear edges
        ([0, 0, 2, 2, 0.0], [9, 9, 2, 2, 0.4]),          # disjoint
        ([0, 0, 1, 1, 0.0], [0.5, 0.5, 1, 1, np.pi / 4]),
    ]
    s1 = np.array([p[0] for p in special] * 4, np.float64)
    s2 = np.array([p[1] for p in special] * 4, np.float64)
    a = np.concatenate([a, s1]).astype(np.float32)
    b = np.concatenate([b, s2]).astype(np.float32)
    c1 = box_ops.bev_corners(_t(a))
    c2 = box_ops.bev_corners(_t(b))
    g = rng.randn(len(a)).astype(np.float32)
    g[::7] = 0.0
    return c1, c2, _t(g)


def _plain_grads(c1, c2, g):
    x1 = c1.clone().requires_grad_()
    x2 = c2.clone().requires_grad_()
    area = iou_ops.rect_intersection_area_plain(x1, x2)
    (area * g).sum().backward()
    return area.detach(), x1.grad, x2.grad


def test_rect_clip_plain_autograd_matches_jax_vjp():
    c1, c2, g = _clip_pairs(np.random.RandomState(4))
    area, g1, g2 = _plain_grads(c1, c2, g)
    ref_area, vjp = jax.vjp(jax_iou._rect_intersection_area_jnp, _j(c1),
                            _j(c2))
    r1, r2 = (np.asarray(r) for r in vjp(_j(g)))
    np.testing.assert_array_equal(area.numpy(), np.asarray(ref_area))
    # |x|' at 0: PyTorch 0, JAX 1 -- only zero-area polygons can differ
    zero = area.numpy() == 0
    for got, ref in ((g1.numpy(), r1), (g2.numpy(), r2)):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[~zero], ref[~zero], rtol=TOL,
                                   atol=TOL * scale)
        assert (got[zero] == 0).all()
    # the comparison is not vacuous: overlapping pairs, zero gradients, and
    # both kinds of zero-area pair (JAX's gradient zero and nonzero)
    assert (~zero).sum() > 400 and (g.numpy() == 0).sum() > 50
    jax_nonzero = np.abs(r1).reshape(len(r1), -1).max(-1) > 0
    assert (zero & ~jax_nonzero).any() and (zero & jax_nonzero).any()


_SLOTS = 8


def _put(out_x, out_y, pos, last, valid, x, y):
    for j in range(min(last, _SLOTS - 1) + 1):
        here = valid & (pos == j)
        out_x[j] = torch.where(here, x, out_x[j])
        out_y[j] = torch.where(here, y, out_y[j])
    return pos + valid.int()


def _take(gx, gy, pos, last, valid):
    x = torch.zeros_like(gx[0])
    y = torch.zeros_like(gy[0])
    for j in range(min(last, _SLOTS - 1) + 1):
        here = valid & (pos == j)
        x = torch.where(here, gx[j], x)
        y = torch.where(here, gy[j], y)
    return pos + valid.int(), x, y


def _edge_s(vx, vy, ax, ay, abx, aby, sign):
    return [(abx * (vy[k] - ay) - aby * (vx[k] - ax)) * sign
            for k in range(_SLOTS)]


def _stage(vx, vy, count, edge):
    """The kernel's ``clip_stage`` on lists of 8 ``(P,)`` slots."""
    ax, ay, abx, aby, sign = edge
    s = _edge_s(vx, vy, ax, ay, abx, aby, sign)
    ox = [torch.zeros_like(vx[0]) for _ in range(_SLOTS)]
    oy = [torch.zeros_like(vx[0]) for _ in range(_SLOTS)]
    pos = torch.zeros_like(count)
    for k in range(_SLOTS):
        nk = (k + 1) % _SLOTS
        active, take_next = k < count, k + 1 < count
        nvx = torch.where(take_next, vx[nk], vx[0])
        nvy = torch.where(take_next, vy[nk], vy[0])
        s_nxt = torch.where(take_next, s[nk], s[0])
        in_cur, in_nxt = s[k] >= 0, s_nxt >= 0
        emit_int = active & (in_cur != in_nxt)
        pos = _put(ox, oy, pos, 2 * k, active & in_cur, vx[k], vy[k])
        denom = s[k] - s_nxt
        t = s[k] / torch.where(denom.abs() > 1e-12, denom, 1.0)
        pos = _put(ox, oy, pos, 2 * k + 1, emit_int,
                   vx[k] + t * (nvx - vx[k]), vy[k] + t * (nvy - vy[k]))
    return ox, oy, pos


def _add_next(a, k, take_next, g):
    nk = (k + 1) % _SLOTS
    a[nk] = a[nk] + torch.where(take_next, g, 0.0)
    a[0] = a[0] + torch.where(take_next, 0.0, g)


def _stage_grad(vx, vy, count, edge, gx, gy):
    """The kernel's ``clip_stage_grad``: the adjoint of the stage's input
    polygon from that of its output, and the edge's adjoints."""
    ax, ay, abx, aby, sign = edge
    s = _edge_s(vx, vy, ax, ay, abx, aby, sign)
    zero = torch.zeros_like(vx[0])
    hx, hy, hs = ([zero] * _SLOTS for _ in range(3))
    pos = torch.zeros_like(count)
    for k in range(_SLOTS):
        nk = (k + 1) % _SLOTS
        active, take_next = k < count, k + 1 < count
        nvx = torch.where(take_next, vx[nk], vx[0])
        nvy = torch.where(take_next, vy[nk], vy[0])
        s_nxt = torch.where(take_next, s[nk], s[0])
        in_cur, in_nxt = s[k] >= 0, s_nxt >= 0
        emit_int = active & (in_cur != in_nxt)
        pos, gcx, gcy = _take(gx, gy, pos, 2 * k, active & in_cur)
        pos, gix, giy = _take(gx, gy, pos, 2 * k + 1, emit_int)
        hx[k] = hx[k] + gcx
        hy[k] = hy[k] + gcy
        denom = s[k] - s_nxt
        big = denom.abs() > 1e-12
        q = torch.where(big, denom, 1.0)
        t = s[k] / q
        gdx = torch.where(emit_int, gix * t, 0.0)
        gdy = torch.where(emit_int, giy * t, 0.0)
        gt = torch.where(emit_int,
                         gix * (nvx - vx[k]) + giy * (nvy - vy[k]), 0.0)
        hx[k] = hx[k] + gix - gdx
        hy[k] = hy[k] + giy - gdy
        _add_next(hx, k, take_next, gdx)
        _add_next(hy, k, take_next, gdy)
        gq = torch.where(big, -(gt * (t / q)), 0.0)
        hs[k] = hs[k] + (gt / q + gq)
        _add_next(hs, k, take_next, -gq)
    grads = [zero] * 4                                  # ax, ay, abx, aby
    out_x, out_y = [], []
    for k in range(_SLOTS):
        gu = hs[k] * sign
        gvy, gvx = gu * abx, gu * aby
        grads[2] = grads[2] + gu * (vy[k] - ay)
        grads[3] = grads[3] - gu * (vx[k] - ax)
        grads[1] = grads[1] - gvy
        grads[0] = grads[0] + gvx
        out_x.append(hx[k] - gvx)
        out_y.append(hy[k] + gvy)
    return out_x, out_y, grads


def _clip_grad_emulated(c1, c2, g):
    """Kernel B2's backward sweep (``pair_grad`` of
    ``rect_clip_grad_sweep_kernel``) in plain PyTorch, over every pair, the
    same operations in the same order: the forward clip keeping each
    edge's input polygon, the shoelace's adjoint, then each edge's adjoint
    from the last to the first."""
    px, py = list(c1[:, :, 0].unbind(1)), list(c1[:, :, 1].unbind(1))
    bx, by = list(c2[:, :, 0].unbind(1)), list(c2[:, :, 1].unbind(1))
    cx2 = (((bx[0] + bx[1]) + bx[2]) + bx[3]) * 0.25
    cy2 = (((by[0] + by[1]) + by[2]) + by[3]) * 0.25
    edges = []
    for e in range(4):
        abx, aby = bx[(e + 1) % 4] - bx[e], by[(e + 1) % 4] - by[e]
        ref = abx * (cy2 - by[e]) - aby * (cx2 - bx[e])
        edges.append((bx[e], by[e], abx, aby,
                      torch.where(ref >= 0, 1.0, -1.0)))
    zero = torch.zeros_like(px[0])
    vx, vy = px + [zero] * 4, py + [zero] * 4
    count = torch.full(px[0].shape, 4, dtype=torch.int32)
    kept = []
    for edge in edges:
        kept.append((vx, vy, count))
        vx, vy, count = _stage(vx, vy, count, edge)
    # shoelace: area = 0.5 |sum| where count > 2, |x|' = sign(x), 0 at 0
    cx = [torch.where(k < count, vx[k], vx[0]) for k in range(_SLOTS)]
    cy = [torch.where(k < count, vy[k], vy[0]) for k in range(_SLOTS)]
    total = zero
    for k in range(_SLOTS):
        nk = (k + 1) % _SLOTS
        total = total + (cx[k] * cy[nk] - cy[k] * cx[nk])
    gs = torch.where(count > 2, g * 0.5 * torch.sign(total), 0.0)
    hx, hy = [zero] * _SLOTS, [zero] * _SLOTS
    for k in range(_SLOTS):
        nk = (k + 1) % _SLOTS
        hx[k] = hx[k] + gs * cy[nk]
        hy[nk] = hy[nk] + gs * cx[k]
        hy[k] = hy[k] - gs * cx[nk]
        hx[nk] = hx[nk] - gs * cy[k]
    gx, gy = [zero] * _SLOTS, [zero] * _SLOTS
    for k in range(_SLOTS):
        active = k < count
        gx[k] = gx[k] + torch.where(active, hx[k], 0.0)
        gy[k] = gy[k] + torch.where(active, hy[k], 0.0)
        gx[0] = gx[0] + torch.where(active, 0.0, hx[k])
        gy[0] = gy[0] + torch.where(active, 0.0, hy[k])
    gbx, gby = [zero] * 4, [zero] * 4
    for e in range(3, -1, -1):
        vx, vy, count = kept[e]
        gx, gy, (gax, gay, gabx, gaby) = _stage_grad(vx, vy, count,
                                                     edges[e], gx, gy)
        ne = (e + 1) % 4
        gbx[e] = gbx[e] + gax - gabx
        gby[e] = gby[e] + gay - gaby
        gbx[ne] = gbx[ne] + gabx
        gby[ne] = gby[ne] + gaby
    g1 = torch.stack([torch.stack(gx[:4], 1), torch.stack(gy[:4], 1)], -1)
    g2 = torch.stack([torch.stack(gbx, 1), torch.stack(gby, 1)], -1)
    return g1, g2


def _clip_grad_compacted(c1, c2, g, rng):
    """The kernel's two passes in plain PyTorch: zeros for every pair, then
    :func:`_clip_grad_emulated` over the pairs whose area gradient is not 0
    (NaN included) alone, taken in a shuffled order as the zero pass's
    atomics hand them out, and scattered back."""
    g1, g2 = torch.zeros_like(c1), torch.zeros_like(c2)
    live = torch.nonzero(g != 0).squeeze(1)
    live = live[torch.from_numpy(rng.permutation(len(live)))]
    g1[live], g2[live] = _clip_grad_emulated(c1[live], c2[live], g[live])
    return g1, g2


def zero_pairs(grad):
    """Pairs whose ``(4, 2)`` gradient is exactly zero."""
    return (grad.reshape(grad.shape[0], -1) == 0).all(1)


@pytest.mark.parametrize('with_nan', [False, True], ids=['finite', 'nan'])
def test_rect_clip_grad_compacted_sweep_bit_identical_to_full_sweep(with_nan):
    """The sweep over the compacted live list, in any order, gives the bits
    of the sweep over every pair; the dead pairs are exactly zero, and a NaN
    area gradient counts as live."""
    c1, c2, g = _clip_pairs(np.random.RandomState(5))
    if with_nan:
        g[3::50] = float('nan')
    full1, full2 = _clip_grad_emulated(c1, c2, g)
    got1, got2 = _clip_grad_compacted(c1, c2, g, np.random.RandomState(6))
    dead = g == 0
    for got, full in ((got1, full1), (got2, full2)):
        assert torch.equal(got.view(torch.int32), full.view(torch.int32))
        assert (got[dead].view(torch.int32) == 0).all()
    assert dead.sum() > 50 and (~dead).sum() > 500
    if with_nan:
        assert got1[g.isnan()].isnan().any()


def test_rect_clip_grad_algorithm_matches_plain_autograd():
    """The kernel's reverse sweep, emulated, against autograd of the plain
    clip: within 1e-5 of the max-abs gradient, and exactly zero for the
    pairs whose autograd gradient is exactly zero (a zero area gradient,
    two vertices or fewer, a zero area).  A single entry may come out 0 in
    one order of the sums and a few ulps in the other (cancellation); those
    are held to 1e-6 of the max-abs gradient."""
    c1, c2, g = _clip_pairs(np.random.RandomState(5))
    _, r1, r2 = _plain_grads(c1, c2, g)
    g1, g2 = _clip_grad_emulated(c1, c2, g)
    for got, ref in ((g1, r1), (g2, r2)):
        scale = ref.abs().max().item()
        torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL * scale)
        assert torch.equal(zero_pairs(got), zero_pairs(ref))
        flips = (got == 0) != (ref == 0)
        assert ((got - ref)[flips].abs() <= 1e-6 * scale).all()
        assert flips.sum() <= 4
    dead = zero_pairs(r1) & zero_pairs(r2)
    assert dead.sum() > len(g) // 7 and (~dead).sum() > 400


# --------------------------------------------------------------------------
# target assignment
# --------------------------------------------------------------------------

KINDS = ('v1', 'v1_topk', 'v2')
TARGETS_SEED = 3           # GT whose geometric margins hold (asserted)
SLICE_SEED = 26            # the slice batch; its margins are asserted too
GEOM_MARGIN = 1e-5         # metres: 10x the float32 noise of a distance


def _cfgs(kind):
    """Both packages' tiny indoor configs; ``v1_topk`` is v1 with the
    ``_top27`` presets' rule (``centerness_topk`` set)."""
    jcfg, cfg = tiny_indoor_cfgs(fast=kind == 'v2')
    if kind == 'v1_topk':
        jcfg, cfg = (dataclasses.replace(c, indoor_head=dataclasses.replace(
            c.indoor_head, centerness_topk=TOPK_V1)) for c in (jcfg, cfg))
    return jcfg, cfg


def _level_inputs(cfg, origins):
    hc = cfg.indoor_head
    sizes = [tuple(n // 2 ** i for n in cfg.n_voxels)
             for i in range(hc.n_scales)]
    points = torch.cat(ivh.mlvl_points(sizes, hc.voxel_size, origins), 1)
    scales, rr = ivh._level_constants([a * b * c for a, b, c in sizes],
                                      hc.regress_ranges, 'cpu')
    return points, scales, rr


def _targets_gt(seed):
    """Padded GT of 3 rooms at the tiny grid: two furnished, one empty."""
    boxes, labels, mask = synthetic.furniture_boxes(
        np.random.RandomState(seed), 3, MAX_GT, n_classes=3)
    boxes[2], mask[2] = 0.0, False
    return boxes, labels, mask


def _margins(points, boxes, mask, cfg):
    """float64: the smallest distance of a point from a face of a box, of
    an inside point's largest face distance from a regress-range edge, and
    of a candidate's centerness from its box's k-th value (the values the
    port compares in float32)."""
    hc = cfg.indoor_head
    p = np.asarray(points, np.float64)
    bx = np.asarray(boxes, np.float64)[mask]
    center = bx[:, :3] + np.c_[np.zeros((len(bx), 2)), bx[:, 5] / 2]
    off = p[:, None] - center[None]
    c, s = np.cos(-bx[:, 6]), np.sin(-bx[:, 6])
    off = np.stack([off[..., 0] * c + off[..., 1] * s,
                    off[..., 1] * c - off[..., 0] * s, off[..., 2]], -1)
    half = bx[None, :, 3:6] / 2
    dist = np.concatenate([off + half, half - off], -1)[..., [0, 3, 1, 4,
                                                              2, 5]]
    face = np.abs(dist).min()
    inside = dist.min(-1) > 0
    levels = np.concatenate([np.full(np.prod(sz), i) for i, sz in enumerate(
        [tuple(n // 2 ** i for n in cfg.n_voxels)
         for i in range(hc.n_scales)])])
    edges = np.array([e for r in hc.regress_ranges for e in r])
    rng_gap = np.abs(dist.max(-1)[inside][:, None] - edges[None]).min()
    topk = np.inf
    if hc.centerness_topk > 0:
        d = dist.reshape(-1, 6)
        cness = np.sqrt(np.clip(np.prod(
            [np.minimum(d[:, 2 * i], d[:, 2 * i + 1])
             / np.maximum(np.maximum(d[:, 2 * i], d[:, 2 * i + 1]), 1e-12)
             for i in range(3)], 0), 0, None)).reshape(dist.shape[:2])
        k = hc.centerness_topk + (hc.version == 2)
        if hc.version == 1:
            cond = inside & (dist.max(-1) >= edges[2 * levels][:, None]) & (
                dist.max(-1) <= edges[2 * levels + 1][:, None])
        else:
            n_in = np.stack([inside[levels == i].sum(0)
                             for i in range(hc.n_scales)])
            under = n_in < hc.limit
            best = np.where(under.any(0), np.maximum(under.argmax(0) - 1, 0),
                            hc.n_scales - 1)
            cond = inside & (levels[:, None] == best[None])
        for g in range(len(bx)):
            vals = np.sort(np.where(cond[:, g], cness[:, g], -1.0))[::-1]
            kth = vals[min(k, len(vals)) - 1]
            if kth >= 0:
                rest = np.delete(vals, min(k, len(vals)) - 1)
                topk = min(topk, np.abs(rest - kth).min())
    return face, rng_gap, topk


@pytest.mark.parametrize('which', ['targets', 'slice'])
@pytest.mark.parametrize('kind', KINDS)
def test_fixture_keeps_its_margins(kind, which):
    """No point lies within 1e-5 m of a box face, no inside point's largest
    face distance within 1e-5 of a regress-range edge, and no candidate's
    centerness within 1e-5 of its box's k-th value, so that float rounding
    cannot flip an inside test, a range or a top-k membership: in the GT of
    the targets tests and in that of the slice test.  The slice batch's
    pixel rounding keeps its margin too."""
    _, cfg = _cfgs(kind)
    if which == 'targets':
        boxes, _, mask = _targets_gt(TARGETS_SEED)
        origins = torch.tensor([synthetic.SUNRGBD_ORIGIN] * 3)
    else:
        batch_np = _slice_batch_np()
        boxes, mask = batch_np['gt_boxes'], batch_np['gt_mask']
        origins = torch.from_numpy(batch_np['origins'])
        assert projection_margin(cfg.n_voxels, cfg.voxel_size,
                                 batch_np) > PIXEL_MARGIN
    points, _, _ = _level_inputs(cfg, origins)
    for s in range(boxes.shape[0]):
        if mask[s].any():
            assert min(_margins(points[s], boxes[s], mask[s], cfg)) \
                > GEOM_MARGIN, s


def _jax_targets(points, scales, rr, boxes, labels, mask, hc):
    fn = jax.vmap(lambda p, b, l, m: jax_ivh.indoor_targets(
        p, _j(scales), _j(rr), b, l, m, hc))
    return [np.asarray(x) for x in fn(_j(points), _j(boxes), _j(labels),
                                      _j(mask))]


@pytest.mark.parametrize('kind', KINDS)
def test_indoor_targets_match_jax(kind):
    """Labels exact, centerness and box targets within 1e-5, for padded GT
    and a room with no GT, v1, v1 top-k and v2."""
    jcfg, cfg = _cfgs(kind)
    boxes, labels, mask = _targets_gt(TARGETS_SEED)
    origins = torch.tensor([synthetic.SUNRGBD_ORIGIN] * 3)
    points, scales, rr = _level_inputs(cfg, origins)
    got = ivh.indoor_targets(points, scales, rr, _t(boxes), _t(labels),
                             _t(mask), cfg.indoor_head)
    ref = _jax_targets(points, scales, rr, boxes, labels, mask,
                       jcfg.indoor_head)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL)
    lab = got[2].numpy()
    # positives on more than one level in the furnished rooms, none in the
    # empty one
    level = scales.numpy()
    for s in (0, 1):
        assert len(np.unique(level[lab[s] >= 0])) >= 2, s
    assert (lab[2] == -1).all()
    if cfg.indoor_head.centerness_topk > 0:
        # at most k positives a box
        for s in (0, 1):
            assert np.bincount(lab[s][lab[s] >= 0]).max() <= \
                TOPK_V1 * mask[s].sum()


def test_indoor_targets_take_the_first_minimum():
    """A point inside no box, and every point of a room whose GT is all
    padding, see volume INF everywhere and take box 0's targets, as
    ``jnp.argmin`` gives them; of two boxes of one volume that hold a
    point, the first wins."""
    _, cfg = _cfgs('v1')
    jcfg, _ = _cfgs('v1')
    boxes = np.zeros((2, 4, 7), np.float32)
    boxes[0, 0] = (-2.0, 2.0, -2.0, 0.5, 0.5, 0.5, 0.3)   # far from 1, 2
    boxes[0, 1] = (0.11, 3.03, -1.63, 1.21, 1.23, 1.19, 0.0)
    boxes[0, 2] = (0.11, 3.03, -1.63, 1.21, 1.23, 1.19, 0.0)   # same box
    labels = np.array([[0, 1, 2, 0], [0, 0, 0, 0]], np.int32)
    mask = np.array([[True, True, True, False], [False] * 4])
    origins = torch.tensor([synthetic.SUNRGBD_ORIGIN] * 2)
    points, scales, rr = _level_inputs(cfg, origins)
    ct, bt, lab = ivh.indoor_targets(points, scales, rr, _t(boxes),
                                     _t(labels), _t(mask), cfg.indoor_head)
    ref = _jax_targets(points, scales, rr, boxes, labels, mask,
                       jcfg.indoor_head)
    np.testing.assert_array_equal(lab.numpy(), ref[2])
    np.testing.assert_allclose(bt.numpy(), ref[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ct.numpy(), ref[0], rtol=TOL, atol=TOL)
    lab = lab.numpy()
    assert (lab[0] == 1).any() and not (lab[0] == 2).any()
    assert (lab[1] == -1).all()
    gc0 = box_ops.gravity_center(_t(boxes[:, 0]))
    outside = lab == -1
    np.testing.assert_array_equal(
        bt.numpy()[outside][:, :3],
        np.broadcast_to(gc0.numpy()[:, None], (2, lab.shape[1], 3))[outside])


# --------------------------------------------------------------------------
# the head loss and the slice
# --------------------------------------------------------------------------

def _slice_batch_np(b=2):
    batch = synthetic.sunrgbd_train_batch(b, 'cpu', seed=SLICE_SEED,
                                          size=(128, 96), max_gt=MAX_GT,
                                          n_classes=3)
    return {k: v.numpy() for k, v in batch.items()}


def _head_outs(rng, b, cfg):
    """Random head maps of the tiny levels: boxes of about 2 m."""
    sizes = [tuple(n // 2 ** i for n in cfg.n_voxels) for i in range(3)]
    c = cfg.indoor_head.n_classes
    cen = [rng.randn(b, *s, 1).astype(np.float32) for s in sizes]
    box = [np.concatenate([np.exp(0.3 * rng.randn(b, *s, 6)),
                           rng.uniform(-np.pi, np.pi, (b, *s, 1))],
                          -1).astype(np.float32) for s in sizes]
    cls = [rng.randn(b, *s, c).astype(np.float32) - 2.0 for s in sizes]
    return cen, box, cls


@pytest.mark.parametrize('kind', KINDS)
def test_indoor_head_loss_matches_jax(kind):
    jcfg, cfg = _cfgs(kind)
    batch_np = _slice_batch_np()
    rng = np.random.RandomState(7)
    heads = _head_outs(rng, 2, cfg)
    valid = rng.uniform(size=(2, *cfg.n_voxels)) > 0.3
    args = (valid, batch_np['origins'], batch_np['gt_boxes'],
            batch_np['gt_labels'], batch_np['gt_mask'])
    ref = jax_ivh.indoor_head_loss(
        tuple([_j(x) for x in lv] for lv in heads), *map(_j, args),
        jcfg.indoor_head)
    got = ivh.indoor_head_loss(tuple([_t(x) for x in lv] for lv in heads),
                               *map(_t, args), cfg.indoor_head)
    assert set(got) == set(ref) == {'loss_centerness', 'loss_bbox',
                                    'loss_cls'}
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=key)
        assert float(got[key]) > 0, key


def test_dp_loss_norm_batch_mean_is_named_as_not_ported():
    """``per_image`` stays the default; ``batch_mean`` (ported since the
    data-parallel slice: each image normalized by the batch's mean positive
    count) reaches the head loss through ``imvoxelnet_loss``, and another
    value raises.  ``test_torch_port_distributed.py`` holds ``batch_mean``
    to the JAX loss, over one and two ranks."""
    _, cfg = _cfgs('v1')
    assert cfg.dp_loss_norm == 'per_image'
    batch = {k: _t(v) for k, v in _slice_batch_np().items()}
    rng = np.random.RandomState(7)
    heads = tuple([_t(x) for x in lv] for lv in _head_outs(rng, 2, cfg))
    valid = _t(rng.uniform(size=(2, *cfg.n_voxels)) > 0.3)
    mean_cfg = dataclasses.replace(cfg, dp_loss_norm='batch_mean')
    got = detector.imvoxelnet_loss(mean_cfg, heads, batch, valid)
    ref = ivh.indoor_head_loss(heads, valid, batch['origins'],
                               batch['gt_boxes'], batch['gt_labels'],
                               batch['gt_mask'], cfg.indoor_head,
                               batch_mean=True)
    assert set(got) == set(ref)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    with pytest.raises(ValueError, match='dp_loss_norm'):
        detector.imvoxelnet_loss(
            dataclasses.replace(cfg, dp_loss_norm='per_rank'), heads, batch,
            valid)


SLICE_LR_MULT = 0.1
SPE, LR_STEPS = 1, (1, 2)             # both LR boundaries inside 3 steps


def _as_port(tree, variables, cfg):
    return from_jax_variables(
        {'params': jax.tree_util.tree_map(np.array, tree),
         'batch_stats': variables['batch_stats']}, cfg)


@pytest.fixture(scope='module', params=KINDS)
def slice_run(request):
    """3 training steps of both packages from the same weights and batch,
    and the first step's gradients."""
    from imvoxelnet_tpu.configs import presets as jax_presets

    jcfg, cfg = _cfgs(request.param)
    preset = jax_presets.get_preset('imvoxelnet_sunrgbd')
    batch_np = _slice_batch_np()
    variables = jax_variables(jcfg, batch_np, seed=9)
    variables['params']['bbox_head']['reg_conv']['kernel'] *= 0.1
    lr = preset.lr * SLICE_LR_MULT
    opt_args = (lr, preset.weight_decay, preset.backbone_lr_mult,
                preset.grad_clip_norm)

    model = jax_det.ImVoxelNet(jcfg)
    tx = jax_train.make_optimizer(*opt_args, steps_per_epoch=SPE,
                                  lr_steps=LR_STEPS)
    train_step = jax_train.make_train_step(model, tx)

    def total_loss(params, stats, batch):
        outs, _ = model.apply({'params': params, 'batch_stats': stats},
                              batch, train=True, mutable=['batch_stats'])
        return sum(jax_det.imvoxelnet_loss(jcfg, *outs, batch).values())

    @jax.jit
    def step_and_grads(state, batch):
        grads = jax.grad(total_loss)(state.params, state.batch_stats, batch)
        return train_step(state, batch) + (grads,)

    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=tx.init(params))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jax_losses_, jax_grads = [], None
    for _ in range(STEPS):
        state, metrics, grads = step_and_grads(state, batch)
        jax_losses_.append({k: float(v) for k, v in metrics.items()})
        jax_grads = grads if jax_grads is None else jax_grads
    jax_after = from_jax_variables(
        {'params': jax.tree_util.tree_map(np.array, state.params),
         'batch_stats': jax.tree_util.tree_map(np.array,
                                               state.batch_stats)}, cfg)

    tmodel = port_model(cfg, variables)
    opt, sched = train.make_optimizer(tmodel, *opt_args, steps_per_epoch=SPE,
                                      lr_steps=LR_STEPS)
    step = train.make_train_step(tmodel, opt, sched)
    tbatch = to_torch(batch_np)
    probe = port_model(cfg, variables).train()
    for name, p in probe.named_parameters():
        p.requires_grad_(train.param_label(name) != 'frozen')
    head_outs, valid = probe(tbatch)
    sum(detector.imvoxelnet_loss(cfg, head_outs, tbatch,
                                 valid).values()).backward()
    port_grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in probe.named_parameters() if p.requires_grad}
    port_losses = [{k: float(v) for k, v in step(tbatch).items()}
                   for _ in range(STEPS)]
    return dict(cfg=cfg, variables=variables, jax_losses=jax_losses_,
                port_losses=port_losses,
                jax_grads=_as_port(jax_grads, variables, cfg),
                port_grads=port_grads, jax_after=jax_after,
                port_after=tmodel.state_dict(), lr=lr)


def test_slice_losses_match_jax_every_step(slice_run):
    jl, pl = slice_run['jax_losses'], slice_run['port_losses']
    assert len(jl) == len(pl) == STEPS
    for i, (j, p) in enumerate(zip(jl, pl)):
        assert set(j) == set(p) == {'loss_centerness', 'loss_bbox',
                                    'loss_cls', 'loss'}
        for key in j:
            np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL,
                                       err_msg=f'step {i} {key}')
    assert pl[0]['loss_bbox'] > 0 and pl[-1]['loss'] < pl[0]['loss']


def biases_before_bn(model):
    """The biases of the convs that feed a batch-statistics BN directly:
    their true gradient is 0, and both packages give float noise."""
    out = set()
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.named_children())
            for (i, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(b, torch.nn.BatchNorm3d) and getattr(
                        a, 'bias', None) is not None:
                    out.add(f'{name}.{i}.bias')
    return out


def test_slice_first_step_gradients_match_jax(slice_run):
    jg, pg = slice_run['jax_grads'], slice_run['port_grads']
    noise = biases_before_bn(port_model(slice_run['cfg'],
                                        slice_run['variables']))
    nonzero = set()
    for name, got in pg.items():
        want = jg[name].numpy()
        if name in noise:
            scale = np.abs(jg[name.replace('bias', 'weight')].numpy()).max()
            assert np.abs(want).max() < 1e-4 * scale, name
            assert got.abs().max() < 1e-4 * scale, name
            continue
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)
        if scale > 0:
            nonzero.add(name)
    # the gradient reaches the backbone, the FPN, the 3D neck and every
    # prediction conv (the box regression through the clip)
    for name in ('backbone.layer2.0.conv1.weight',
                 'neck.lateral_convs.0.conv.weight',
                 'bbox_head.centerness_conv.weight',
                 'bbox_head.reg_conv.weight', 'bbox_head.cls_conv.weight'):
        assert name in nonzero, name
    assert any(n.startswith('neck_3d.') for n in nonzero)


def test_slice_bn_stats_match_jax_after_the_steps(slice_run):
    ja, pa = slice_run['jax_after'], slice_run['port_after']
    keys = [k for k in pa if k.startswith('neck_3d.')
            and k.endswith(('running_mean', 'running_var'))]
    assert keys
    before = from_jax_variables(slice_run['variables'], slice_run['cfg'])
    for key in keys:
        np.testing.assert_allclose(pa[key].numpy(), ja[key].numpy(),
                                   rtol=STATS_TOL, atol=STATS_TOL,
                                   err_msg=key)
        assert not torch.equal(pa[key], before[key])


def test_slice_params_match_jax_after_the_steps(slice_run):
    ja, pa, lr = slice_run['jax_after'], slice_run['port_after'], \
        slice_run['lr']
    atol = 2 * lr * sum(0.1 ** i for i in range(STEPS))
    for key, got in pa.items():
        if key.endswith(('weight', 'bias')):
            np.testing.assert_allclose(got.numpy(), ja[key].numpy(), rtol=0,
                                       atol=atol, err_msg=key)
