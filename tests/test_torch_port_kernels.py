"""The plain versions of the port's three kernels against the JAX package.

Each CUDA kernel is held against its plain PyTorch version on the card
(``chip_smoke.py``, ``tests/test_torch_port_cuda.py``); here on the CPU the
plain versions are held against the JAX functions the kernels replace: the
production XLA path and the Pallas kernel in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from imvoxelnet_tpu.ops import backproject as jax_bp
from imvoxelnet_tpu.ops import backproject_pallas as jax_bpp
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops.conv3z_pallas import conv3z_lanepack
from imvoxelnet_tpu.ops.iou_pallas import rect_intersection_area_pallas

from imvoxelnet_tpu_torch import kernels
from imvoxelnet_tpu_torch.kernels import backproject as bp_kernel
from imvoxelnet_tpu_torch.kernels import conv3x3x3 as conv_kernel
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.models import necks3d
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.ops import iou as iou_ops


# --------------------------------------------------------------------------
# B1: backprojection
# --------------------------------------------------------------------------

def _bp_setup(b=2, v=3, hf=12, wf=16, c=8, seed=0):
    """Per-view cameras looking down +z at a grid ~2 m away; the off-grid
    origin keeps every projected coordinate off the round-half boundary."""
    rng = np.random.RandomState(seed)
    features = rng.randn(b, v, hf, wf, c).astype(np.float32)
    k = np.array([[20.0, 0, wf / 2 + 0.0371], [0, 20.0, hf / 2 - 0.0293],
                  [0, 0, 1]], np.float32)
    proj = np.zeros((b, v, 3, 4), np.float32)
    for s in range(b):
        for i in range(v):
            e = np.eye(4, dtype=np.float32)[:3]
            e[0, 3] = 0.2 * i + 0.05 * s
            proj[s, i] = k @ e
    origins = np.array([[0.0137, -0.0213, 2.0071]] * b, np.float32)
    points = np.asarray(bp.get_points(
        (6, 6, 4), (0.3, 0.3, 0.3), torch.from_numpy(origins))).reshape(
            b, -1, 3)
    # margin of the float64 projection from a .5 pixel boundary
    uvw = np.einsum('bvij,bpj->bvpi', proj.astype(np.float64),
                    np.concatenate([points, np.ones_like(points[..., :1])],
                                   -1).astype(np.float64))
    uv = uvw[..., :2] / uvw[..., 2:]
    assert np.abs(uv - np.floor(uv) - 0.5).min() > 1e-4
    return features, points, proj


@pytest.mark.parametrize('valid_hw', [None, (8, 10)], ids=['full', 'valid_hw'])
def test_backproject_plain_matches_jax_backproject_batch(valid_hw):
    features, points, proj = _bp_setup()
    b, _, hf, wf, _ = features.shape
    hw = np.array([valid_hw or (hf, wf)] * b, np.int32)
    ref_acc, ref_cnt = jax_bp.backproject_batch(
        jnp.asarray(features), jnp.asarray(points), jnp.asarray(proj),
        jnp.asarray(hw))
    acc, cnt = bp.backproject_batch_plain(
        torch.from_numpy(features), torch.from_numpy(points),
        torch.from_numpy(proj), torch.from_numpy(hw))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    assert 0 < (cnt.numpy() > 0).mean() < 1
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), atol=1e-6)
    # and the dispatcher takes the plain version for CPU tensors
    acc2, cnt2 = bp.backproject_batch(
        torch.from_numpy(features), torch.from_numpy(points),
        torch.from_numpy(proj), torch.from_numpy(hw))
    assert torch.equal(acc2, acc) and torch.equal(cnt2, cnt)


@pytest.mark.parametrize('v,valid_hw', [(3, None), (1, (8, 8))],
                         ids=['3views', 'valid_hw'])
def test_backproject_plain_bf16_matches_pallas_interpret(v, valid_hw):
    """The Pallas kernel works in bfloat16; so does the port here."""
    features, points, proj = _bp_setup(b=1, v=v)
    hf, wf = features.shape[2:4]
    hw = np.array([valid_hw or (hf, wf)], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref_vol, ref_seen = jax_bpp.backproject_pallas(
            jnp.asarray(features[0]), jnp.asarray(points[0]),
            jnp.asarray(proj[0]), valid_hw=jnp.asarray(hw[0]))
    acc, cnt = bp.backproject_batch_plain(
        torch.from_numpy(features).to(torch.bfloat16),
        torch.from_numpy(points), torch.from_numpy(proj),
        torch.from_numpy(hw))
    vol, seen = bp.mean_pool_from_sums(acc.float(), cnt.float())
    np.testing.assert_array_equal(seen[:, 0].numpy(), np.asarray(ref_seen))
    np.testing.assert_allclose(vol[:, 0].numpy(), np.asarray(ref_vol),
                               atol=2e-2)


def _clustered_grad_setup(b, v, c, dtype, seed=0):
    """Inputs of B1's backward: ``_bp_setup``'s scene with a cluster of 40
    copies of one voxel center spread over the voxel list (so that one
    pixel of every view that sees it is read by 40+ voxels, more than one
    lane group's worth), a valid extent that crops the 12x16 map (pixels no
    voxel reads), and a gradient in ``dtype``."""
    _, points, proj = _bp_setup(b=b, v=v, seed=seed)
    hw = np.array([(9, 13)] * b, np.int32)
    _, valid = bp._view_indices(torch.from_numpy(points),
                                torch.from_numpy(proj), torch.from_numpy(hw),
                                12, 16)
    hot = int(valid.sum((0, 1)).argmax())        # the voxel most views see
    n = points.shape[1]
    at = np.linspace(0, n, 40, endpoint=False).astype(np.int64)
    points = np.insert(points, at, points[:, hot:hot + 1], axis=1)
    p = points.shape[1]
    g = np.random.RandomState(seed + 1).randn(p, b, c).astype(np.float32)
    return (torch.from_numpy(g).to(dtype), torch.from_numpy(points),
            torch.from_numpy(proj), torch.from_numpy(hw), 12, 16)


def _pixel_major_gather(grad_acc, points, proj, hw, hf, wf, rng):
    """The backward kernel's algorithm (``csrc/backproject.cu``, passes 1-4)
    in plain PyTorch: count the voxels of every (b, v, pixel) and hand out
    slots in an arbitrary order, as the kernel's atomics do; scan the counts
    into segment offsets; fill each segment; order each segment by rank (the
    number of smaller entries); add each pixel's gradient rows in that order
    in float32 from zero and round once."""
    p, b, c = grad_acc.shape
    v = proj.shape[1]
    idx, valid = bp._view_indices(points, proj, hw, hf, wf)   # (B, V, P)
    k = b * v * hf * wf
    key = torch.arange(b * v).view(b, v, 1) * (hf * wf) + idx
    voxel = torch.arange(p).expand(b, v, p)
    sample = torch.arange(b).view(b, 1, 1).expand(b, v, p)
    key, voxel, sample = key[valid], voxel[valid], sample[valid]
    # 1. counts, and slots in order of arrival
    counts = torch.bincount(key, minlength=k)
    arrival = torch.from_numpy(rng.permutation(len(key)))
    slot = torch.empty_like(key)
    seen = torch.zeros(k, dtype=torch.int64)
    for i in arrival.tolist():
        slot[i] = seen[key[i]]
        seen[key[i]] += 1
    # 2. exclusive scan of the K + 1 counts
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(counts, 0)])
    # 3. fill
    entries = torch.empty(len(key), dtype=torch.int64)
    entries[offsets[key] + slot] = voxel
    # 4. order each segment by rank, then sum in that order
    ordered = torch.empty_like(entries)
    for kk in torch.nonzero(counts).flatten().tolist():
        seg = entries[offsets[kk]:offsets[kk + 1]]
        rank = (seg[None, :] < seg[:, None]).sum(1)
        ordered[offsets[kk] + rank] = seg
    g = grad_acc.float()
    seg_sample = torch.arange(k) // (v * hf * wf)
    out = torch.zeros((k, c), dtype=torch.float32)
    for j in range(int(counts.max())):
        rows = torch.nonzero(counts > j).flatten()
        out[rows] = out[rows] + g[ordered[offsets[rows] + j],
                                  seg_sample[rows]]
    return out.reshape(b, v, hf, wf, c).to(grad_acc.dtype), counts


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('c', [4, 130])
@pytest.mark.parametrize('v', [1, 3])
@pytest.mark.parametrize('b', [1, 2])
def test_backproject_grad_algorithm_bit_identical_to_plain(b, v, c, dtype):
    """B1's backward as the kernel computes it (segments filled in an
    arbitrary order, then ordered by voxel and summed in that order) equals
    ``backproject_batch_grad_plain`` (``index_add_``) bit for bit: both add
    each pixel's rows in ascending voxel order in float32 from zero."""
    grad_acc, points, proj, hw, hf, wf = _clustered_grad_setup(b, v, c, dtype)
    got, counts = _pixel_major_gather(grad_acc, points, proj, hw, hf, wf,
                                      np.random.RandomState(7))
    ref = bp.backproject_batch_grad_plain(grad_acc, points, proj, hw, hf, wf)
    assert _same_bits(got, ref)
    # the cases the kernel must handle: a segment longer than a warp, pixels
    # no voxel reads (the crop), rows that sum several voxels in float32
    assert counts.max() >= 40 and (counts == 0).any()
    assert (counts > 1).sum() >= 5
    # the order matters: the same rows in descending voxel order differ
    if dtype == torch.float32 and c == 130:
        rev = _pixel_major_gather(grad_acc.flip(0), points.flip(1), proj, hw,
                                  hf, wf, np.random.RandomState(7))[0]
        assert not _same_bits(rev, ref)


def test_backproject_bf16_view_sums_against_jax_at_20_views():
    """bfloat16 features summed over 20 views (ScanNet's training views).
    The port adds in float32 and rounds once; the JAX package carries the
    sum in bfloat16 (``ops/backproject.py:205``), rounding after every view.
    Their difference is held to the first-order bound of those roundings,
    ``2^-8 * (|S_1| + ... + |S_20| + |S|)`` for partial sums ``S_k`` (unit
    roundoff 2^-8), and the port is the nearer of the two to the float64
    sum of the same bfloat16 values."""
    rng = np.random.RandomState(11)
    b, v, hf, wf, c = 1, 20, 12, 16, 32
    k = np.array([[20.0, 0, wf / 2 + 0.0371], [0, 20.0, hf / 2 - 0.0293],
                  [0, 0, 1]], np.float32)
    proj = np.zeros((b, v, 3, 4), np.float32)
    for i in range(v):
        e = np.eye(4, dtype=np.float32)[:3]
        e[:2, 3] = rng.uniform(-0.05, 0.05, 2)
        proj[0, i] = k @ e
    origins = torch.tensor([[0.0137, -0.0213, 2.0071]])
    points = bp.get_points((6, 6, 4), (0.3, 0.3, 0.3), origins).reshape(
        b, -1, 3)
    hw = torch.tensor([(hf, wf)], dtype=torch.int32)
    feats = torch.from_numpy(rng.randn(b, v, hf, wf, c).astype(np.float32)
                             ).to(torch.bfloat16)
    proj = torch.from_numpy(proj)
    acc, cnt = bp.backproject_batch_plain(feats, points, proj, hw)
    ref_acc, ref_cnt = jax_bp.backproject_batch(
        jnp.asarray(feats.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(points.numpy()), jnp.asarray(proj.numpy()),
        jnp.asarray(hw.numpy()))
    ref_acc = torch.from_numpy(np.array(ref_acc.astype(jnp.float32)))
    np.testing.assert_array_equal(cnt.float().numpy(),
                                  np.asarray(ref_cnt.astype(jnp.float32)))
    assert float(cnt.float().mean()) > 10          # most views see a voxel
    # float64 partial sums of the same bfloat16 values, view by view
    idx, valid = bp._view_indices(points, proj, hw, hf, wf)
    table = feats.double().reshape(b, v, hf * wf, c)
    partial = torch.zeros((b, points.shape[1], c), dtype=torch.float64)
    partial_abs = torch.zeros_like(partial)
    for i in range(v):
        row = table[:, i][torch.arange(b)[:, None], idx[:, i]]
        partial = partial + torch.where(valid[:, i, :, None], row,
                                        torch.zeros(()))
        partial_abs = partial_abs + partial.abs()
    exact = partial.transpose(0, 1)
    limit = 2.0 ** -8 * (partial_abs + partial.abs()).transpose(0, 1)
    dev = (acc.double() - ref_acc.double()).abs()
    assert (dev <= limit * 1.001 + 1e-30).all()
    assert dev.max() > 0                           # the two do differ
    port_err = (acc.double() - exact).abs()
    jax_err = (ref_acc.double() - exact).abs()
    assert port_err.mean() < jax_err.mean() / 2
    assert port_err.max() <= jax_err.max()


def test_project_points_matches_jax():
    features, points, proj = _bp_setup(b=1, v=2)
    for i in range(2):
        jx, jy, jz = jax_bp.project_points(jnp.asarray(points[0]),
                                           jnp.asarray(proj[0, i]))
        x, y, z = bp.project_points(torch.from_numpy(points[0]),
                                    torch.from_numpy(proj[0, i]))
        np.testing.assert_array_equal(x.numpy().astype(np.int32),
                                      np.asarray(jx))
        np.testing.assert_array_equal(y.numpy().astype(np.int32),
                                      np.asarray(jy))
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6)


def test_mean_pool_single_view_shortcut():
    acc = torch.randn(10, 2, 4)
    cnt = (torch.rand(10, 2) > 0.5).float()
    acc = acc * cnt[..., None]
    vol1, seen1 = bp.mean_pool_from_sums(acc, cnt, n_views=1)
    vol, seen = bp.mean_pool_from_sums(acc, cnt)
    assert torch.equal(seen1, seen) and torch.equal(vol1, vol)


def test_get_points_and_projection_match_jax():
    origins = np.array([[34.57, -0.02, -0.99], [1.0, 2.0, 3.0]], np.float32)
    pts = bp.get_points((5, 6, 3), (0.32, 0.32, 0.32),
                        torch.from_numpy(origins)).numpy()
    for i in range(2):
        ref = np.asarray(jax_bp.get_points((5, 6, 3), (0.32, 0.32, 0.32),
                                           jnp.asarray(origins[i])))
        np.testing.assert_array_equal(pts[i], ref)
    rng = np.random.RandomState(1)
    k = rng.rand(2, 3, 3).astype(np.float32)
    e = rng.rand(2, 3, 4, 4).astype(np.float32)
    r = np.array([4.0, 2.5], np.float32)
    got = bp.compute_projection(torch.from_numpy(k), torch.from_numpy(e),
                                torch.from_numpy(r)).numpy()
    ref = np.asarray(jax.vmap(jax_bp.compute_projection)(
        jnp.asarray(k), jnp.asarray(e), jnp.asarray(r)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# B2: rotated-rect clip
# --------------------------------------------------------------------------

def _random_rects(rng, n):
    xy = rng.uniform(-4, 4, (n, 2))
    wh = rng.uniform(0.3, 3.0, (n, 2))
    r = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xy, wh, r], axis=1).astype(np.float32)


def _degenerate_rects():
    """Identical, disjoint, edge-touching and contained pairs."""
    b1 = np.array([[0., 0., 2., 2., 0.3], [0., 0., 2., 2., 0.0],
                   [0., 0., 2., 2., 0.0], [0., 0., 4., 4., 0.0]], np.float32)
    b2 = np.array([[0., 0., 2., 2., 0.3], [10., 10., 2., 2., 0.0],
                   [2., 0., 2., 2., 0.0], [0., 0., 1., 1., 1.0]], np.float32)
    return b1, b2


def _pairwise_corners(n1, n2, seed):
    rng = np.random.RandomState(seed)
    c1 = np.asarray(jax_boxes.bev_corners(jnp.asarray(_random_rects(rng, n1))))
    c2 = np.asarray(jax_boxes.bev_corners(jnp.asarray(_random_rects(rng, n2))))
    return c1[:, None], c2[None, :]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize('n1,n2,seed', [(60, 40, 0), (7, 11, 1), (48, 48, 7)])
def test_rect_clip_plain_bit_identical_to_jnp(n1, n2, seed):
    c1, c2 = _pairwise_corners(n1, n2, seed)
    ref = jax_iou._rect_intersection_area_jnp(jnp.asarray(c1),
                                              jnp.asarray(c2))
    got = iou_ops.rect_intersection_area_plain(torch.from_numpy(c1),
                                               torch.from_numpy(c2))
    assert got.shape == (n1, n2)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    assert (got.numpy() > 0).any() and (got.numpy() == 0).any()


# The JAX package's two clips are not bit-identical to each other on the
# CPU: the Pallas kernel in interpret mode differs from
# _rect_intersection_area_jnp by up to 1.4e-6 in 312 of these 2400 pairs.
# The port (plain version and CUDA kernel) keeps the jnp clip's bits, and is
# held to the Pallas kernel at the JAX package's own tolerance for that pair
# (tests/test_iou_pallas.py: rtol/atol 1e-5).
PALLAS_TOL = 1e-5


@pytest.mark.parametrize('compaction', ['scatter', 'shift'])
def test_rect_clip_plain_matches_pallas_interpret(compaction):
    c1, c2 = _pairwise_corners(60, 40, 0)
    ref = rect_intersection_area_pallas(jnp.asarray(c1), jnp.asarray(c2),
                                        compaction=compaction)
    got = iou_ops.rect_intersection_area_plain(torch.from_numpy(c1),
                                               torch.from_numpy(c2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_rect_clip_plain_nonmultiple_tile_padding():
    """The Pallas kernel pads 77 pairs to a 256-pair tile."""
    c1, c2 = _pairwise_corners(7, 11, 1)
    ref = rect_intersection_area_pallas(jnp.asarray(c1), jnp.asarray(c2),
                                        tile=256)
    got = iou_ops.rect_intersection_area_plain(torch.from_numpy(c1),
                                               torch.from_numpy(c2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_rect_clip_plain_degenerate_cases():
    b1, b2 = _degenerate_rects()
    c1 = box_ops.bev_corners(torch.from_numpy(b1))
    c2 = box_ops.bev_corners(torch.from_numpy(b2))
    got = iou_ops.rect_intersection_area_plain(c1, c2).numpy()
    np.testing.assert_allclose(got, [4.0, 0.0, 0.0, 1.0], atol=1e-5)
    jc1 = jax_boxes.bev_corners(jnp.asarray(b1))
    jc2 = jax_boxes.bev_corners(jnp.asarray(b2))
    ref = jax_iou._rect_intersection_area_jnp(jc1, jc2)
    np.testing.assert_array_equal(
        _bits(iou_ops.rect_intersection_area_plain(
            torch.from_numpy(np.asarray(jc1)),
            torch.from_numpy(np.asarray(jc2))).numpy()), _bits(ref))
    np.testing.assert_allclose(
        got, np.asarray(rect_intersection_area_pallas(jc1, jc2)),
        rtol=PALLAS_TOL, atol=PALLAS_TOL)


def test_bev_corners_and_rotated_iou_match_jax():
    rng = np.random.RandomState(3)
    b1, b2 = _random_rects(rng, 9), _random_rects(rng, 7)
    np.testing.assert_allclose(
        box_ops.bev_corners(torch.from_numpy(b1)).numpy(),
        np.asarray(jax_boxes.bev_corners(jnp.asarray(b1))),
        rtol=1e-6, atol=1e-6)
    got = iou_ops.rotated_iou_bev(torch.from_numpy(b1), torch.from_numpy(b2))
    ref = jax_iou.rotated_iou_bev(jnp.asarray(b1), jnp.asarray(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# B3: 3x3x3 conv
# --------------------------------------------------------------------------

@pytest.mark.parametrize('shape,tile', [
    # (B, nx, ny, nz, cin, cout), (tx, ty) of the Pallas kernel
    ((2, 8, 8, 5, 8, 8), (4, 4)),
    ((1, 6, 7, 4, 8, 16), (4, 4)),   # ragged nx and ny
    ((1, 9, 5, 12, 16, 8), (4, 4)),  # kitti-like nz
])
def test_conv3x3x3_plain_matches_conv3z_lanepack(shape, tile):
    b, nx, ny, nz, cin, cout = shape
    rng = np.random.RandomState(0)
    x = rng.randn(b, nx, ny, nz, cin).astype(np.float32)
    w = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    ref = conv3z_lanepack(jnp.asarray(x), jnp.asarray(w), *tile)
    got = conv3z.conv3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # the dispatcher takes the plain version for CPU tensors
    assert torch.equal(conv3z.conv3x3x3(torch.from_numpy(x),
                                        torch.from_numpy(w)), got)


def test_conv3x3x3_plain_bf16_matches_conv3z_lanepack_bf16():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 9, 6, 8).astype(np.float32)
    w = (rng.randn(3, 3, 3, 8, 8) * 0.1).astype(np.float32)
    ref = conv3z_lanepack(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(w, jnp.bfloat16), 4, 4)
    got = conv3z.conv3x3x3_plain(torch.from_numpy(x).to(torch.bfloat16),
                                 torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # both accumulate in float32 and round once: bfloat16 tolerance
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


def test_conv_gate_routes_only_kitti_block0():
    """The JAX gate's shape test: stride 1, pad 1, 64 -> 64, 6 <= nz <= 16
    and nx*ny >= 16384 (KITTI block0's 216x248x12 volume)."""
    conv = necks3d.Conv3x3x3(64, 64)
    kitti = torch.empty((1, 64, 216, 248, 12), device='meta')
    assert conv.takes_kernel(kitti)
    assert not conv.takes_kernel(torch.empty((1, 64, 216, 248, 6),
                                             device='meta')[..., :3])
    assert not conv.takes_kernel(torch.empty((1, 64, 32, 40, 12),
                                             device='meta'))
    assert not necks3d.Conv3x3x3(128, 128).takes_kernel(
        torch.empty((1, 128, 216, 248, 6), device='meta'))
    assert not necks3d.Conv3x3x3(64, 64, stride=(1, 1, 2)).takes_kernel(
        kitti)


# What the conv kernel's wrapper does on the host: weight pack, tiling plan,
# the kernel's row algorithm in plain PyTorch, and the float32 split.

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['float32', 'bfloat16'])
def test_conv_pack_weights_and_inverse(dtype):
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(3, 3, 3, 6, 10).astype(np.float32)).to(
        dtype)
    packed = conv_kernel.pack_weights(w)
    assert packed.shape == (27, 10, 6) and packed.is_contiguous()
    assert packed.dtype == dtype
    for dx, dy, dz in [(0, 0, 0), (2, 1, 0), (1, 2, 2)]:
        assert torch.equal(packed[(dx * 3 + dy) * 3 + dz], w[dx, dy, dz].T)
    assert torch.equal(conv_kernel.unpack_weights(packed), w)


def _plan_sites(plan, nx, ny, nz):
    """How often each site of the volume is stored, walking the plan's
    blocks and rows as the kernel does."""
    zp, cols = nz + 1, plan.ty + 2
    r = plan.first_row + np.arange(plan.rows)
    xh, yh, zh = r // (cols * zp), (r % (cols * zp)) // zp, r % zp
    count = np.zeros((nx, ny, nz), np.int64)
    for ix in range(plan.grid[0]):
        for iy in range(plan.grid[1]):
            gx, gy = ix * plan.tx + xh - 1, iy * plan.ty + yh - 1
            keep = ((xh >= 1) & (xh <= plan.tx) & (yh >= 1) & (yh <= plan.ty)
                    & (zh >= 1) & (gx < nx) & (gy < ny))
            np.add.at(count, (gx[keep], gy[keep], zh[keep] - 1), 1)
    return count


@settings(max_examples=40, deadline=None)
@given(nx=st.integers(1, 40), ny=st.integers(1, 70), nz=st.integers(6, 16))
def test_conv_tile_plan_covers_every_site_once(nx, ny, nz):
    plan = conv_kernel.tile_plan(nx, ny, nz)
    assert plan.rows % 64 == 0 and plan.rows == 256 * plan.n_groups
    assert plan.n_groups <= conv_kernel.MAX_GROUPS
    assert plan.smem_bytes <= conv_kernel.SMEM_LIMIT
    assert plan.grid == (-(-nx // plan.tx), -(-ny // plan.ty))
    assert plan.halo_rows == (plan.tx + 2) * (plan.ty + 2) * (nz + 1)
    # every tap of every computed row stays inside the buffer, and the row
    # after the halo (the z = nz neighbour of its last column) is in it
    lo = plan.first_row + plan.tap_offset(-1, -1, -1, nz)
    hi = plan.first_row + plan.rows - 1 + plan.tap_offset(1, 1, 1, nz)
    assert lo >= 0 and hi < plan.alloc_rows > plan.halo_rows
    assert (_plan_sites(plan, nx, ny, nz) == 1).all()


@pytest.mark.parametrize('shape,tile', [
    ((216, 248, 12), None),          # KITTI block0
    ((216, 248, 12), (4, 8)),
    ((312, 312, 12), None),          # nuScenes block0
    ((7, 9, 6), (2, 3)),
    ((5, 130, 13), None),
    ((3, 4, 16), (1, 1)),
])
def test_conv_tile_plan_shapes(shape, tile):
    plan = conv_kernel.tile_plan(*shape, tile)
    if tile is not None:
        assert (plan.tx, plan.ty) == tile
    assert (_plan_sites(plan, *shape) == 1).all()
    assert plan.n_groups <= conv_kernel.MAX_GROUPS


def test_conv_tile_plan_at_the_nuscenes_block0():
    """nuScenes' 312x312x12 block0 takes 4x8 tiles on a 78x39 grid, in
    136,264 B of shared memory (KITTI's 216x248x12: 2x18 on 108x14)."""
    plan = conv_kernel.tile_plan(312, 312, 12)
    assert (plan.tx, plan.ty, plan.grid) == (4, 8, (78, 39))
    assert plan.smem_bytes == 136264 <= conv_kernel.SMEM_LIMIT
    kitti = conv_kernel.tile_plan(216, 248, 12)
    assert (kitti.tx, kitti.ty, kitti.grid) == (2, 18, (108, 14))


def test_conv_tile_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match='no tiling'):
        conv_kernel.tile_plan(64, 64, 12, (16, 16))   # 4000 rows a block
    with pytest.raises(ValueError, match='no tiling'):
        conv_kernel.tile_plan(8, 8, 300)


@pytest.mark.parametrize('shape,tile', [
    ((2, 7, 9, 6, 8), None),
    ((1, 5, 13, 13, 8), (2, 3)),     # ragged nx and ny, odd nz
    ((1, 9, 5, 12, 16), (1, 1)),     # kitti-like nz, one column a block
    ((1, 3, 4, 16, 8), None),
])
def test_conv_rows_plain_matches_plain_and_lanepack(shape, tile):
    """The kernel's algorithm (27 shifted row-block matmuls over the packed
    weights, in its tap order, on its tiles) against ``F.conv3d`` and the
    JAX package's lane-packed Pallas conv in interpret mode."""
    b, nx, ny, nz, c = shape
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, 3, c, c) * 0.1).astype(np.float32)
    plan = conv_kernel.tile_plan(nx, ny, nz, tile)
    got = conv_kernel.conv3x3x3_rows_plain(
        torch.from_numpy(x), conv_kernel.pack_weights(torch.from_numpy(w)),
        plan)
    ref = conv3z.conv3x3x3_plain(torch.from_numpy(x), torch.from_numpy(w))
    jax_ref = conv3z_lanepack(jnp.asarray(x), jnp.asarray(w), 4, 4,
                              interpret=True)
    # float32 sums in another order
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref), rtol=2e-3,
                               atol=2e-3)


def _tf32(t):
    """float32 with the mantissa cut to TF32's 10 bits."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize('split', ['bf16x3', 'tf32x3'])
def test_conv_float32_split_keeps_float32_accuracy(split):
    """Why float32 is held to 1e-4: at the conv's K = 27 * 64 = 1728, the
    split products summed in float32 stay within 1e-4 of the float32 matmul
    (and of float64).  ``bf16x3`` is the split the kernel uses (six products
    of three bfloat16 parts); ``tf32x3`` the three-product TF32 split."""
    rng = np.random.RandomState(5)
    k = 27 * 64
    a = torch.from_numpy(rng.randn(512, k).astype(np.float32))
    b = torch.from_numpy((rng.randn(k, 64) / np.sqrt(k)).astype(np.float32))
    if split == 'bf16x3':
        a_p = conv_kernel.split3_bf16(a)
        b_p = conv_kernel.split3_bf16(b)
        assert a_p.dtype == torch.bfloat16 and a_p.shape == (3, 512, k)
        assert torch.equal(a_p.float().sum(0), a)        # 24 bits kept
        terms = [(2, 0), (1, 0), (1, 1), (0, 0), (0, 1), (0, 2)]
        got = sum(a_p[i].float() @ b_p[j].float() for i, j in terms)
    else:
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        got = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
        one_pass = (a_hi @ b_hi - a @ b).abs().max().item()
        assert one_pass > 1e-4                   # plain TF32 would not do
    ref64 = a.double() @ b.double()
    assert (got - a @ b).abs().max().item() < 1e-4
    assert (got.double() - ref64).abs().max().item() < 1e-4


# --------------------------------------------------------------------------
# The wrappers launch kernels only: CPU tensors are refused, not run
# --------------------------------------------------------------------------

@pytest.mark.parametrize('call', [
    lambda: bp_kernel.backproject_batch(
        torch.zeros(1, 1, 4, 4, 2), torch.zeros(1, 3, 3),
        torch.zeros(1, 1, 3, 4), torch.zeros(1, 2, dtype=torch.int32)),
    lambda: clip_kernel.rect_intersection_area(torch.zeros(3, 4, 2),
                                               torch.zeros(3, 4, 2)),
    lambda: conv_kernel.conv3x3x3(torch.zeros(1, 2, 2, 2, 64),
                                  torch.zeros(3, 3, 3, 64, 64)),
], ids=['backproject', 'rect_clip', 'conv3x3x3'])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match='CUDA tensor'):
        call()
    assert kernels.launch_counts() == before


def test_rect_clip_wrapper_refuses_gradients():
    c = torch.zeros(3, 4, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match='no backward'):
        clip_kernel.rect_intersection_area(c, c)
