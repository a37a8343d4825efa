"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  Small and ragged
shapes here; ``chip_smoke.py`` covers the KITTI main-path shapes.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imvoxelnet_tpu_torch import kernels
from imvoxelnet_tpu_torch.kernels import backproject as bp_kernel
from imvoxelnet_tpu_torch.kernels import build
from imvoxelnet_tpu_torch.kernels import conv3x3x3 as conv_kernel
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import nms as nms_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _bp_geometry(dev, b, v, hf, wf, valid_hw=None, n_voxels=(7, 6, 5),
                 blind_view=False):
    """Voxel centers, projections and valid extents of a small scene;
    ``blind_view`` puts every voxel behind the last view's camera."""
    k = torch.tensor([[20.0, 0, 8.037], [0, 20.0, 5.971], [0, 0, 1]],
                     device=dev)
    proj = torch.zeros((b, v, 3, 4), device=dev)
    for s in range(b):
        for i in range(v):
            e = torch.eye(4, device=dev)[:3]
            e[0, 3] = 0.2 * i + 0.05 * s
            proj[s, i] = k @ e
    if blind_view:
        proj[:, -1] = -proj[:, -1]
    origins = torch.tensor([[0.0137, -0.0213, 2.0071]] * b, device=dev)
    points = bp.get_points(n_voxels, (0.3, 0.3, 0.3), origins).reshape(
        b, -1, 3).contiguous()
    hw = torch.tensor([valid_hw or (hf, wf)] * b, dtype=torch.int32,
                      device=dev)
    return points, proj, hw


@pytest.mark.parametrize('b,v,c,dtype,valid_hw', [
    (1, 1, 64, torch.float32, None),
    (3, 2, 8, torch.float32, (9, 13)),
    (2, 3, 130, torch.bfloat16, None),     # C not a multiple of 64
    # the 16-bytes-a-lane path (rows of 1, 2, 8, 16 and 65 chunks) and the
    # one-warp-a-row path (rows that are not whole chunks), both dtypes;
    # P = 210 voxels is no multiple of the 8 or 16 rows a warp walks
    (3, 2, 8, torch.bfloat16, (9, 13)),
    (2, 2, 64, torch.bfloat16, None),
    (1, 3, 64, torch.float32, (9, 13)),
    (2, 3, 130, torch.float32, None),
    (1, 2, 260, torch.float32, None),
    (1, 1, 132, torch.bfloat16, (9, 13)),
])
def test_backproject_kernel_matches_plain(cuda, b, v, c, dtype, valid_hw):
    rng = np.random.RandomState(0)
    hf, wf = 12, 16
    feats = torch.tensor(rng.randn(b, v, hf, wf, c), dtype=torch.float32,
                         device=cuda).to(dtype)
    points, proj, hw = _bp_geometry(cuda, b, v, hf, wf, valid_hw)
    acc, cnt = bp_kernel.backproject_batch(feats, points, proj, hw)
    ref_acc, ref_cnt = bp.backproject_batch_plain(feats, points, proj, hw)
    assert acc.dtype == dtype and acc.shape == (points.shape[1], b, c)
    assert torch.equal(cnt, ref_cnt)
    assert 0 < (cnt > 0).float().mean() < 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(acc.float(), ref_acc.float(), rtol=tol,
                               atol=tol)
    # same pixels, same order of the views: the sums are the same bits
    assert torch.equal(acc, ref_acc)


@pytest.mark.parametrize('b,v,c,dtype,valid_hw,blind', [
    (1, 1, 64, torch.float32, None, False),
    (2, 3, 8, torch.float32, (9, 13), True),
    (3, 2, 64, torch.bfloat16, None, True),
    (2, 1, 130, torch.bfloat16, (9, 13), False),
    (1, 2, 2, torch.float32, None, False),
])
def test_backproject_grad_kernel_matches_plain(cuda, b, v, c, dtype,
                                               valid_hw, blind):
    """Odd P (105 voxels), views that see nothing, both dtypes; float32
    atomics land in any order, so a tolerance and not the same bits."""
    rng = np.random.RandomState(3)
    hf, wf = 12, 16
    points, proj, hw = _bp_geometry(cuda, b, v, hf, wf, valid_hw,
                                    n_voxels=(7, 5, 3), blind_view=blind)
    p = points.shape[1]
    assert p % 2 == 1
    g = torch.tensor(rng.randn(p, b, c), dtype=torch.float32,
                     device=cuda).to(dtype)
    kernels.reset_launch_counts()
    got = bp_kernel.backproject_batch_grad(g, points, proj, hw, hf, wf)
    assert kernels.launch_counts()['backproject_grad'] == 1
    ref = bp.backproject_batch_grad_plain(g, points, proj, hw, hf, wf)
    assert got.dtype == dtype and got.shape == (b, v, hf, wf, c)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    hits = bp.backproject_batch_grad_plain(
        torch.ones((p, b, 2), device=cuda), points, proj, hw, hf, wf)
    assert hits.max() > 1 and (hits == 0).any()
    if blind:
        assert not got[:, -1].any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backproject_function_gradient_matches_plain(cuda, dtype):
    """``backproject_batch`` on the card is differentiable: its gradient is
    the backward kernel's, equal to autograd through the plain forward
    (float32) and to the plain backward summed in float32 (bfloat16, whose
    autograd through the plain forward would sum in bfloat16)."""
    rng = np.random.RandomState(4)
    b, v, hf, wf, c = 2, 2, 12, 16, 64
    points, proj, hw = _bp_geometry(cuda, b, v, hf, wf, (9, 13))
    feats = torch.tensor(rng.randn(b, v, hf, wf, c), dtype=torch.float32,
                         device=cuda).to(dtype).requires_grad_()
    r = torch.tensor(rng.randn(points.shape[1], b, c), dtype=torch.float32,
                     device=cuda)
    kernels.reset_launch_counts()
    acc, cnt = bp.backproject_batch(feats, points, proj, hw)
    assert acc.grad_fn is not None and not cnt.requires_grad
    (acc.float() * r).sum().backward()
    counts = kernels.launch_counts()
    assert counts['backproject'] == 1 and counts['backproject_grad'] == 1
    if dtype == torch.float32:
        f = feats.detach().clone().requires_grad_()
        ref_acc, _ = bp.backproject_batch_plain(f, points, proj, hw)
        (ref_acc * r).sum().backward()
        ref = f.grad
    else:
        ref = bp.backproject_batch_grad_plain(r, points, proj, hw, hf, wf)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(feats.grad.float(), ref.float(), rtol=tol,
                               atol=tol)


def test_rect_clip_kernel_bit_identical_to_plain(cuda):
    rng = np.random.RandomState(1)
    n = 97
    boxes = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                            rng.uniform(0.3, 3.0, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    degenerate = [[0, 0, 2, 2, .3], [0, 0, 2, 2, 0], [2, 0, 2, 2, 0],
                  [0, 0, 1, 1, 1.0], [10, 10, 2, 2, 0]]
    boxes = np.concatenate([boxes, degenerate]).astype(np.float32)
    corners = box_ops.bev_corners(torch.tensor(boxes, device=cuda))
    c1 = corners[:, None].expand(-1, len(boxes), 4, 2).reshape(-1, 4, 2)
    c2 = corners[None, :].expand(len(boxes), -1, 4, 2).reshape(-1, 4, 2)
    got = clip_kernel.rect_intersection_area(c1.contiguous(), c2.contiguous())
    ref = iou_ops.rect_intersection_area_plain(c1, c2)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    # and through the dispatching op, broadcast pairing included
    pairs = iou_ops.rect_intersection_area(corners[:, None], corners[None])
    assert torch.equal(pairs.reshape(-1), got)


def _boxes(rng, g, n):
    """Random rects in a square that grows with n, then the degenerate
    ones: identical, touching, nested, disjoint, zero width, zero size."""
    side = 1.5 * np.sqrt(n)
    boxes = np.concatenate([rng.uniform(0, side, (g, n, 2)),
                            rng.uniform(0.3, 3.0, (g, n, 2)),
                            rng.uniform(-np.pi, np.pi, (g, n, 1))], -1)
    degenerate = [[0, 0, 2, 2, .3], [0, 0, 2, 2, .3], [2, 0, 2, 2, .3],
                  [0, 0, 1, 1, 1.0], [90, 90, 2, 2, 0], [0, 0, 0, 2, 0],
                  [0, 0, 0, 0, 0]]
    m = min(n, len(degenerate))
    boxes[:, :m] = degenerate[:m]
    return torch.tensor(boxes.astype(np.float32))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize('g,n,m', [(1, 1, 1), (1, 31, 33), (3, 33, 31),
                                   (3, 100, 100), (1, 100, 1), (3, 1, 100),
                                   (2, 257, 64)])
def test_rect_clip_pairwise_bit_identical_to_plain(cuda, g, n, m):
    rng = np.random.RandomState(3)
    c1 = box_ops.bev_corners(_boxes(rng, g, n).to(cuda)).contiguous()
    c2 = box_ops.bev_corners(_boxes(rng, g, m).to(cuda)).contiguous()
    got = clip_kernel.rect_intersection_area_pairwise(c1, c2)
    ref = iou_ops.rect_intersection_area_pairwise_plain(c1, c2)
    assert got.shape == (g, n, m)
    assert torch.equal(_bits(got), _bits(ref))
    # the paired entry on the materialised pairs gives the same bits
    paired = clip_kernel.rect_intersection_area(
        c1[:, :, None].expand(g, n, m, 4, 2).reshape(-1, 4, 2).contiguous(),
        c2[:, None, :].expand(g, n, m, 4, 2).reshape(-1, 4, 2).contiguous())
    assert torch.equal(_bits(paired), _bits(ref.reshape(-1)))


def test_rotated_iou_bev_takes_the_pairwise_entry_for_any_leading_dims(
        cuda, monkeypatch):
    rng = np.random.RandomState(4)
    b1 = _boxes(rng, 6, 9).reshape(2, 3, 9, 5).to(cuda)
    b2 = _boxes(rng, 3, 12).to(cuda)               # broadcasts over dim 0
    kernels.reset_launch_counts()
    got = iou_ops.rotated_iou_bev(b1, b2)
    assert kernels.launch_counts()['rect_clip'] == 1
    assert got.shape == (2, 3, 9, 12)
    monkeypatch.setattr(iou_ops, 'rect_intersection_area_pairwise',
                        iou_ops.rect_intersection_area_pairwise_plain)
    ref = iou_ops.rotated_iou_bev(b1, b2)
    assert kernels.launch_counts()['rect_clip'] == 1
    assert torch.equal(_bits(got), _bits(ref))
    assert 0 < float((got > 0).float().mean()) < 1


@pytest.mark.parametrize('g,n', [(1, 1), (1, 31), (3, 33), (3, 100),
                                 (1, 32), (2, 64), (1, 1100)])
@pytest.mark.parametrize('iou_thr', [0.01, 0.3])
def test_nms_mask_and_scan_match_plain(cuda, g, n, iou_thr):
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, g, n).to(cuda)
    valid = torch.tensor(rng.uniform(0, 1, (g, n)) > 0.15, device=cuda)
    corners = box_ops.bev_corners(boxes).contiguous()
    areas = (boxes[..., 2] * boxes[..., 3]).contiguous()
    mask = clip_kernel.nms_dominance_mask(corners, areas, iou_thr)
    assert mask.shape == (g, n, (n + 31) // 32) and mask.dtype == torch.int32
    assert torch.equal(mask, iou_ops.nms_dominance_mask_plain(
        corners, areas, iou_thr))
    keep = clip_kernel.nms_scan(mask, valid)
    assert keep.dtype == torch.bool and keep.shape == (g, n)
    assert torch.equal(keep, nms_ops.nms_scan_plain(mask, valid))
    # the pair equals the fixpoint NMS on the plain IoU
    iou = iou_ops.iou_from_overlaps(
        iou_ops.rect_intersection_area_pairwise_plain(corners, corners),
        areas, areas)
    assert torch.equal(keep, nms_ops.greedy_nms_from_iou_batched(
        iou, areas, valid, iou_thr, presorted=True))
    assert torch.equal(nms_ops.rotated_nms_presorted(boxes, valid, iou_thr),
                       keep)


@pytest.mark.parametrize('case', ['all_invalid', 'all_valid', 'chain'])
def test_nms_scan_edge_cases(cuda, case):
    n = 70
    dominates = torch.zeros((2, n, n), dtype=torch.bool)
    valid = torch.ones((2, n), dtype=torch.bool)
    if case == 'all_invalid':
        dominates[:] = torch.ones(n, n).triu(1).bool()
        valid[:] = False
        want = torch.zeros((2, n), dtype=torch.bool)
    elif case == 'all_valid':
        want = valid.clone()
    else:                       # i suppresses i + 1 only: every other survives
        idx = torch.arange(n - 1)
        dominates[:, idx, idx + 1] = True
        want = (torch.arange(n) % 2 == 0).expand(2, n)
    keep = clip_kernel.nms_scan(iou_ops.pack_mask(dominates).to(cuda),
                                valid.to(cuda))
    assert torch.equal(keep.cpu(), want)


def _head_outs(cuda, b=3, h=10, w=12, seed=6):
    rng = np.random.RandomState(seed)
    cfg = a3d.Anchor3DHeadConfig()
    a = cfg.num_anchors
    # sample 1 has a handful of scores above the threshold, sample 2 none
    offset = np.array([0.0, 5.0, 9.0])[:b, None, None, None]
    outs = (rng.randn(b, h, w, a * cfg.num_classes) * 2 - offset,
            rng.randn(b, h, w, a * cfg.box_code_size) * 0.3,
            rng.randn(b, h, w, a * 2))
    return cfg, tuple(torch.tensor(o.astype(np.float32), device=cuda)
                      for o in outs)


def test_decode_and_nms_never_wait_for_the_device(cuda, monkeypatch):
    """``set_sync_debug_mode('error')`` makes PyTorch raise on an
    ``.item()``, a ``bool(tensor)`` or a copy to the host.  The result
    equals the plain path's on the same device, bit for bit."""
    cfg, outs = _head_outs(cuda)
    a3d.anchor3d_head_get_bboxes(outs, cfg)      # builds, caches the anchors
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = a3d.anchor3d_head_get_bboxes(outs, cfg)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = kernels.launch_counts()
    assert counts['rect_clip'] == 1 and counts['nms_scan'] == 1
    monkeypatch.setattr(nms_ops, 'rotated_nms_presorted',
                        nms_ops.rotated_nms_presorted_plain)
    monkeypatch.setattr(iou_ops, 'rect_intersection_area_pairwise',
                        iou_ops.rect_intersection_area_pairwise_plain)
    ref = a3d.anchor3d_head_get_bboxes(outs, cfg)
    assert kernels.launch_counts() == counts
    n_det = res['valid'].sum(1).tolist()
    assert n_det[0] > n_det[1] > n_det[2] == 0, n_det
    for key in ('valid', 'labels', 'boxes', 'scores'):
        assert torch.equal(res[key], ref[key]), key


@pytest.mark.parametrize('shape,dtype,tile', [
    ((2, 7, 9, 6, 64), torch.float32, None),     # M = 756
    ((1, 5, 130, 13, 64), torch.bfloat16, None),
    # every edge of the tiling: nz = 6, 12, 13, 16; nx, ny no multiples of
    # the tile; B = 1 and 3; a volume smaller than one tile; one and two
    # warpgroups of rows; both dtypes
    ((1, 5, 130, 13, 64), torch.float32, None),
    ((3, 9, 10, 12, 64), torch.bfloat16, (2, 3)),
    ((3, 9, 10, 12, 64), torch.float32, (4, 8)),
    ((1, 6, 20, 16, 64), torch.bfloat16, None),
    ((1, 6, 20, 16, 64), torch.float32, (1, 1)),
    ((1, 4, 4, 6, 64), torch.bfloat16, (4, 8)),
    ((1, 1, 1, 7, 64), torch.float32, None),
    ((2, 7, 9, 6, 64), torch.bfloat16, (1, 1)),
    ((1, 11, 37, 12, 64), torch.bfloat16, (2, 18)),   # the KITTI tile
])
def test_conv3x3x3_kernel_matches_plain(cuda, shape, dtype, tile):
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(*shape), dtype=torch.float32,
                     device=cuda).to(dtype)
    w = torch.tensor(rng.randn(3, 3, 3, 64, 64) / np.sqrt(27 * 64),
                     dtype=torch.float32, device=cuda).to(dtype)
    got = conv_kernel.conv3x3x3(x, w, tile)
    ref = conv3z.conv3x3x3_plain(x, w)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def test_conv3x3x3_kernel_refuses_a_tile_that_does_not_fit(cuda):
    x = torch.zeros((1, 32, 32, 12, 64), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 64, 64), dtype=torch.bfloat16, device=cuda)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match='no tiling'):
        conv_kernel.conv3x3x3(x, w, (16, 16))
    assert kernels.launch_counts()['conv3x3x3'] == 0


def test_conv3x3x3_library_holds_tensor_core_instructions(cuda):
    assert build.sass_count('conv3x3x3', 'HGMMA') > 0


@pytest.mark.parametrize('shape,dtype', [
    ((2, 7, 9, 6, 64), torch.float32),
    ((1, 5, 130, 13, 64), torch.bfloat16),
    ((1, 11, 37, 12, 64), torch.bfloat16),
])
def test_conv3x3x3_function_matches_conv3d_autograd(cuda, shape, dtype):
    """The op on the card as the 3D neck calls it (an NCDHW volume in
    ``channels_last_3d`` memory, permuted to NDHWC; a float32 weight cast to
    the compute dtype): forward and ``dx`` through the kernel, ``dk`` from
    ``convolution_backward``, against ``F.conv3d``'s autograd (TF32 off).
    The output gradient arrives as a permute of an NCDHW-contiguous tensor,
    so the backward must make it NDHWC-contiguous itself."""
    rng = np.random.RandomState(5)
    b, nx, ny, nz, c = shape
    x0 = torch.tensor(rng.randn(b, c, nx, ny, nz), dtype=torch.float32,
                      device=cuda).to(dtype)
    x0 = x0.contiguous(memory_format=torch.channels_last_3d)
    w0 = torch.tensor(rng.randn(c, c, 3, 3, 3) / np.sqrt(27 * c),
                      dtype=torch.float32, device=cuda)
    r = torch.tensor(rng.randn(b, c, nx, ny, nz), dtype=torch.float32,
                     device=cuda)

    def run(conv):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        y = conv(x, w.to(dtype))
        (y.float() * r).sum().backward()
        return y, x.grad, w.grad

    kernels.reset_launch_counts()
    got = run(lambda x, w: conv3z.conv3x3x3(
        x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0)).permute(
            0, 4, 1, 2, 3))
    assert kernels.launch_counts()['conv3x3x3'] == 2      # forward and dx
    ref = run(lambda x, w: F.conv3d(x, w, padding=1))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, e in zip(('y', 'dx', 'dk'), got, ref):
        scale = e.float().abs().max().item()
        torch.testing.assert_close(a.float(), e.float(), rtol=tol,
                                   atol=tol * scale, msg=lambda m: f'{name}: {m}')


def test_functions_pass_gradcheck_on_their_plain_forms(cuda):
    """Both ``autograd.Function``s in float64 on the card, through their
    plain forms (the kernels take float32 and bfloat16 only)."""
    rng = np.random.RandomState(6)
    points, proj, hw = _bp_geometry(cuda, 2, 2, 6, 8, n_voxels=(5, 4, 3))
    feats = torch.tensor(rng.randn(2, 2, 6, 8, 2), dtype=torch.float64,
                         device=cuda, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda f: bp.BackprojectFunction.apply(f, points, proj, hw, True)[0],
        (feats,))
    x = torch.tensor(rng.randn(1, 4, 5, 3, 2), dtype=torch.float64,
                     device=cuda, requires_grad=True)
    k = torch.tensor(rng.randn(3, 3, 3, 2, 3), dtype=torch.float64,
                     device=cuda, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, w: conv3z.Conv3x3x3Function.apply(a, w, True), (x, k))


def test_wrappers_count_launches(cuda):
    kernels.reset_launch_counts()
    c = torch.zeros((4, 4, 2), device=cuda)
    clip_kernel.rect_intersection_area(c, c)
    clip_kernel.rect_intersection_area_pairwise(c[None], c[None])
    mask = clip_kernel.nms_dominance_mask(
        c[None], torch.zeros((1, 4), device=cuda), 0.5)
    assert kernels.launch_counts() == {'backproject': 0,
                                       'backproject_grad': 0, 'rect_clip': 3,
                                       'nms_scan': 0, 'conv3x3x3': 0}
    clip_kernel.nms_scan(mask, torch.ones((1, 4), dtype=torch.bool,
                                          device=cuda))
    points, proj, hw = _bp_geometry(cuda, 1, 1, 6, 8)
    bp_kernel.backproject_batch_grad(
        torch.zeros((points.shape[1], 1, 4), device=cuda), points, proj, hw,
        6, 8)
    assert kernels.launch_counts() == {'backproject': 0,
                                       'backproject_grad': 1, 'rect_clip': 3,
                                       'nms_scan': 1, 'conv3x3x3': 0}


def test_backproject_grad_wrapper_refuses_what_the_kernel_does_not_take(
        cuda):
    points, proj, hw = _bp_geometry(cuda, 1, 1, 6, 8)
    g = torch.zeros((points.shape[1], 1, 4), device=cuda)
    with pytest.raises(ValueError, match='CUDA tensor'):
        bp_kernel.backproject_batch_grad(g.cpu(), points, proj, hw, 6, 8)
    with pytest.raises(TypeError):
        bp_kernel.backproject_batch_grad(g.double(), points, proj, hw, 6, 8)
    with pytest.raises(ValueError, match='even'):
        bp_kernel.backproject_batch_grad(g[..., :3].contiguous(), points,
                                         proj, hw, 6, 8)
    with pytest.raises(ValueError, match='shape mismatch'):
        bp_kernel.backproject_batch_grad(g[:-1].contiguous(), points, proj,
                                         hw, 6, 8)


def _clip_calls(dev):
    """Each clip wrapper on well-formed inputs on ``dev``, by name, as
    ``(function, args)`` whose tensors a test then spoils one at a time."""
    c = torch.zeros((2, 5, 4, 2), device=dev)
    return {
        'paired': (clip_kernel.rect_intersection_area, [c[0], c[1]]),
        'pairwise': (clip_kernel.rect_intersection_area_pairwise, [c, c]),
        'mask': (lambda corners, areas: clip_kernel.nms_dominance_mask(
            corners, areas, 0.5), [c, torch.zeros((2, 5), device=dev)]),
        'scan': (clip_kernel.nms_scan,
                 [torch.zeros((2, 5, 1), dtype=torch.int32, device=dev),
                  torch.ones((2, 5), dtype=torch.bool, device=dev)]),
    }


@pytest.mark.parametrize('name', ['paired', 'pairwise', 'mask', 'scan'])
def test_clip_wrappers_refuse_what_the_kernels_do_not_take(cuda, name):
    fn, args = _clip_calls(cuda)[name]
    fn(*args)                                     # well-formed: runs
    before = kernels.launch_counts()
    for i, arg in enumerate(args):
        def spoiled(t):
            return args[:i] + [t] + args[i + 1:]
        with pytest.raises(ValueError, match='CUDA tensor'):
            fn(*spoiled(arg.cpu()))
        with pytest.raises(TypeError):
            fn(*spoiled(arg.to(torch.float64)))
        with pytest.raises(ValueError):
            fn(*spoiled(arg[:, :-1]))             # wrong shape
        with pytest.raises(ValueError, match='contiguous'):
            fn(*spoiled(arg.repeat_interleave(2, dim=1)[:, ::2]))
        if arg.dtype == torch.float32 and arg.dim() > 2:
            with pytest.raises(RuntimeError, match='no backward'):
                fn(*spoiled(arg.clone().requires_grad_()))
    assert kernels.launch_counts() == before
