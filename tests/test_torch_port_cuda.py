"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  Small and ragged
shapes here, the SUN RGB-D serving shapes, ScanNet's 20 and 50 views and
nuScenes' six views, block0 and decode (and its DCN on the card);
``chip_smoke.py`` covers the main paths' shapes with times.  This file
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
from imvoxelnet_tpu_torch.core import coder
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.configs.presets import get_preset
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh
from imvoxelnet_tpu_torch.models.heads import layout_head as lh
from imvoxelnet_tpu_torch.utils.synthetic import (NUSCENES_ORIGIN,
                                                  nuscenes_lidar2img,
                                                  scannet_batch,
                                                  sunrgbd_batch)
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import losses
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
                 blind_view=False, cluster=0):
    """Voxel centers, projections and valid extents of a small scene;
    ``blind_view`` puts every voxel behind the last view's camera;
    ``cluster`` copies of one seen voxel center are spread over the voxel
    list, so that one pixel is read by that many voxels or more."""
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
    if cluster:
        _, valid = bp._view_indices(points, proj, hw, hf, wf)
        hot = int(valid.sum((0, 1)).argmax())
        pieces, start = [], 0
        for at in np.linspace(0, points.shape[1], cluster, endpoint=False):
            pieces += [points[:, start:int(at)], points[:, hot:hot + 1]]
            start = int(at)
        points = torch.cat(pieces + [points[:, start:]], 1).contiguous()
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


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _check_grad_kernel(dev, b, v, c, dtype, cluster, valid_hw=(9, 13)):
    """The gather kernel against the plain version run on CPU copies, bit
    for bit, and a second launch against the first."""
    rng = np.random.RandomState(3)
    hf, wf = 12, 16
    points, proj, hw = _bp_geometry(dev, b, v, hf, wf, valid_hw,
                                    n_voxels=(7, 5, 3), blind_view=v > 1,
                                    cluster=cluster)
    p = points.shape[1]
    g = torch.tensor(rng.randn(p, b, c), dtype=torch.float32,
                     device=dev).to(dtype)
    kernels.reset_launch_counts()
    got = bp_kernel.backproject_batch_grad(g, points, proj, hw, hf, wf)
    again = bp_kernel.backproject_batch_grad(g, points, proj, hw, hf, wf)
    assert kernels.launch_counts()['backproject_grad'] == 2
    ref = bp.backproject_batch_grad_plain(g.cpu(), points.cpu(), proj.cpu(),
                                          hw.cpu(), hf, wf)
    assert got.dtype == dtype and got.shape == (b, v, hf, wf, c)
    assert _same_bits(got.cpu(), ref)
    assert _same_bits(again, got)
    hits = bp.backproject_batch_grad_plain(
        torch.ones((p, b, 2)), points.cpu(), proj.cpu(), hw.cpu(), hf, wf)
    assert hits.max() >= cluster and (hits == 0).any()
    if valid_hw is None:     # the map's last row and column are read
        assert hits[:, :, -1].any() and hits[:, :, :, -1].any()
    if v > 1:
        assert not got[:, -1].any()
    return p


@pytest.mark.parametrize('valid_hw', [None, (9, 13)], ids=['full', 'crop'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('b,v,c', [
    (b, v, c) for b in (1, 2, 3) for v in (1, 3) for c in (64, 256, 130)]
    + [(2, v, c) for v in (1, 3) for c in (8, 2)] + [(3, 2, 64)])
def test_backproject_grad_kernel_matches_plain(cuda, b, v, c, dtype,
                                               valid_hw):
    """The gather kernel equals the plain version run on CPU copies bit for
    bit, and a second launch repeats the first: odd P, a cluster of 40
    voxels on one pixel (a segment longer than a warp, ordered in shared
    memory), the whole map (its border pixels read) or a cropped valid
    extent, pixels no voxel reads, a view that sees nothing (v > 1), rows
    of whole 16-byte chunks (C=64, 256, 8) and not (C=130, 2)."""
    assert _check_grad_kernel(cuda, b, v, c, dtype, cluster=40,
                              valid_hw=valid_hw) % 2 == 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('c', [64, 130])
@pytest.mark.parametrize('v', [1, 3])
def test_backproject_grad_kernel_orders_long_segments(cuda, v, c, dtype):
    """A segment of 200+ voxels, longer than the sum pass orders in shared
    memory (160): it ranks such a list in device memory."""
    _check_grad_kernel(cuda, 2, v, c, dtype, cluster=200)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backproject_function_gradient_matches_plain(cuda, dtype):
    """``backproject_batch`` on the card is differentiable: its gradient is
    the backward kernel's, bit-identical to the plain backward on the CPU,
    and equal to autograd through the plain forward (float32; bfloat16's
    would sum in bfloat16)."""
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
    ref = bp.backproject_batch_grad_plain(r.cpu().to(dtype), points.cpu(),
                                          proj.cpu(), hw.cpu(), hf, wf)
    assert _same_bits(feats.grad.cpu(), ref)
    if dtype == torch.float32:
        f = feats.detach().clone().requires_grad_()
        ref_acc, _ = bp.backproject_batch_plain(f, points, proj, hw)
        (ref_acc * r).sum().backward()
        torch.testing.assert_close(feats.grad, f.grad, rtol=1e-5, atol=1e-5)


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


def _clip_grad_pairs(dev, rng, n=4000):
    """Corner pairs ``(P, 4, 2)`` as the IoU-3D loss makes them (each
    predicted rect near its target), then nested, identical, touching and
    disjoint ones, and area gradients with zeros."""
    a = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                        rng.uniform(0.3, 3.0, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    b = a + np.concatenate([0.5 * rng.randn(n, 2), 0.3 * rng.randn(n, 2),
                            0.5 * rng.randn(n, 1)], -1)
    b[:, 2:4] = np.abs(b[:, 2:4]) + 0.1
    special = np.array([
        [0, 0, 2, 2, .3, 0, 0, 2, 2, .3], [0, 0, 4, 3, .2, .1, .2, 1, 1, 1.1],
        [.1, .2, 1, 1, 1.1, 0, 0, 4, 3, .2], [0, 0, 2, 2, 0, 2, 0, 2, 2, 0],
        [0, 0, 2, 2, 0, 2, 2, 2, 2, 0], [0, 0, 2, 2, 0, 9, 9, 2, 2, .4]] * 8)
    a = np.concatenate([a, special[:, :5]]).astype(np.float32)
    b = np.concatenate([b, special[:, 5:]]).astype(np.float32)
    g = rng.randn(len(a)).astype(np.float32)
    g[::5] = 0.0
    return (box_ops.bev_corners(torch.tensor(a, device=dev)).contiguous(),
            box_ops.bev_corners(torch.tensor(b, device=dev)).contiguous(),
            torch.tensor(g, device=dev))


def _zero_pairs(grad):
    return (grad.reshape(grad.shape[0], -1) == 0).all(1)


def test_rect_clip_function_matches_plain_autograd(cuda):
    """``RectClipFunction`` (the paired entry forward, the backward kernel
    backward) against autograd of the plain clip on the same CUDA tensors:
    the areas bit for bit, the gradients within 1e-5 of their max-abs and
    exactly zero for the same pairs; one launch of each kernel."""
    c1, c2, g = _clip_grad_pairs(cuda, np.random.RandomState(8))
    x1, x2 = c1.clone().requires_grad_(), c2.clone().requires_grad_()
    kernels.reset_launch_counts()
    area = iou_ops.rect_intersection_area(x1, x2)
    (area * g).sum().backward()
    counts = kernels.launch_counts()
    assert counts['rect_clip'] == 1 and counts['rect_clip_grad'] == 1
    y1, y2 = c1.clone().requires_grad_(), c2.clone().requires_grad_()
    ref = iou_ops.rect_intersection_area_plain(y1, y2)
    (ref * g).sum().backward()
    assert torch.equal(area.detach().view(torch.int32), ref.view(torch.int32))
    for got, want in ((x1.grad, y1.grad), (x2.grad, y2.grad)):
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
        assert torch.equal(_zero_pairs(got), _zero_pairs(want))
    assert int(_zero_pairs(y1.grad).sum()) > len(g) // 5


@pytest.mark.parametrize('case', ['all_zero', 'all_live', 'n1', 'n129',
                                  'nan', 'repeat'])
def test_rect_clip_grad_kernel_cases(cuda, case):
    """The backward kernel's two passes (zeros and the live list, then the
    sweep over the listed pairs) against autograd of the plain clip: within
    1e-5 of the max-abs gradient and exactly zero for the same pairs, with
    the kernels' live count equal to the nonzero area gradients.  A NaN area
    gradient is live (its pair's gradient holds a NaN where the clipped
    polygon has 3 vertices or more); two launches give the same bits."""
    c1, c2, g = _clip_grad_pairs(cuda, np.random.RandomState(10))
    if case == 'all_zero':
        g = torch.zeros_like(g)
    elif case == 'all_live':
        g = torch.where(g == 0, 0.5, g)
    elif case in ('n1', 'n129'):
        n = 1 if case == 'n1' else 129
        c1, c2, g = (x[1:1 + n].clone() for x in (c1, c2, g))
    elif case == 'nan':
        g[3::40] = float('nan')
    g1, g2, n_live = clip_kernel.rect_intersection_area_grad_live(c1, c2, g)
    assert int(n_live.item()) == int((g != 0).sum())
    if case == 'repeat':
        again = clip_kernel.rect_intersection_area_grad(c1, c2, g)
        assert _same_bits(g1, again[0]) and _same_bits(g2, again[1])
    y1, y2 = c1.clone().requires_grad_(), c2.clone().requires_grad_()
    ref = iou_ops.rect_intersection_area_plain(y1, y2)
    (ref * g).sum().backward()
    finite = ~g.isnan()
    for got, want in ((g1, y1.grad), (g2, y2.grad)):
        got, want = got[finite], want[finite]
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
        assert torch.equal(_zero_pairs(got), _zero_pairs(want))
    if case == 'nan':
        swept = ~finite & (ref.detach() > 0)
        assert swept.any() and g1[swept].reshape(-1, 8).isnan().any(1).all()
    if case == 'all_zero':
        assert (g1.view(torch.int32) == 0).all()
        assert (g2.view(torch.int32) == 0).all()


def test_rect_clip_grad_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    c = torch.zeros((5, 4, 2), device=cuda)
    g = torch.zeros(5, device=cuda)
    clip_kernel.rect_intersection_area_grad(c, c, g)      # well-formed
    before = kernels.launch_counts()
    for args in ((c.cpu(), c, g), (c, c, g.cpu()), (c, c, g[:4]),
                 (c, c[:4], g), (c, c, g.double()), (c[:, :3], c, g)):
        with pytest.raises((ValueError, TypeError)):
            clip_kernel.rect_intersection_area_grad(*args)
    with pytest.raises(RuntimeError, match='no backward'):
        clip_kernel.rect_intersection_area_grad(c.clone().requires_grad_(),
                                                c, g)
    assert kernels.launch_counts() == before


def test_iou_3d_loss_backward_through_the_kernels_matches_plain(cuda):
    """The IoU-3D loss's gradient on the card through the clip kernels and
    through autograd of the plain clip, from the same boxes."""
    rng = np.random.RandomState(9)
    n = 3000
    target = np.concatenate([rng.uniform(-3, 3, (n, 3)),
                             rng.uniform(0.3, 2.5, (n, 3)),
                             rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    pred = target + np.concatenate([0.2 * rng.randn(n, 3),
                                    0.1 * rng.randn(n, 3),
                                    0.3 * rng.randn(n, 1)], -1)
    weight = torch.tensor(rng.uniform(size=n) > 0.6, device=cuda).float()
    target = torch.tensor(target, dtype=torch.float32, device=cuda)
    grads = []
    for route in ('kernel', 'plain'):
        p = torch.tensor(pred, dtype=torch.float32, device=cuda,
                         requires_grad=True)
        if route == 'plain':
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(iou_ops, 'rect_intersection_area',
                           iou_ops.rect_intersection_area_plain)
                loss = losses.iou_3d_loss(p, target, weight=weight,
                                          avg_factor=weight.sum())
        else:
            loss = losses.iou_3d_loss(p, target, weight=weight,
                                      avg_factor=weight.sum())
        loss.backward()
        grads.append(p.grad)
    scale = grads[1].abs().max().item()
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5,
                               atol=1e-5 * scale)
    assert torch.equal(_zero_pairs(grads[0]), _zero_pairs(grads[1]))
    assert scale > 0


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


# ---------------------------------------------------------------------------
# the SUN RGB-D serving shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name,b,dtype', [
    ('imvoxelnet_sunrgbd', 1, torch.float32),      # C = 64, 204,800 voxels
    ('imvoxelnet_sunrgbd', 3, torch.bfloat16),
    ('imvoxelnet_sunrgbd_fast', 1, torch.float32),  # C = 256, 25,600 voxels
    ('imvoxelnet_sunrgbd_fast', 3, torch.bfloat16),
    ('imvoxelnet_sunrgbd_fast', 2, torch.bfloat16),
])
def test_backproject_kernel_matches_plain_at_the_indoor_shapes(cuda, name, b,
                                                               dtype):
    """B1 at the SUN RGB-D feature map (120x160) and grids: rows of 128 to
    1024 bytes on the 16-bytes-a-lane path, at odd and even batch sizes."""
    cfg = get_preset(name).model
    batch = sunrgbd_batch(b, cuda, seed=2)
    rng = np.random.RandomState(1)
    feats = torch.tensor(rng.randn(b, 1, 120, 160, cfg.fpn_out_channels),
                         dtype=torch.float32, device=cuda).to(dtype)
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                           batch['origins']).reshape(b, -1, 3).contiguous()
    proj = bp.compute_projection(batch['intrinsics'], batch['extrinsics'],
                                 batch['ratios']).contiguous()
    hw = (batch['img_shape'] // 4).to(torch.int32)
    acc, cnt = bp_kernel.backproject_batch(feats, points, proj, hw)
    ref_acc, ref_cnt = bp.backproject_batch_plain(feats, points, proj, hw)
    assert acc.shape == (points.shape[1], b, cfg.fpn_out_channels)
    assert torch.equal(cnt, ref_cnt)
    assert 0 < float((cnt > 0).float().mean()) < 1
    # one view: the sums are the gathered values themselves
    assert torch.equal(acc, ref_acc)


@pytest.mark.parametrize('g', [80, 240])
def test_nms_kernels_match_plain_at_the_indoor_shapes(cuda, g):
    """The mask of ``g`` groups of 256 candidates (8 words a row, the words
    on and below the diagonal skipped) bit for bit, and the scan."""
    rng = np.random.RandomState(7)
    n = 256
    boxes = _boxes(rng, g, n).to(cuda)
    valid = torch.tensor(rng.uniform(0, 1, (g, n)) > 0.1, device=cuda)
    corners = box_ops.bev_corners(boxes).contiguous()
    areas = (boxes[..., 2] * boxes[..., 3]).contiguous()
    mask = clip_kernel.nms_dominance_mask(corners, areas, 0.15)
    assert mask.shape == (g, n, 8)
    assert torch.equal(mask, iou_ops.nms_dominance_mask_plain(corners, areas,
                                                              0.15))
    keep = clip_kernel.nms_scan(mask, valid)
    assert torch.equal(keep, nms_ops.nms_scan_plain(mask, valid))
    assert 0 < int(keep.sum()) < int(valid.sum())


def _room_boxes(rng, s, n):
    """``(s, n, 5)`` BEV boxes of furniture size in a 6.4 m room, where the
    SUN RGB-D decode's candidates lie: near pairs and far ones."""
    return torch.tensor(np.concatenate([
        rng.uniform(0, 6.4, (s, n, 2)), rng.uniform(0.3, 2.5, (s, n, 2)),
        rng.uniform(-np.pi, np.pi, (s, n, 1))], -1).astype(np.float32))


def _edge_corners(rng, s, n):
    """``(s, n, 4, 2)`` corners that try the exact-NMS entry's skip of far
    pairs: squares just beyond and just within the skip's reach of box 0
    (corner to corner and edge to edge), parallel slats whose circles
    overlap, touching and just within and beyond the margin along their
    normals, boxes spread over 200 m and at
    1e5 m, slivers, zero width, zero size, reversed winding, a crossed
    quad, NaN and inf; the rest of the rows random room boxes."""
    boxes = _room_boxes(rng, s, n)
    r2 = float(np.sqrt(2.0))
    special = [[0, 0, 2, 2, 0]]
    for d in (2.0, 2.0 + 1e-4, 2 * r2, 2 * r2 + 4e-3, 2 * r2 + 6e-3,
              2 * r2 + 8e-3, 2 * r2 + 0.05, 3.5):
        special += [[d, 0, 2, 2, 0], [d, 0, 2, 2, np.pi / 4]]
    special += [[10, 10, 4, 0.2, 0]]          # slats: circles overlap
    for d in (0.0, 0.01, 0.04):
        special += [[10, 10.2 + d, 4, 0.2, 0], [10.2 + d, 10, 4, 0.2, 0]]
    special += [[100, -100, 3, 1, 0.5], [1e5, 1e5, 2, 2, 0.1],
                [1e5 + 1, 1e5, 2, 2, 0.2], [1, 1, 2, 1e-6, 0.3],
                [1, 1, 0, 2, 0], [1, 1, 0, 0, 0], [50, 50, 1e-6, 1e-6, 0]]
    m = len(special)
    boxes[:, :m] = torch.tensor(special, dtype=torch.float32)
    corners = box_ops.bev_corners(boxes)
    corners[:, m] = corners[:, m].flip(-2)                  # reversed winding
    corners[:, m + 1] = corners[:, 3][:, [0, 2, 1, 3]]      # crossed
    corners[:, m + 2, 1, 0] = float('nan')
    corners[:, m + 3, 2, 1] = float('inf')
    corners[:, m + 4] = corners[:, 0] * 1e-3
    return corners


@pytest.mark.parametrize('case,s,n', [('room', 1, 3000), ('room', 3, 257),
                                      ('edge', 2, 96)])
def test_nms_over_bits_equal_the_plain_version(cuda, case, s, n):
    """B2's exact-NMS entry bit for bit against its plain version (the
    packed ``iou > thr`` of the plain clip): at the exact NMS's 3,000
    candidates, at a ragged width, and on the corners that try its skip of
    far pairs; at a threshold equal to one pair's IoU, at 0 and below 0
    (where every pair with an IoU is over).  The room boxes' bits also
    equal those of the pairwise entry's ``rotated_iou_bev``."""
    rng = np.random.RandomState(11)
    if case == 'room':
        boxes = _room_boxes(rng, s, n).to(cuda)
        corners = box_ops.bev_corners(boxes).contiguous()
        areas = (boxes[..., 2] * boxes[..., 3]).contiguous()
    else:
        corners = _edge_corners(rng, s, n).to(cuda).contiguous()
        side = corners[..., 1, :] - corners[..., 0, :]
        other = corners[..., 2, :] - corners[..., 1, :]
        areas = (side.norm(dim=-1) * other.norm(dim=-1)).contiguous()
    iou = iou_ops.iou_from_overlaps(
        iou_ops.rect_intersection_area_pairwise_plain(corners, corners),
        areas, areas)
    at = float(iou[(iou > 0.1) & (iou < 0.5)][0])
    for thr in (at, 0.0, -0.25):
        over = clip_kernel.nms_over_bits(corners, areas, thr)
        assert over.shape == (s, n, (n + 31) // 32)
        assert torch.equal(over, iou_ops.pack_mask(iou > thr)), thr
    assert bool((iou == at).any())
    assert 0 < float((iou > 0).float().mean()) < 0.9
    if case == 'room':
        card = iou_ops.rotated_iou_bev(boxes, boxes)
        assert torch.equal(iou_ops.pack_mask(card > at),
                           clip_kernel.nms_over_bits(corners, areas, at))


@pytest.mark.parametrize('g,s,n', [(80, 8, 3000), (6, 2, 33), (5, 5, 40),
                                   (2, 1, 11000)])
def test_nms_rank_mask_equals_the_plain_version(cuda, g, s, n):
    """The rank gather bit for bit against its plain version, on random
    bits (beyond N too) and rankings, groups sharing matrices: the exact
    NMS's 80 groups of 3,000, ragged widths, and 11,000 candidates, whose
    88 KB of shared memory take the opt-in above 48 KB."""
    gen = torch.Generator(device=cuda).manual_seed(g)
    w = (n + 31) // 32
    over = torch.randint(-2 ** 31, 2 ** 31 - 1, (s, n, w), generator=gen,
                         device=cuda, dtype=torch.int32)
    order = torch.argsort(torch.rand((g, n), generator=gen, device=cuda),
                          dim=-1)
    src = torch.randint(0, s, (g,), generator=gen, device=cuda)
    mask = clip_kernel.nms_rank_mask(over, order, src)
    assert mask.shape == (g, n, w)
    assert torch.equal(mask, nms_ops.nms_rank_mask_plain(over, order, src))
    assert int((mask != 0).sum()) > 0


def test_rank_gather_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = [torch.zeros((2, 5, 1), dtype=torch.int32, device=cuda),
            torch.arange(5, device=cuda)[None].expand(3, 5).contiguous(),
            torch.zeros(3, dtype=torch.int64, device=cuda)]
    clip_kernel.nms_rank_mask(*args)              # well-formed: runs
    before = kernels.launch_counts()
    for i, arg in enumerate(args):
        def spoiled(t):
            return args[:i] + [t] + args[i + 1:]
        with pytest.raises(ValueError, match='CUDA tensor'):
            clip_kernel.nms_rank_mask(*spoiled(arg.cpu()))
        with pytest.raises(TypeError):
            clip_kernel.nms_rank_mask(*spoiled(arg.to(torch.float32)))
        with pytest.raises(ValueError):
            clip_kernel.nms_rank_mask(*spoiled(arg[..., :-1]))
        with pytest.raises(ValueError, match='contiguous'):
            clip_kernel.nms_rank_mask(*spoiled(
                arg.repeat_interleave(2, dim=-1)[..., ::2]))
    assert kernels.launch_counts() == before


def test_indoor_decode_never_waits_for_the_device(cuda, monkeypatch):
    """The SUN RGB-D decode + NMS under ``set_sync_debug_mode('error')``:
    one mask and one scan launch for all samples and classes, and the plain
    path's result bit for bit."""
    cfg = get_preset('imvoxelnet_sunrgbd').model.indoor_head
    rng = np.random.RandomState(8)
    b, sizes = 3, [(80, 80, 32), (40, 40, 16), (20, 20, 8)]
    head = ([], [], [])
    for size in sizes:
        head[0].append(rng.randn(b, *size, 1))
        head[1].append(np.concatenate([np.exp(0.3 * rng.randn(b, *size, 6)),
                                       rng.randn(b, *size, 1)], -1))
        head[2].append(rng.randn(b, *size, cfg.n_classes) - 1.0)
    head = tuple([torch.tensor(x.astype(np.float32), device=cuda)
                  for x in lv] for lv in head)
    valid = torch.tensor(rng.uniform(0, 1, (b, 80, 80, 32)) > 0.5,
                         device=cuda)
    valid[2, :40] = False
    origins = torch.tensor([[0.0, 3.0, -1.0]] * b, device=cuda)
    ivh.indoor_head_get_bboxes(head, valid, origins, cfg)     # warm-up
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = ivh.indoor_head_get_bboxes(head, valid, origins, cfg)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = kernels.launch_counts()
    assert counts['rect_clip'] == 1 and counts['nms_scan'] == 1
    monkeypatch.setattr(nms_ops, 'rotated_nms_presorted',
                        nms_ops.rotated_nms_presorted_plain)
    monkeypatch.setattr(iou_ops, 'rect_intersection_area_pairwise',
                        iou_ops.rect_intersection_area_pairwise_plain)
    ref = ivh.indoor_head_get_bboxes(head, valid, origins, cfg)
    assert kernels.launch_counts() == counts
    assert res['boxes'].shape == (b, cfg.max_out, 7)
    assert int(res['valid'].sum()) > 0
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
    # nuScenes block0: the 4x8 tiling on a 78x39 grid
    ((1, 312, 312, 12, 64), torch.bfloat16),
    ((1, 312, 312, 12, 64), torch.float32),
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
                                       'rect_clip_grad': 0, 'nms_over': 0,
                                       'nms_rank': 0, 'nms_scan': 0,
                                       'conv3x3x3': 0}
    clip_kernel.nms_scan(mask, torch.ones((1, 4), dtype=torch.bool,
                                          device=cuda))
    over = clip_kernel.nms_over_bits(c[None], torch.zeros((1, 4),
                                                          device=cuda), 0.5)
    clip_kernel.nms_rank_mask(
        over, torch.arange(4, device=cuda)[None].expand(3, 4).contiguous(),
        torch.zeros(3, dtype=torch.int64, device=cuda))
    points, proj, hw = _bp_geometry(cuda, 1, 1, 6, 8)
    bp_kernel.backproject_batch_grad(
        torch.zeros((points.shape[1], 1, 4), device=cuda), points, proj, hw,
        6, 8)
    clip_kernel.rect_intersection_area_grad(c, c, torch.zeros(4,
                                                              device=cuda))
    assert kernels.launch_counts() == {'backproject': 0,
                                       'backproject_grad': 1, 'rect_clip': 3,
                                       'rect_clip_grad': 1, 'nms_over': 1,
                                       'nms_rank': 1, 'nms_scan': 1,
                                       'conv3x3x3': 0}


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
    with pytest.raises(ValueError, match='shape mismatch'):
        bp_kernel.backproject_batch_grad(g, points, proj, hw, 0, 8)
    with pytest.raises(ValueError, match='contiguous'):
        bp_kernel.backproject_batch_grad(
            torch.zeros((points.shape[1], 1, 8), device=cuda)[..., ::2],
            points, proj, hw, 6, 8)
    with pytest.raises(TypeError):
        bp_kernel.backproject_batch_grad(g, points, proj, hw.long(), 6, 8)


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
        'over': (lambda corners, areas: clip_kernel.nms_over_bits(
            corners, areas, 0.5), [c, torch.zeros((2, 5), device=dev)]),
    }


@pytest.mark.parametrize('name', ['paired', 'pairwise', 'mask', 'scan',
                                  'over'])
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


# ---------------------------------------------------------------------------
# ScanNet's views, its class-aware axis-aligned NMS, Total3D's layout clip
# ---------------------------------------------------------------------------

def _scannet_geometry(dev, views, name, seed=3):
    cfg = get_preset(name).model
    batch = scannet_batch(1, views, dev, seed=seed)
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size,
                           batch['origins']).reshape(1, -1, 3).contiguous()
    proj = bp.compute_projection(batch['intrinsics'], batch['extrinsics'],
                                 batch['ratios']).contiguous()
    hw = (batch['img_shape'] // 4).to(torch.int32)
    return cfg, points, proj, hw


@pytest.mark.parametrize('views', [20, 50])
@pytest.mark.parametrize('name,dtype', [
    ('imvoxelnet_scannet', torch.float32),          # C = 64, 204,800 voxels
    ('imvoxelnet_scannet', torch.bfloat16),
    ('imvoxelnet_scannet_fast', torch.float32),     # C = 256, 25,600 voxels
    ('imvoxelnet_scannet_fast', torch.bfloat16)])
def test_backproject_kernel_matches_plain_at_the_scannet_views(cuda, views,
                                                              name, dtype):
    """B1 over ScanNet's 20 training and 50 test views at 120x160: the view
    counts exact (up to 50, exact in bfloat16 too), the float32 view sums
    bit for bit (the views added in order, rounded once)."""
    cfg, points, proj, hw = _scannet_geometry(cuda, views, name)
    rng = np.random.RandomState(1)
    feats = torch.tensor(rng.randn(1, views, 120, 160, cfg.fpn_out_channels),
                         dtype=torch.float32, device=cuda).to(dtype)
    acc, cnt = bp_kernel.backproject_batch(feats, points, proj, hw)
    ref_acc, ref_cnt = bp.backproject_batch_plain(feats, points, proj, hw)
    assert torch.equal(cnt, ref_cnt)
    # most voxels seen, by several views but not by all
    assert int(cnt.max()) > 1 and float((cnt > 0).float().mean()) > 0.3
    assert bool((cnt < views).any())
    assert torch.equal(acc, ref_acc)


@pytest.mark.parametrize('name,dtype', [
    ('imvoxelnet_scannet', torch.bfloat16),
    ('imvoxelnet_scannet', torch.float32),
    ('imvoxelnet_scannet_fast', torch.bfloat16),
    ('imvoxelnet_scannet_fast', torch.float32)])
def test_backproject_grad_kernel_matches_plain_at_20_views(cuda, name,
                                                           dtype):
    """B1's backward at ScanNet's 20 training views: bit for bit against the
    plain version run on CPU copies, and a second launch repeats the
    first."""
    cfg, points, proj, hw = _scannet_geometry(cuda, 20, name)
    rng = np.random.RandomState(2)
    g = torch.tensor(rng.randn(points.shape[1], 1, cfg.fpn_out_channels),
                     dtype=torch.float32, device=cuda).to(dtype)
    got = bp_kernel.backproject_batch_grad(g, points, proj, hw, 120, 160)
    again = bp_kernel.backproject_batch_grad(g, points, proj, hw, 120, 160)
    ref = bp.backproject_batch_grad_plain(g.cpu(), points.cpu(), proj.cpu(),
                                          hw.cpu(), 120, 160)
    assert got.shape == (1, 20, 120, 160, cfg.fpn_out_channels)
    assert _same_bits(got.cpu(), ref) and _same_bits(again, got)
    assert bool((got.reshape(20, -1) != 0).any(1).all())


def _aligned_candidates(dev, b, n, seed=5):
    """``b`` samples of ``n`` corner boxes over 18 classes, clustered so
    that they overlap, with scores from a coarse grid (exact ties)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2.0, 2.0, (b, n, 3))
    size = rng.uniform(0.3, 1.5, (b, n, 3))
    boxes = np.concatenate([centers - size / 2, centers + size / 2], -1)
    scores = np.round(rng.uniform(0, 1, (b, n)), 3)
    classes = rng.randint(0, 18, (b, n))
    return (torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.tensor(scores, dtype=torch.float32, device=dev),
            torch.tensor(classes, device=dev))


@pytest.mark.parametrize('b,n', [(1, 3000), (2, 2400), (3, 33)])
def test_aligned_nms_never_waits_for_the_device(cuda, b, n, monkeypatch):
    """The class-aware axis-aligned NMS under ``set_sync_debug_mode(
    'error')``: the plain mask and one scan launch for all samples, equal
    to the plain path (the fixpoint on the IoU)."""
    boxes, scores, classes = _aligned_candidates(cuda, b, n)
    valid = scores > 0.05
    nms_ops.aligned_3d_nms(boxes, scores, classes, valid, 0.15)   # warm-up
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        keep = nms_ops.aligned_3d_nms(boxes, scores, classes, valid, 0.15)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert kernels.launch_counts()['nms_scan'] == 1
    assert kernels.launch_counts()['rect_clip'] == 0
    monkeypatch.setattr(nms_ops, 'aligned_nms_presorted',
                        nms_ops.aligned_nms_presorted_plain)
    ref = nms_ops.aligned_3d_nms(boxes, scores, classes, valid, 0.15)
    assert torch.equal(keep, ref)
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_scannet_decode_never_waits_for_the_device(cuda, monkeypatch):
    """The ScanNet decode at the ``imvoxelnet_scannet`` levels (3 x 1000
    candidates) under ``set_sync_debug_mode('error')``: one scan launch, no
    clip, and the plain path's result bit for bit."""
    cfg = get_preset('imvoxelnet_scannet').model.indoor_head
    rng = np.random.RandomState(9)
    b, sizes = 2, [(80, 80, 32), (40, 40, 16), (20, 20, 8)]
    head = ([], [], [])
    for size in sizes:
        head[0].append(rng.randn(b, *size, 1))
        head[1].append(np.exp(0.3 * rng.randn(b, *size, 6)) * 0.3)
        head[2].append(rng.randn(b, *size, cfg.n_classes) - 1.0)
    head = tuple([torch.tensor(x.astype(np.float32), device=cuda)
                  for x in lv] for lv in head)
    valid = torch.tensor(rng.uniform(0, 1, (b, 80, 80, 32)) > 0.3,
                         device=cuda)
    # the second room seen in one corner only: fewer than max_out kept
    valid[1] = False
    valid[1, 30:40, 30:40, 10:18] = True
    origins = torch.tensor([[0.0, 0.0, 0.5]] * b, device=cuda)
    ivh.indoor_head_get_bboxes(head, valid, origins, cfg)     # warm-up
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = ivh.indoor_head_get_bboxes(head, valid, origins, cfg)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = kernels.launch_counts()
    assert counts['nms_scan'] == 1 and counts['rect_clip'] == 0
    monkeypatch.setattr(nms_ops, 'aligned_nms_presorted',
                        nms_ops.aligned_nms_presorted_plain)
    ref = ivh.indoor_head_get_bboxes(head, valid, origins, cfg)
    assert res['boxes'].shape == (b, cfg.max_out, 7)
    n_kept = res['valid'].sum(1)
    assert int(n_kept[0]) == cfg.max_out and 0 < int(n_kept[1]) < cfg.max_out
    for key in ('valid', 'labels', 'boxes', 'scores'):
        assert torch.equal(res[key], ref[key]), key


def test_rect_clip_function_on_a_layout_batch(cuda):
    """Total3D's layout loss on a batch of 4 through ``RectClipFunction``
    (one paired clip and one backward launch) against autograd of the plain
    clip on the CPU: the loss within 1e-6, the gradients within 1e-5 of
    their max-abs."""
    rng = np.random.RandomState(4)
    gt = np.concatenate([rng.uniform(-0.5, 0.5, (4, 2)),
                         rng.uniform(-1.8, -1.6, (4, 1)),
                         rng.uniform(4.0, 7.0, (4, 3)),
                         rng.uniform(-0.2, 0.2, (4, 1))], -1)
    pred = gt + np.concatenate([0.3 * rng.randn(4, 3), 0.4 * rng.randn(4, 3),
                                0.1 * rng.randn(4, 1)], -1)
    pred[:, 2] += gt[:, 5] / 2
    angles = rng.uniform(-0.3, 0.3, (4, 2))
    gt_angles = angles + 0.1 * rng.randn(4, 2)
    cfg = lh.LayoutHeadConfig()
    out = {}
    for dev in (cuda, torch.device('cpu')):
        a, p = (torch.tensor(x, dtype=torch.float32, device=dev)
                .requires_grad_() for x in (angles, pred))
        kernels.reset_launch_counts()
        loss = lh.layout_head_loss(
            a, p, torch.tensor(gt_angles, dtype=torch.float32, device=dev),
            torch.tensor(gt, dtype=torch.float32, device=dev), cfg)
        (loss['angle_loss'] + loss['layout_loss']).backward()
        out[dev.type] = (loss, a.grad.cpu(), p.grad.cpu(),
                         kernels.launch_counts())
    counts = out['cuda'][3]
    assert counts['rect_clip'] == 1 and counts['rect_clip_grad'] == 1
    assert out['cpu'][3]['rect_clip'] == 0
    for key in ('angle_loss', 'layout_loss'):
        torch.testing.assert_close(out['cuda'][0][key].cpu(),
                                   out['cpu'][0][key], rtol=1e-6, atol=1e-6)
    for got, want in zip(out['cuda'][1:3], out['cpu'][1:3]):
        scale = float(want.abs().max())
        assert scale > 0
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


def test_total3d_forward_with_predicted_extrinsics(cuda):
    """A tiny Total3D model on the card with ``use_predicted_extrinsics``:
    every view takes the extrinsic the head predicts, and the result equals
    the forward given those extrinsics."""
    import dataclasses

    from imvoxelnet_tpu_torch.models import detector
    from imvoxelnet_tpu_torch.models.detector import NeckConfig

    full = get_preset('imvoxelnet_total_sunrgbd').model
    cfg = dataclasses.replace(
        full, n_voxels=(16, 16, 8), voxel_size=(0.4, 0.4, 0.4),
        fpn_out_channels=16, backbone_stage_blocks=(1, 1, 1, 1),
        neck=NeckConfig(kind='imvoxel', channels=(16, 24, 32, 48),
                        out_channels=16, down_layers=(1, 1, 1, 1),
                        up_layers=(1, 1, 1)),
        indoor_head=dataclasses.replace(
            full.indoor_head, voxel_size=(0.4, 0.4, 0.4), nms_pre=64,
            pre_nms_k=32, max_out=16))
    model = detector.build_model(cfg, device=cuda, seed=0)
    with torch.no_grad():
        model.head_2d.angle_mlp[6].weight.mul_(0.01)
        batch = sunrgbd_batch(2, cuda, seed=1, size=(128, 96))
        head, valid, (angles, layout) = model(batch,
                                              use_predicted_extrinsics=True)
        given = dict(batch, extrinsics=lh.predicted_extrinsics(angles)[
            :, None].contiguous())
        head2, valid2, _ = model(given)
    assert torch.equal(valid, valid2)
    for a, b in zip(head, head2):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert angles.shape == (2, 2) and layout.shape == (2, 7)


# ---------------------------------------------------------------------------
# nuScenes: six views at 1600x928, block0 312x312x12, the decode, the DCN
# ---------------------------------------------------------------------------

def _nuscenes_geometry(dev, seed=3):
    """The preset's 1,168,128 voxel centres and the six views'
    projections; features of 232 rows, of which ``valid_hw`` keeps 225 (900
    of the frames' 928 padded rows)."""
    cfg = get_preset('imvoxelnet_nuscenes').model
    ext = torch.tensor(nuscenes_lidar2img(np.random.RandomState(seed))[None],
                       device=dev)
    proj = bp.compute_projection(torch.eye(3, device=dev)[None], ext,
                                 torch.full((1,), 4.0, device=dev))
    points = bp.get_points(cfg.n_voxels, cfg.voxel_size, torch.tensor(
        [NUSCENES_ORIGIN], device=dev)).reshape(1, -1, 3).contiguous()
    hw = torch.tensor([[225, 400]], dtype=torch.int32, device=dev)
    return cfg, points, proj.contiguous(), hw


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backproject_kernel_matches_plain_at_the_nuscenes_views(cuda, dtype):
    """B1 over six views with different projections: counts exact (most
    voxels seen, by one or two views), the float32 view sums bit for bit;
    no voxel reads the 7 padded feature rows, though some project there."""
    cfg, points, proj, hw = _nuscenes_geometry(cuda)
    assert points.shape[1] == 1168128
    rng = np.random.RandomState(1)
    feats = torch.tensor(rng.randn(1, 6, 232, 400, cfg.fpn_out_channels),
                         dtype=torch.float32, device=cuda).to(dtype)
    acc, cnt = bp_kernel.backproject_batch(feats, points, proj, hw)
    ref_acc, ref_cnt = bp.backproject_batch_plain(feats, points, proj, hw)
    assert torch.equal(cnt, ref_cnt)
    assert torch.equal(acc, ref_acc)
    assert int(cnt.max()) == 2 and float((cnt > 0).float().mean()) > 0.8
    idx, valid = bp._view_indices(points, proj, hw, 232, 400)
    assert int((idx[valid] // 400).max()) == 224
    _, uncropped = bp._view_indices(points, proj, torch.tensor(
        [[232, 400]], dtype=torch.int32, device=cuda), 232, 400)
    assert int(uncropped.sum()) > int(valid.sum())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_backproject_grad_kernel_matches_plain_at_the_nuscenes_views(cuda,
                                                                     dtype):
    """B1's backward at the six views: bit for bit against the plain version
    run on CPU copies, a second launch repeats the first, every view gets a
    gradient and the cropped rows none."""
    cfg, points, proj, hw = _nuscenes_geometry(cuda)
    rng = np.random.RandomState(2)
    g = torch.tensor(rng.randn(points.shape[1], 1, cfg.fpn_out_channels),
                     dtype=torch.float32, device=cuda).to(dtype)
    got = bp_kernel.backproject_batch_grad(g, points, proj, hw, 232, 400)
    again = bp_kernel.backproject_batch_grad(g, points, proj, hw, 232, 400)
    ref = bp.backproject_batch_grad_plain(g.cpu(), points.cpu(), proj.cpu(),
                                          hw.cpu(), 232, 400)
    assert got.shape == (1, 6, 232, 400, cfg.fpn_out_channels)
    assert _same_bits(got.cpu(), ref) and _same_bits(again, got)
    assert bool((got.reshape(6, -1) != 0).any(1).all())
    assert not got[:, :, 225:].any()


def test_nuscenes_decode_kernels_match_plain(cuda, monkeypatch):
    """The decode of the 156x156 map (a stable top-k of 1,000 of 48,672
    anchors, rotated NMS at 0.2, 500 out): one mask and one scan launch,
    no wait for the device, the plain path's result bit for bit; the mask
    of the 1,000 candidates and its scan against their plain versions and
    the fixpoint."""
    cfg = get_preset('imvoxelnet_nuscenes').model.anchor_head
    rng = np.random.RandomState(4)
    a = cfg.num_anchors
    logits = rng.permutation(np.linspace(-4.0, 4.0, 156 * 156 * a))
    outs = tuple(torch.tensor(o.astype(np.float32), device=cuda) for o in (
        logits.reshape(1, 156, 156, a), rng.randn(1, 156, 156, a * 7) * 0.3,
        rng.randn(1, 156, 156, a * 2)))
    a3d.anchor3d_head_get_bboxes(outs, cfg)      # builds, caches the anchors
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = a3d.anchor3d_head_get_bboxes(outs, cfg)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = kernels.launch_counts()
    assert counts['rect_clip'] == 1 and counts['nms_scan'] == 1

    anchors = a3d.head_anchors((156, 156), cfg, device=cuda)
    _, ids = nms_ops.top_k(torch.sigmoid(outs[0].reshape(1, -1)),
                           cfg.nms_pre)
    boxes = coder.decode(anchors[ids[0]],
                             outs[1].reshape(-1, 7)[ids[0]])[None]
    bev = box_ops.bev(boxes)
    corners = box_ops.bev_corners(bev).contiguous()
    areas = (bev[..., 2] * bev[..., 3]).contiguous()
    mask = clip_kernel.nms_dominance_mask(corners, areas, cfg.iou_thr)
    assert mask.shape == (1, 1000, 32)
    assert torch.equal(mask, iou_ops.nms_dominance_mask_plain(
        corners, areas, cfg.iou_thr))
    valid = torch.ones((1, 1000), dtype=torch.bool, device=cuda)
    keep = clip_kernel.nms_scan(mask, valid)
    assert torch.equal(keep, nms_ops.nms_scan_plain(mask, valid))
    iou = iou_ops.iou_from_overlaps(
        iou_ops.rect_intersection_area_pairwise_plain(corners, corners),
        areas, areas)
    assert torch.equal(keep, nms_ops.greedy_nms_from_iou_batched(
        iou, areas, valid, cfg.iou_thr, presorted=True))
    assert 0 < int(keep.sum()) < 1000

    monkeypatch.setattr(nms_ops, 'rotated_nms_presorted',
                        nms_ops.rotated_nms_presorted_plain)
    ref = a3d.anchor3d_head_get_bboxes(outs, cfg)
    assert int(res['valid'].sum()) == min(int(keep.sum()), cfg.max_out)
    for key in ('valid', 'labels', 'boxes', 'scores'):
        assert torch.equal(res[key], ref[key]), key


def test_deform_conv_on_the_card_matches_the_cpu(cuda):
    """The DCN (stride 1 and 2, nonzero offsets of a few pixels, some taps
    off the map) on the card against the same module on the CPU at
    float32: forward and the gradients of x, the kernel and
    ``conv_offset``."""
    from imvoxelnet_tpu_torch.models.dcn import DeformConv2d
    from imvoxelnet_tpu_torch.tools.profile_forward import dcn_offsets

    rng = np.random.RandomState(7)
    for stride in (1, 2):
        mod = DeformConv2d(32, 24, stride)
        dcn_offsets(mod, seed=stride)
        x0 = torch.tensor(rng.randn(3, 32, 20, 30), dtype=torch.float32)
        outs = {}
        for dev in ('cpu', cuda):
            m = mod.to(dev)
            x = x0.to(dev).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            m.zero_grad()
            y = m(x)
            r = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
            (y * r).sum().backward()
            outs[str(dev)] = [t.detach().cpu() for t in (
                y, x.grad, m.weight.grad, m.conv_offset.weight.grad,
                m.conv_offset.bias.grad)]
        with torch.no_grad():
            offset, _ = mod.to('cpu').offsets_and_masks(x0)
        assert 1.0 < float(offset.abs().max()) < 5.0
        for name, got, want in zip(('y', 'dx', 'dw', 'doffset_w',
                                    'doffset_b'), outs['cuda'],
                                   outs['cpu']):
            scale = want.abs().max().item()
            assert scale > 0, name
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * scale,
                                       msg=lambda m: f'{name}: {m}')


# --------------------------------------------------------------------------
# the evaluation path
# --------------------------------------------------------------------------

def _eval_boxes(rng, n):
    return np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                           rng.uniform(-0.3, 0.3, (n, 1)),
                           rng.uniform(0.4, 2.0, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_bbox_overlaps_3d_on_the_card_equals_the_plain_clip(cuda, mode):
    """The pairwise entry (one launch, leading dims as groups) against the
    plain clip on the CPU: the areas bit for bit, so the IoUs within 1e-6
    (the float32 divisions of two devices)."""
    rng = np.random.RandomState(0)
    b1 = torch.from_numpy(np.stack([_eval_boxes(rng, 37)] * 2))
    b2 = torch.from_numpy(np.stack([_eval_boxes(rng, 23), _eval_boxes(rng, 23)]))
    clip_kernel.launches = 0
    got = iou_ops.bbox_overlaps_3d(b1.to(cuda), b2.to(cuda), mode)
    assert clip_kernel.launches == 1
    ref = iou_ops.bbox_overlaps_3d(b1, b2, mode)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-6)
    assert 0.1 < float((ref > 0).float().mean()) < 1


def test_indoor_per_image_iou_slices_equal_per_class_calls_on_the_card(cuda):
    from imvoxelnet_tpu_torch.eval import indoor_eval
    rng = np.random.RandomState(1)
    det, gt = _eval_boxes(rng, 41), _eval_boxes(rng, 17)
    det_labels, gt_labels = rng.randint(0, 4, 41), rng.randint(0, 4, 17)
    [whole] = indoor_eval.image_ious([dict(boxes=gt)], [dict(boxes=det)],
                                     'cuda')
    for c in range(4):
        m, g = det_labels == c, gt_labels == c
        per_class = indoor_eval._box_iou_3d(det[m], gt[g], 'cuda')
        np.testing.assert_array_equal(whole[m][:, g].view(np.int32),
                                      per_class.view(np.int32))


@pytest.fixture
def kitti_split(tmp_path):
    from imvoxelnet_tpu_torch.utils import synthetic_splits
    root = str(tmp_path / 'kitti')
    return root, synthetic_splits.kitti_split(root, 3, seed=1)


def test_loader_pinned_batches_reach_the_card_equal(cuda, kitti_split):
    """The loader's pinned bfloat16 batches, copied ahead on a side stream
    by ``device_prefetch``, equal the unpinned CPU batches."""
    from imvoxelnet_tpu_torch.data import loader as loader_lib
    from imvoxelnet_tpu_torch.eval import runner
    preset = get_preset('imvoxelnet_kitti')
    kw = dict(num_workers=2, batch_size=2)
    _, pinned = runner.build_val_dataset(preset, 'imvoxelnet_kitti',
                                         *kitti_split, device='cuda', **kw)
    _, plain = runner.build_val_dataset(preset, 'imvoxelnet_kitti',
                                        *kitti_split, device='cpu', **kw)
    pinned.images_dtype = plain.images_dtype = torch.bfloat16
    ref = list(plain.epoch(0))
    got = list(loader_lib.device_prefetch(pinned.epoch(0), 'cuda'))
    torch.cuda.synchronize()
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in r:
            assert g[key].is_cuda and g[key].dtype == r[key].dtype
            assert torch.equal(g[key].cpu(), r[key]), key


def test_test_tool_runs_a_split_on_the_card(cuda, kitti_split, tmp_path):
    """``tools/test.py`` on 2 frames at full width (b=2, bfloat16) with a
    written checkpoint: finite KITTI metrics, one forward's launches per
    batch."""
    from imvoxelnet_tpu_torch import kernels as kernels_lib
    from imvoxelnet_tpu_torch.models.detector import build_model
    from imvoxelnet_tpu_torch.tools import test as test_tool
    from imvoxelnet_tpu_torch.utils import synthetic_splits
    root = str(tmp_path / 'two')
    ann = synthetic_splits.kitti_split(root, 2, seed=2)
    model = build_model(get_preset('imvoxelnet_kitti').model, 'cpu', seed=3)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    pth = str(tmp_path / 'w.pth')
    torch.save({'state_dict': model.state_dict()}, pth)
    kernels_lib.reset_launch_counts()
    summary = test_tool.main(['imvoxelnet_kitti', '--data-root', root,
                              '--ann-file', ann, '--torch-checkpoint', pth,
                              '--batch-size', '2', '--num-workers', '2',
                              '--override', 'model.compute_dtype=bfloat16'])
    counts = kernels_lib.launch_counts()
    assert summary['n_samples'] == 2 and summary['n_batches'] == 1
    assert counts['backproject'] == 1 and counts['conv3x3x3'] == 2
    assert counts['rect_clip'] == 1 and counts['nms_scan'] == 1
    assert all(np.isfinite(v) for v in summary['metrics'].values())
    assert 'KITTI/Car_3D_moderate' in summary['metrics']


def _train_args(split, work, epochs, *extra):
    """``tools/train.py`` on imvoxelnet_kitti at full width, b=2 bfloat16,
    a 4-frame split once an epoch: 2 steps an epoch."""
    return ['imvoxelnet_kitti', '--data-root', split[0], '--ann-file',
            split[1], '--work-dir', work, '--epochs', str(epochs),
            '--batch-size', '2', '--num-workers', '2', '--log-interval', '1',
            '--override', 'model.compute_dtype=bfloat16', '--override',
            'data.repeat_times=1', *extra]


@pytest.fixture
def kitti_train_split(tmp_path):
    from imvoxelnet_tpu_torch.utils import synthetic_splits
    root = str(tmp_path / 'kitti_train')
    return root, synthetic_splits.kitti_split(root, 4, seed=4)


def test_train_tool_runs_two_steps_on_the_card(cuda, kitti_train_split,
                                               tmp_path):
    """Two steps and a validation of the 4 frames at b=4: launches B1 1,
    its backward 1 and B3 4 a step, B1 1, B3 2, mask 1 and scan 1 the
    validation batch; finite losses; a ``latest.pth``."""
    import os
    from imvoxelnet_tpu_torch import kernels as kernels_lib
    from imvoxelnet_tpu_torch.tools import train as train_tool
    kernels_lib.reset_launch_counts()
    summary = train_tool.main(_train_args(
        kitti_train_split, str(tmp_path / 'w'), 1, '--val-ann-file',
        kitti_train_split[1], '--val-batch-size', '4'))
    counts = kernels_lib.launch_counts()
    assert summary['steps_per_epoch'] == 2 and summary['step'] == 2
    assert counts == dict(backproject=2 + 1, backproject_grad=2,
                          conv3x3x3=2 * 4 + 2, rect_clip=1,
                          rect_clip_grad=0, nms_over=0, nms_rank=0,
                          nms_scan=1)
    assert all(np.isfinite(line['loss']) for line in summary['train'])
    assert len(summary['val']) == 1 and os.path.exists(summary['latest'])


def test_train_tool_resume_equals_the_straight_run_on_the_card(
        cuda, kitti_train_split, tmp_path, monkeypatch):
    """``--epochs 1`` then ``--epochs 2`` against ``--epochs 2`` under
    ``cudnn.deterministic``: every tensor of the train state bit for
    bit."""
    from imvoxelnet_tpu_torch.tools import train as train_tool
    from imvoxelnet_tpu_torch.utils import checkpoint as ckpt_lib
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    straight = train_tool.main(_train_args(kitti_train_split,
                                           str(tmp_path / 's'), 2))
    train_tool.main(_train_args(kitti_train_split, str(tmp_path / 'r'), 1))
    resumed = train_tool.main(_train_args(kitti_train_split,
                                          str(tmp_path / 'r'), 2))
    assert resumed['start_epoch'] == 1
    assert [line['loss'] for line in resumed['train']] == [
        line['loss'] for line in straight['train'][2:]]
    a, b = (ckpt_lib.load_checkpoint(s['latest'])
            for s in (straight, resumed))
    assert a['step'] == b['step'] == 4 and a['scheduler'] == b['scheduler']
    for key, val in a['state_dict'].items():
        assert torch.equal(b['state_dict'][key], val), key
    for i, state in a['optimizer']['state'].items():
        for key, val in state.items():
            assert torch.equal(b['optimizer']['state'][i][key], val), (i, key)


# --------------------------------------------------------------------------
# the exact NMS, the axis-aligned BEV NMS, GIoU-3D and the serving export
# --------------------------------------------------------------------------

def _tied_candidates(dev, b, n, n_classes, seed=0):
    """Overlapping BEV boxes with scores on a grid of 1/8 (exact ties)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 0.6 * np.sqrt(n), (b, n, 2))
    wh = rng.uniform(0.5, 2.0, (b, n, 2))
    yaw = rng.uniform(-np.pi, np.pi, (b, n, 1))
    bev = np.concatenate([xy, wh, yaw], -1)
    boxes = np.concatenate([xy, rng.uniform(-1, 0, (b, n, 1)), wh,
                            rng.uniform(0.5, 2, (b, n, 1)), yaw], -1)
    scores = rng.randint(0, 9, (b, n, n_classes)) / 8
    return [torch.tensor(x.astype(np.float32), device=dev)
            for x in (boxes, bev, scores)]


@pytest.mark.parametrize('use_rotate_nms', [True, False])
@pytest.mark.parametrize('b,n', [(2, 300), (3, 97)])
def test_exact_nms_never_waits_and_equals_the_plain_path(
        cuda, b, n, use_rotate_nms, monkeypatch):
    """``multiclass_nms_3d_exact`` on the card: the over-threshold bits of
    all samples (one launch of the clip's exact-NMS entry when rotated, the
    packed plain IoU otherwise), one rank gather and one scan for all
    samples and classes, under ``set_sync_debug_mode('error')``, equal to
    the plain path (the fixpoint on the plain IoU) with exact score
    ties."""
    boxes, bev, scores = _tied_candidates(cuda, b, n, 4)
    valid = torch.ones((b, n), dtype=torch.bool, device=cuda)
    valid[:, ::7] = False
    kw = dict(score_thr=0.2, max_num=200, iou_thr=0.15,
              use_rotate_nms=use_rotate_nms)
    nms_ops.multiclass_nms_3d_exact(boxes, bev, scores, valid, **kw)
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = nms_ops.multiclass_nms_3d_exact(boxes, bev, scores, valid, **kw)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = kernels.launch_counts()
    assert counts['nms_over'] == int(use_rotate_nms)
    assert counts['nms_rank'] == counts['nms_scan'] == 1
    assert counts['rect_clip'] == 0
    monkeypatch.setattr(nms_ops, 'nms_in_rank_order',
                        nms_ops.nms_in_rank_order_plain)
    monkeypatch.setattr(nms_ops, 'rotated_nms_bev',
                        nms_ops.rotated_nms_bev_plain)
    monkeypatch.setattr(iou_ops, 'rect_intersection_area_pairwise',
                        iou_ops.rect_intersection_area_pairwise_plain)
    ref = nms_ops.multiclass_nms_3d_exact(boxes, bev, scores, valid, **kw)
    for key in ('boxes', 'scores', 'labels', 'valid', 'dir_scores'):
        assert torch.equal(res[key], ref[key]), key
    assert 0 < int(res['valid'].sum())


def test_normal_nms_decode_equals_the_plain_path(cuda, monkeypatch):
    """``use_rotate_nms=False`` at the KITTI head: the axis-aligned mask
    and one scan, no clip, equal to the fixpoint."""
    cfg = get_preset('imvoxelnet_kitti').model.anchor_head
    import dataclasses
    cfg = dataclasses.replace(cfg, use_rotate_nms=False)
    rng = np.random.RandomState(4)
    b, h, w, a = 2, 31, 27, cfg.num_anchors
    head = (torch.tensor(rng.randn(b, h, w, a).astype(np.float32),
                         device=cuda),
            torch.tensor(0.3 * rng.randn(b, h, w, a * 7).astype(np.float32),
                         device=cuda),
            torch.tensor(rng.randn(b, h, w, a * 2).astype(np.float32),
                         device=cuda))
    a3d.anchor3d_head_get_bboxes(head, cfg)
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = a3d.anchor3d_head_get_bboxes(head, cfg)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = kernels.launch_counts()
    assert counts['nms_scan'] == 1 and counts['rect_clip'] == 0
    monkeypatch.setattr(nms_ops, 'normal_nms_presorted',
                        nms_ops.normal_nms_presorted_plain)
    ref = a3d.anchor3d_head_get_bboxes(head, cfg)
    for key in ('boxes', 'scores', 'labels', 'valid'):
        assert torch.equal(res[key], ref[key]), key
    assert int(res['valid'].sum()) > 0


def test_giou_3d_loss_kernel_path_matches_plain(cuda, monkeypatch):
    """``giou_3d_loss`` through the clip's paired entry and its backward
    kernel against autograd of the plain clip: the loss 1e-5 relative,
    the gradients 1e-4 of their max-abs."""
    rng = np.random.RandomState(5)
    n = 4099
    target = np.concatenate([rng.uniform(-2, 2, (n, 3)),
                             rng.uniform(0.3, 2, (n, 3)),
                             rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    pred = target + np.concatenate([0.2 * rng.randn(n, 3),
                                    0.1 * rng.randn(n, 3),
                                    0.3 * rng.randn(n, 1)], -1)
    pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.05
    pred[:40, :2] += 10.0
    weight = torch.tensor(rng.uniform(size=n).astype(np.float32),
                          device=cuda)

    def run():
        p = torch.tensor(pred.astype(np.float32), device=cuda,
                         requires_grad=True)
        t = torch.tensor(target.astype(np.float32), device=cuda,
                         requires_grad=True)
        loss = losses.giou_3d_loss(p, t, weight, avg_factor=17.0)
        return (loss.detach(),) + torch.autograd.grad(loss, (p, t))
    kernels.reset_launch_counts()
    got = run()
    counts = kernels.launch_counts()
    assert counts['rect_clip'] == 1 and counts['rect_clip_grad'] == 1
    monkeypatch.setattr(iou_ops, 'rect_intersection_area',
                        iou_ops.rect_intersection_area_plain)
    ref = run()
    assert abs(float(got[0] - ref[0])) <= 1e-5 * abs(float(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_serving_export_round_trip_on_the_card(cuda, tmp_path):
    """The shallow ``tiny_kitti_test`` exported from the card with a
    symbolic batch: the kernels are ``torch.ops.imvx`` nodes (B1, the NMS
    mask and the scan; its 40x32 grid is below B3's gate, which
    ``chip_smoke.py`` phase 12 covers at ``imvoxelnet_kitti``), the loaded
    program launches them as the eager forward does, and gives its
    detections at b=1 and b=3."""
    import collections

    from imvoxelnet_tpu_torch.configs.presets import apply_overrides
    from imvoxelnet_tpu_torch.eval import runner
    from imvoxelnet_tpu_torch.models.detector import build_model
    from imvoxelnet_tpu_torch.utils import export as export_lib

    cfg = apply_overrides(get_preset('tiny_kitti_test'),
                          ['model.backbone_stage_blocks=(1,1,1,1)']).model
    model = build_model(cfg, device='cuda', seed=0)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()
    exported = export_lib.export_serving(
        cfg, model, export_lib.example_batch(2, 1, 96, 320), batch_size=None)
    nodes = collections.Counter(str(n.target) for n in exported.graph.nodes
                                if str(n.target).startswith('imvx'))
    assert nodes == {'imvx.backproject.default': 1,
                     'imvx.nms_mask.default': 1, 'imvx.nms_scan.default': 1}
    path = str(tmp_path / 'kitti.pt2')
    export_lib.save_exported(exported, path)
    program = export_lib.load_exported(path).module()
    for b in (1, 3):
        batch = export_lib.example_batch(b, 1, 96, 320, seed=b)
        kernels.reset_launch_counts()
        with torch.no_grad():
            got = program(model.state_dict(), batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        want = runner.forward(model, cfg, batch)
        torch.cuda.synchronize()
        assert counts == kernels.launch_counts() == dict(
            backproject=1, backproject_grad=0, conv3x3x3=0, rect_clip=1,
            rect_clip_grad=0, nms_over=0, nms_rank=0, nms_scan=1)
        for key, val in want.items():
            assert torch.equal(got[key], val), key
