"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA device.  Small and ragged
shapes here; ``chip_smoke.py`` covers the KITTI main-path shapes.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from imvoxelnet_tpu_torch import kernels
from imvoxelnet_tpu_torch.kernels import backproject as bp_kernel
from imvoxelnet_tpu_torch.kernels import build
from imvoxelnet_tpu_torch.kernels import conv3x3x3 as conv_kernel
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.ops import backproject as bp
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import conv3z
from imvoxelnet_tpu_torch.ops import iou as iou_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


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
    k = torch.tensor([[20.0, 0, 8.037], [0, 20.0, 5.971], [0, 0, 1]],
                     device=cuda)
    proj = torch.zeros((b, v, 3, 4), device=cuda)
    for s in range(b):
        for i in range(v):
            e = torch.eye(4, device=cuda)[:3]
            e[0, 3] = 0.2 * i + 0.05 * s
            proj[s, i] = k @ e
    origins = torch.tensor([[0.0137, -0.0213, 2.0071]] * b, device=cuda)
    points = bp.get_points((7, 6, 5), (0.3, 0.3, 0.3), origins).reshape(
        b, -1, 3).contiguous()
    hw = torch.tensor([valid_hw or (hf, wf)] * b, dtype=torch.int32,
                      device=cuda)
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


def test_wrappers_count_launches(cuda):
    kernels.reset_launch_counts()
    c = torch.zeros((4, 4, 2), device=cuda)
    clip_kernel.rect_intersection_area(c, c)
    clip_kernel.rect_intersection_area(c, c)
    assert kernels.launch_counts() == {'backproject': 0, 'rect_clip': 2,
                                       'conv3x3x3': 0}
