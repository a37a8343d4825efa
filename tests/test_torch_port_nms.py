"""The batched decode + NMS path of the PyTorch port against the JAX package.

On the CPU the port takes the plain versions of the clip kernel's pairwise
and fused-NMS entries and of the scan kernel (``ops/iou.py``, ``ops/nms.py``);
the JAX side ``vmap``s its per-sample functions.  Inputs come from numpy
seeds.  Gathers, ranks and masks must agree exactly; decoded boxes and
scores to the cross-framework tolerance (``exp`` and ``sigmoid`` round
differently).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.models.heads import anchor3d_head as jax_a3d
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu.ops import nms as jax_nms

from imvoxelnet_tpu_torch import kernels
from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.core import anchors as anchor_gen
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.models.heads import anchor3d_head as a3d
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import iou as iou_ops
from imvoxelnet_tpu_torch.ops import nms

TOL = 2e-3


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# --------------------------------------------------------------------------
# the head's batched decode
# --------------------------------------------------------------------------

def _head_outs(b=3, h=9, w=11, seed=0):
    """Head maps whose samples differ in how many anchors pass the score
    threshold (most, a handful, none) and hold exact score ties among the
    top candidates.  Logits are distinct multiples of 0.01 apart from the
    ties, so no near-tie can rank differently in the two frameworks."""
    cfg = presets.get_preset('tiny_kitti_test').model.anchor_head
    rng = np.random.RandomState(seed)
    a = cfg.num_anchors
    n = h * w * a * cfg.num_classes
    cls = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.float32)
    # score_thr 0.1 is logit -2.1972: all of sample 0 pass, the top 7 of
    # sample 1 (its ranks 6 and 7 lie 0.015 either side), none of sample 2
    top = (n - 1) * 0.01
    cls = cls * 0.01 - np.array([top / 2, top + 2.1972 - 0.055,
                                 top + 3.0])[:b, None]
    order = np.argsort(-cls, axis=1)
    for i in range(b):       # ranks 1 = 2 and 4 = 5 = 6 tie exactly
        cls[i, order[i, 2]] = cls[i, order[i, 1]]
        cls[i, order[i, 5]] = cls[i, order[i, 4]]
        cls[i, order[i, 6]] = cls[i, order[i, 4]]
    reg = rng.randn(b, h, w, a * cfg.box_code_size) * 0.3
    dirs = rng.randn(b, h, w, a * 2)
    outs = (cls.reshape(b, h, w, a * cfg.num_classes), reg, dirs)
    return tuple(o.astype(np.float32) for o in outs)


def test_batched_get_bboxes_matches_jax():
    outs = _head_outs()
    jcfg = jax_presets.get_preset('tiny_kitti_test').model.anchor_head
    cfg = presets.get_preset('tiny_kitti_test').model.anchor_head
    ref = jax_a3d.anchor3d_head_get_bboxes(
        tuple(jnp.asarray(o) for o in outs), jcfg)
    got = a3d.anchor3d_head_get_bboxes(
        tuple(torch.from_numpy(o) for o in outs), cfg)
    n_det = np.asarray(ref['valid']).sum(1)
    assert n_det[0] == cfg.max_out and 0 < n_det[1] < n_det[0]
    assert n_det[2] == 0
    np.testing.assert_array_equal(got['valid'].numpy(),
                                  np.asarray(ref['valid']))
    np.testing.assert_array_equal(got['labels'].numpy(),
                                  np.asarray(ref['labels']))
    assert got['labels'].dtype == torch.int32
    for key in ('boxes', 'scores'):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=TOL, atol=TOL)


def test_batched_get_bboxes_equals_one_sample_at_a_time():
    """Batching changes how the path runs, not one element of its result."""
    outs = tuple(torch.from_numpy(o) for o in _head_outs(seed=1))
    cfg = presets.get_preset('tiny_kitti_test').model.anchor_head
    got = a3d.anchor3d_head_get_bboxes(outs, cfg)
    for i in range(outs[0].shape[0]):
        one = a3d.anchor3d_head_get_bboxes(
            tuple(o[i:i + 1] for o in outs), cfg)
        for key, val in got.items():
            assert torch.equal(val[i], one[key][0]), (i, key)


def test_head_anchors_are_cached_per_size_config_and_device():
    cfg = presets.get_preset('tiny_kitti_test').model.anchor_head
    first = a3d.head_anchors((5, 6), cfg)
    assert a3d.head_anchors([5, 6], cfg) is first
    assert a3d.head_anchors((6, 5), cfg) is not first
    assert torch.equal(first, anchor_gen.grid_anchors(
        (5, 6), cfg.anchor_ranges, cfg.anchor_sizes, cfg.anchor_rotations))


# --------------------------------------------------------------------------
# batched multiclass NMS
# --------------------------------------------------------------------------

def _nms_inputs(seed, b=3, n=40, n_classes=3):
    """Car-sized boxes in a 12 m square, so that many overlap; exact score
    ties; a different share of valid rows per sample."""
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([
        rng.uniform(0, 12, (b, n, 2)), rng.uniform(-1.5, -1.0, (b, n, 1)),
        rng.uniform(1.4, 1.8, (b, n, 1)), rng.uniform(3.4, 4.4, (b, n, 1)),
        rng.uniform(1.4, 1.7, (b, n, 1)),
        rng.uniform(-np.pi, np.pi, (b, n, 1))], axis=2).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n, n_classes)).astype(np.float32)
    scores[:, 5] = scores[:, 3]
    scores[:, 9] = scores[:, 3]
    valid = rng.uniform(0, 1, (b, n)) > np.array([0.1, 0.5, 0.9])[:b, None]
    dirs = (rng.uniform(0, 1, (b, n)) > 0.5).astype(np.float32)
    return boxes, scores, valid, dirs


@pytest.mark.parametrize('seed,iou_thr,max_num', [
    (0, 0.01, 48), (1, 0.3, 48), (2, 0.1, 100)])
def test_batched_multiclass_nms_3d_matches_vmap_of_jax(seed, iou_thr,
                                                       max_num):
    boxes, scores, valid, dirs = _nms_inputs(seed)
    kw = dict(score_thr=0.2, max_num=max_num, iou_thr=iou_thr, pre_nms_k=24)
    ref = jax.vmap(lambda bx, sc, va, di: jax_nms.multiclass_nms_3d(
        bx, jax_boxes.bev(bx), sc, va, mlvl_dir_scores=di, **kw))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
            jnp.asarray(dirs))
    tb = torch.from_numpy(boxes)
    got = nms.multiclass_nms_3d(
        tb, box_ops.bev(tb), torch.from_numpy(scores),
        torch.from_numpy(valid), mlvl_dir_scores=torch.from_numpy(dirs),
        **kw)
    n_det = got['valid'].sum(1)
    assert n_det[0] > n_det[2] > 0            # samples differ, NMS bites
    candidates = np.minimum(((scores > 0.2) & valid[..., None]).sum(1), 24)
    assert int(n_det.sum()) < candidates.sum()
    for key in ('valid', 'labels', 'dir_scores', 'boxes', 'scores'):
        assert got[key].shape[:2] == (3, max_num)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


def test_multiclass_nms_3d_without_dir_scores_and_unbatched():
    boxes, scores, valid, _ = _nms_inputs(3)
    tb = torch.from_numpy(boxes)
    kw = dict(score_thr=0.2, max_num=30, iou_thr=0.1, pre_nms_k=16)
    got = nms.multiclass_nms_3d(tb, box_ops.bev(tb), torch.from_numpy(scores),
                                torch.from_numpy(valid), **kw)
    assert not got['dir_scores'].any()
    for i in range(3):
        one = nms.multiclass_nms_3d(
            tb[i], box_ops.bev(tb[i]), torch.from_numpy(scores[i]),
            torch.from_numpy(valid[i]), **kw)
        for key, val in got.items():
            assert torch.equal(val[i], one[key]), (i, key)


# --------------------------------------------------------------------------
# the greedy scan and the mask words
# --------------------------------------------------------------------------

def _greedy_python(dominates, valid):
    """The scan kernel's algorithm, one row at a time."""
    n = len(valid)
    removed = [not v for v in valid]
    for i in range(n):
        if not removed[i]:
            for j in range(i + 1, n):
                removed[j] = removed[j] or bool(dominates[i][j])
    return [not r for r in removed]


def _scan_three_ways(dominates, valid):
    """Python loop, the scan's plain version on packed words, and the
    fixpoint loop on the same dominance matrix."""
    n = valid.shape[-1]
    dominates = dominates & np.triu(np.ones((n, n), bool), 1)
    want = np.array([_greedy_python(d, v) for d, v in zip(dominates, valid)])
    td, tv = torch.from_numpy(dominates), torch.from_numpy(valid)
    scanned = nms.nms_scan_plain(iou_ops.pack_mask(td), tv)
    fixpoint = nms.greedy_nms_from_iou_batched(
        td.float(), torch.zeros(valid.shape), tv, 0.5, presorted=True)
    np.testing.assert_array_equal(scanned.numpy(), want)
    np.testing.assert_array_equal(fixpoint.numpy(), want)
    return want


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 70), density=st.floats(0.0, 0.6),
       p_valid=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 16))
def test_greedy_scan_equals_fixpoint(n, density, p_valid, seed):
    rng = np.random.RandomState(seed)
    _scan_three_ways(rng.uniform(0, 1, (2, n, n)) < density,
                     rng.uniform(0, 1, (2, n)) < p_valid)


@pytest.mark.parametrize('case', ['all_invalid', 'all_valid', 'chain',
                                  'first_takes_all'])
def test_greedy_scan_edge_cases(case):
    n = 37
    dominates = np.zeros((1, n, n), bool)
    valid = np.ones((1, n), bool)
    if case == 'all_invalid':
        dominates[:] = True
        valid[:] = False
        want = np.zeros(n, bool)
    elif case == 'all_valid':
        want = np.ones(n, bool)
    elif case == 'chain':   # i suppresses i + 1 only: the fixpoint's longest
        idx = np.arange(n - 1)
        dominates[0, idx, idx + 1] = True
        want = np.arange(n) % 2 == 0
    else:
        dominates[0, 0, :] = True
        want = np.arange(n) == 0
    np.testing.assert_array_equal(_scan_three_ways(dominates, valid)[0], want)


@pytest.mark.parametrize('n', [1, 31, 32, 33, 64, 100])
def test_mask_pack_and_unpack_are_inverses(n):
    rng = np.random.RandomState(n)
    bits = rng.uniform(0, 1, (2, 3, n)) < 0.5
    bits[0, 0] = True                     # every bit, the sign bit included
    words = iou_ops.pack_mask(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    assert words.shape == (2, 3, clip_kernel.mask_words(n))
    want = np.packbits(np.pad(bits, ((0, 0), (0, 0), (0, -n % 32))), axis=-1,
                       bitorder='little').view('<u4')
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    back = iou_ops.unpack_mask(words, n)
    assert back.dtype == torch.bool
    np.testing.assert_array_equal(back.numpy(), bits)
    assert torch.equal(iou_ops.pack_mask(back), words)


# --------------------------------------------------------------------------
# the clip's pairwise and fused-NMS entries, plain versions
# --------------------------------------------------------------------------

def _group_corners(g, n, seed):
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform(-4, 4, (g, n, 2)),
                            rng.uniform(0.3, 3.0, (g, n, 2)),
                            rng.uniform(-np.pi, np.pi, (g, n, 1))],
                           axis=-1).astype(np.float32)
    return boxes, np.asarray(jax_boxes.bev_corners(jnp.asarray(boxes)))


@pytest.mark.parametrize('g,n,m', [(1, 1, 1), (3, 17, 9), (2, 33, 40)])
def test_pairwise_plain_bit_identical_to_jnp_on_broadcast_inputs(g, n, m):
    _, c1 = _group_corners(g, n, 0)
    _, c2 = _group_corners(g, m, 1)
    ref = jax_iou._rect_intersection_area_jnp(
        jnp.asarray(c1[:, :, None]), jnp.asarray(c2[:, None, :]))
    got = iou_ops.rect_intersection_area_pairwise_plain(
        torch.from_numpy(c1), torch.from_numpy(c2))
    assert got.shape == (g, n, m)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    # the dispatching op takes the same route for CPU tensors, and lets a
    # group axis broadcast
    same = iou_ops.rect_intersection_area_pairwise(
        torch.from_numpy(c1), torch.from_numpy(c2[:1]))
    np.testing.assert_array_equal(_bits(same[0].numpy()), _bits(ref[0]))
    assert same.shape == (g, n, m)


def test_rotated_iou_bev_with_leading_dims_matches_jax():
    b1, _ = _group_corners(6, 9, 2)
    b2, _ = _group_corners(3, 7, 3)
    b1 = b1.reshape(2, 3, 9, 5)
    got = iou_ops.rotated_iou_bev(torch.from_numpy(b1), torch.from_numpy(b2))
    ref = jax_iou.rotated_iou_bev(jnp.asarray(b1), jnp.asarray(b2))
    assert got.shape == (2, 3, 9, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('n,iou_thr', [(33, 0.01), (70, 0.3)])
def test_dominance_mask_plain_matches_jax_iou(n, iou_thr):
    """On the same corners the clip is bit-identical and the IoU's divide
    is IEEE in both packages, so the mask is exact."""
    boxes, corners = _group_corners(2, n, 4)
    areas = boxes[..., 2] * boxes[..., 3]
    inter = jax_iou._rect_intersection_area_jnp(
        jnp.asarray(corners[:, :, None]), jnp.asarray(corners[:, None, :]))
    iou = np.asarray(inter / jnp.maximum(
        areas[:, :, None] + areas[:, None, :] - inter, 1e-8))
    want = (iou > np.float32(iou_thr)) & np.triu(np.ones((n, n), bool), 1)
    mask = iou_ops.nms_dominance_mask_plain(
        torch.from_numpy(corners), torch.from_numpy(areas), iou_thr)
    assert mask.shape == (2, n, clip_kernel.mask_words(n))
    np.testing.assert_array_equal(iou_ops.unpack_mask(mask, n).numpy(), want)
    assert want.any() and not want.all()


def test_rotated_nms_presorted_matches_jax_rotated_nms_bev():
    boxes, _ = _group_corners(3, 50, 5)
    rng = np.random.RandomState(6)
    scores = -np.sort(-rng.uniform(0, 1, (3, 50)).astype(np.float32), axis=1)
    valid = rng.uniform(0, 1, (3, 50)) > 0.2
    ref = jax.vmap(lambda bx, sc, va: jax_nms.rotated_nms_bev(
        bx, sc, va, 0.1))(jnp.asarray(boxes), jnp.asarray(scores),
                          jnp.asarray(valid))
    got = nms.rotated_nms_presorted(torch.from_numpy(boxes),
                                    torch.from_numpy(valid), 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(valid.sum())


# --------------------------------------------------------------------------
# the new wrappers launch kernels only
# --------------------------------------------------------------------------

@pytest.mark.parametrize('call', [
    lambda: clip_kernel.rect_intersection_area_pairwise(
        torch.zeros(2, 3, 4, 2), torch.zeros(2, 5, 4, 2)),
    lambda: clip_kernel.nms_dominance_mask(torch.zeros(2, 3, 4, 2),
                                           torch.zeros(2, 3), 0.5),
    lambda: clip_kernel.nms_scan(torch.zeros(2, 3, 1, dtype=torch.int32),
                                 torch.ones(2, 3, dtype=torch.bool)),
    lambda: clip_kernel.nms_over_bits(torch.zeros(2, 3, 4, 2),
                                      torch.zeros(2, 3), 0.5),
    lambda: clip_kernel.nms_rank_mask(
        torch.zeros(2, 3, 1, dtype=torch.int32),
        torch.zeros(4, 3, dtype=torch.int64),
        torch.zeros(4, dtype=torch.int64)),
], ids=['pairwise', 'nms_mask', 'nms_scan', 'nms_over', 'nms_rank'])
def test_clip_wrappers_refuse_cpu_tensors(call):
    before = kernels.launch_counts()
    assert set(before) == {'backproject', 'backproject_grad', 'rect_clip',
                           'rect_clip_grad', 'nms_over', 'nms_rank',
                           'nms_scan', 'conv3x3x3'}
    with pytest.raises(ValueError, match='CUDA tensor'):
        call()
    assert kernels.launch_counts() == before


def test_clip_wrappers_refuse_gradients():
    c = torch.zeros(2, 3, 4, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match='no backward'):
        clip_kernel.rect_intersection_area_pairwise(c, c)
    with pytest.raises(RuntimeError, match='no backward'):
        clip_kernel.nms_dominance_mask(c, torch.zeros(2, 3), 0.5)
