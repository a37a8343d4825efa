"""The port's box helpers against the JAX package's, on the CPU.

``core/box_modes.py:convert``, the ``ops/boxes.py`` geometry (rotations
about every axis, corners, projection, per-mode rotation and flip, BEV
range), the overlaps with their ``mode`` argument, and the host oracles of
``native/eval_kernels.cc`` (rotated-rect areas and greedy rotated NMS), all
on seeded inputs; and the reference's inline goldens of
``tests/test_boxes_golden.py`` (none reads the reference checkout) run on
the port through an adapter.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_boxes_golden as golden
from imvoxelnet_tpu import native as jax_native
from imvoxelnet_tpu.core import box_modes as jax_modes
from imvoxelnet_tpu.ops import boxes as jax_boxes
from imvoxelnet_tpu.ops import iou as jax_iou
from imvoxelnet_tpu_torch import native
from imvoxelnet_tpu_torch.core import box_modes
from imvoxelnet_tpu_torch.ops import boxes as box_ops
from imvoxelnet_tpu_torch.ops import iou as iou_ops

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x


class _OnThePort:
    """A port module whose functions take and return numpy (or JAX)
    arrays, so that the JAX package's golden tests run on it."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if not callable(fn):
            return fn

        def call(*args, **kwargs):
            conv = (lambda a: _t(a) if hasattr(a, '__array__')
                    and not isinstance(a, torch.Tensor) else a)
            return _np(fn(*[conv(a) for a in args],
                          **{k: conv(v) for k, v in kwargs.items()}))
        return call


def _boxes(rng, n):
    return np.concatenate([rng.uniform(-10, 10, (n, 3)),
                           rng.uniform(0.3, 4, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


GOLDEN_CASES = sorted(n for n in dir(golden) if n.startswith('test_'))


@pytest.mark.parametrize('case', GOLDEN_CASES)
def test_reference_goldens_hold_for_the_port(case, monkeypatch):
    monkeypatch.setattr(golden, 'box_ops', _OnThePort(box_ops))
    monkeypatch.setattr(golden, 'iou_ops', _OnThePort(iou_ops))
    monkeypatch.setattr(golden, 'box_modes', box_modes)
    getattr(golden, case)()


@pytest.mark.parametrize('src,dst', [
    (a, b) for a in ('cam', 'lidar', 'depth')
    for b in ('cam', 'lidar', 'depth') if a != b])
def test_box_modes_convert_matches_jax(src, dst):
    rng = np.random.RandomState(0)
    boxes = np.concatenate([_boxes(rng, 9), rng.randn(9, 2).astype(
        np.float32)], -1)                       # 9 columns: velocities kept
    rt3 = rng.randn(3, 3).astype(np.float32)
    rt4 = np.eye(4, dtype=np.float32)
    rt4[:3] = rng.randn(3, 4)
    for rt in (None, rt3, rt4):
        np.testing.assert_allclose(
            box_modes.convert(boxes, src, dst, rt),
            jax_modes.convert(boxes, src, dst, rt), **TOL)


def test_rotations_match_jax():
    rng = np.random.RandomState(1)
    pts = rng.randn(6, 5, 3).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
    for axis in (0, 1, 2):
        np.testing.assert_allclose(
            box_ops.rotation_3d_in_axis(_t(pts), _t(ang), axis=axis).numpy(),
            np.asarray(jax_boxes.rotation_3d_in_axis(
                jnp.asarray(pts), jnp.asarray(ang), axis=axis)), **TOL)
    with pytest.raises(ValueError):
        box_ops.rotation_3d_in_axis(_t(pts), _t(ang), axis=3)
    np.testing.assert_allclose(
        box_ops.rotation_matrix_2d(_t(ang)).numpy(),
        np.asarray(jax_boxes.rotation_matrix_2d(jnp.asarray(ang))), **TOL)


def test_box_geometry_matches_jax():
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 12)
    xywhr = boxes[:, [0, 1, 3, 4, 6]]
    np.testing.assert_allclose(
        box_ops.xywhr2xyxyr(_t(xywhr)).numpy(),
        np.asarray(jax_boxes.xywhr2xyxyr(jnp.asarray(xywhr))), **TOL)
    np.testing.assert_allclose(
        box_ops.corners(_t(boxes)).numpy(),
        np.asarray(jax_boxes.corners(jnp.asarray(boxes))), rtol=1e-6,
        atol=1e-5)
    pts = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
    pts[:, 2] += 12.0                           # in front of the camera
    for rows in (3, 4):
        proj = rng.randn(rows, 4).astype(np.float32)
        proj[2] = [0.01, 0.02, 1.0, 0.5]
        np.testing.assert_allclose(
            box_ops.points_cam2img(_t(pts), _t(proj)).numpy(),
            np.asarray(jax_boxes.points_cam2img(jnp.asarray(pts),
                                                jnp.asarray(proj))),
            rtol=1e-5, atol=1e-5)
    box_range = (-5.0, -5.0, 5.0, 5.0)
    np.testing.assert_array_equal(
        box_ops.in_range_bev(_t(boxes), box_range).numpy(),
        np.asarray(jax_boxes.in_range_bev(jnp.asarray(boxes), box_range)))


@pytest.mark.parametrize('mode', ['lidar', 'cam', 'depth'])
def test_rotate_and_flip_match_jax(mode):
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 10)
    pts = rng.randn(15, 4).astype(np.float32)
    got = box_ops.rotate_boxes(_t(boxes), 0.4321, mode, _t(pts))
    want = jax_boxes.rotate_boxes(jnp.asarray(boxes), 0.4321, mode,
                                  jnp.asarray(pts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=2e-6)
    for direction in ('horizontal', 'vertical'):
        got = box_ops.flip_boxes(_t(boxes), direction, mode, _t(pts))
        want = jax_boxes.flip_boxes(jnp.asarray(boxes), direction, mode,
                                    jnp.asarray(pts))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _xyxy(rng, n):
    lo = rng.uniform(0, 4, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(0.2, 2, (n, 2))],
                          -1).astype(np.float32)


def _corner6(rng, n):
    lo = rng.uniform(0, 3, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(0.2, 1.5, (n, 3))],
                          -1).astype(np.float32)


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_overlaps_2d_and_nearest_modes_match_jax(mode):
    rng = np.random.RandomState(4)
    a, b = _xyxy(rng, 9), _xyxy(rng, 7)
    np.testing.assert_allclose(
        iou_ops.bbox_overlaps_2d(_t(a), _t(b), mode=mode).numpy(),
        np.asarray(jax_iou.bbox_overlaps_2d(jnp.asarray(a), jnp.asarray(b),
                                            mode=mode)), **TOL)
    b1, b2 = _boxes(rng, 9), _boxes(rng, 7)
    np.testing.assert_allclose(
        iou_ops.bbox_overlaps_nearest_3d(_t(b1), _t(b2), mode).numpy(),
        np.asarray(jax_iou.bbox_overlaps_nearest_3d(
            jnp.asarray(b1), jnp.asarray(b2), mode)), **TOL)
    with pytest.raises(ValueError):
        iou_ops.bbox_overlaps_2d(_t(a), _t(b), mode='giou')


@pytest.mark.parametrize('mode', ['iou', 'giou'])
@pytest.mark.parametrize('is_aligned', [False, True])
def test_axis_aligned_3d_modes_match_jax(mode, is_aligned):
    rng = np.random.RandomState(5)
    a, b = _corner6(rng, 8), _corner6(rng, 8 if is_aligned else 5)
    np.testing.assert_allclose(
        iou_ops.axis_aligned_bbox_overlaps_3d(_t(a), _t(b), mode,
                                              is_aligned).numpy(),
        np.asarray(jax_iou.axis_aligned_bbox_overlaps_3d(
            jnp.asarray(a), jnp.asarray(b), mode, is_aligned)), **TOL)


def test_native_host_oracles_match_jax():
    if jax_native.load() is None:
        pytest.skip('the JAX package found no C++ toolchain')
    rng = np.random.RandomState(6)
    b1 = _boxes(rng, 16)[:, [0, 1, 3, 4, 6]] * [0.3, 0.3, 1, 1, 1]
    b2 = _boxes(rng, 12)[:, [0, 1, 3, 4, 6]] * [0.3, 0.3, 1, 1, 1]
    got = native.rect_intersection_areas(b1, b2)
    assert (got > 0).mean() > 0.2
    np.testing.assert_array_equal(got,
                                  jax_native.rect_intersection_areas(b1, b2))
    scores = rng.permutation(16).astype(np.float64)   # no ties: one order
    keep = native.rotated_nms_host(b1, scores, 0.1)
    np.testing.assert_array_equal(
        keep, jax_native.rotated_nms_host(b1, scores, 0.1))
    assert 0 < keep.sum() < 16
