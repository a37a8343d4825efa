"""The port's evaluation path against the JAX package, on the CPU: the
KITTI, indoor and nuScenes protocols on the JAX tests' own cases, the
native eval library against its numpy versions, ``bbox_overlaps_3d``, the
runner end to end on tiny KITTI and SUN RGB-D splits, and the test CLI.

The protocol cases are the JAX tests' functions themselves
(``tests/test_kitti_eval.py``, ``test_indoor_eval.py``,
``test_nuscenes_eval.py``), run with each protocol function replaced by a
twin that calls the JAX function and the port's on the same arguments,
requires equal results (tolerances below) and hands the port's to the
test's own assertions.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

import test_indoor_eval
import test_kitti_eval
import test_nuscenes_eval
from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.eval import indoor_eval as jindoor
from imvoxelnet_tpu.eval import kitti_eval as jke
from imvoxelnet_tpu.eval import nuscenes_eval as jnus
from imvoxelnet_tpu.eval import runner as jrunner
from imvoxelnet_tpu.models.detector import ImVoxelNet as JaxImVoxelNet
from imvoxelnet_tpu.ops import iou as jiou

from imvoxelnet_tpu_torch import native
from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.eval import indoor_eval as tindoor
from imvoxelnet_tpu_torch.eval import kitti_eval as tke
from imvoxelnet_tpu_torch.eval import nuscenes_eval as tnus
from imvoxelnet_tpu_torch.eval import runner
from imvoxelnet_tpu_torch.ops import iou as tiou
from imvoxelnet_tpu_torch.tools import test as test_cli
from imvoxelnet_tpu_torch.utils import synthetic_splits as splits

from _torch_port_fixtures import (jax_variables, port_model,
                                  projection_margin, tiny_indoor_cfgs)

# the protocols run the same float64 numpy in both packages (KITTI,
# nuScenes); the indoor one's IoUs are float32 through the same clip
KITTI_TOL = 1e-9
METRIC_TOL = 1e-6
IOU_TOL = 1e-5
BOX_TOL = 2e-3           # the full-detector parity tolerance
PIXEL_MARGIN = 1e-4


def _same(got, ref, tol, path='result'):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _same(got[k], ref[k], tol, f'{path}[{k!r}]')
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, tol, f'{path}[{i}]')
    elif isinstance(ref, np.ndarray) and ref.dtype.kind in 'USO':
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64), rtol=0,
                                   atol=tol, err_msg=path)


class Twin:
    """Functions that run the JAX function and the port's on the same
    arguments, compare their results and return the port's."""

    def __init__(self, ref_mod, port_mod, tol, **port_kwargs):
        self.ref_mod, self.port_mod = ref_mod, port_mod
        self.tol, self.port_kwargs = tol, port_kwargs
        self.calls = 0

    def fn(self, name):
        ref_fn, port_fn = getattr(self.ref_mod, name), getattr(self.port_mod,
                                                               name)

        def twin(*args, **kwargs):
            ref = ref_fn(*args, **kwargs)
            got = port_fn(*args, **kwargs, **self.port_kwargs)
            _same(got, ref, self.tol, name)
            self.calls += 1
            return got
        return twin

    def __getattr__(self, name):
        val = getattr(self.port_mod, name)
        return self.fn(name) if callable(val) else val


_jax_iou = jax.jit(jiou.bbox_overlaps_3d, static_argnames='mode')


def _pad_pow2(boxes):
    n = max(8, 1 << max(len(boxes) - 1, 0).bit_length())
    out = np.tile(np.array([[1e3, 1e3, 0, 1, 1, 1, 0]], np.float32), (n, 1))
    out[:len(boxes)] = boxes
    return out


def _jax_box_iou_3d(pred_boxes, gt_boxes):
    """The JAX protocol's IoU call, jitted on boxes padded to a power of
    two (far-away unit boxes): each pair's IoU is computed alone, and the
    eager call would compile its every operation anew for each shape.  XLA
    fuses the jitted call's float32 operations, which moves an IoU by an
    ulp or so."""
    pred = np.asarray(pred_boxes, np.float32).reshape(-1, 7)
    gt = np.asarray(gt_boxes, np.float32).reshape(-1, 7)
    return np.asarray(_jax_iou(_pad_pow2(pred), _pad_pow2(gt)))[
        :len(pred), :len(gt)]


@pytest.fixture
def fast_jax_iou(monkeypatch):
    monkeypatch.setattr(jindoor, '_box_iou_3d', _jax_box_iou_3d)


def test_padded_jitted_jax_iou_equals_the_eager_call():
    rng = np.random.RandomState(6)
    b1, b2 = _boxes3d(rng, 5), _boxes3d(rng, 3)
    ref = np.asarray(jindoor._box_iou_3d(b1, b2))
    assert (ref > 0).any()
    # float32 rounding of fused against unfused operations
    np.testing.assert_allclose(_jax_box_iou_3d(b1, b2), ref, rtol=0,
                               atol=1e-7)


KITTI_CASES = [n for n in dir(test_kitti_eval) if n.startswith('test_')
               # reads the reference implementation's fixture files,
               # which are not part of this repository
               and n != 'test_convert_to_kitti_annos_roundtrip']


@pytest.mark.parametrize('case', KITTI_CASES)
def test_kitti_protocol_equals_jax_on_its_cases(case, monkeypatch):
    twin = Twin(jke, tke, KITTI_TOL)
    monkeypatch.setattr(test_kitti_eval, 'ke', twin)
    getattr(test_kitti_eval, case)()
    assert twin.calls > 0


INDOOR_CASES = [n for n in dir(test_indoor_eval) if n.startswith('test_')]


@pytest.mark.parametrize('case', INDOOR_CASES)
def test_indoor_protocol_equals_jax_on_its_cases(case, monkeypatch,
                                                 fast_jax_iou):
    """The IoUs on CPU tensors (the clip's plain version); JAX on its jnp
    clip.  ``layout_ious`` included."""
    twins = [Twin(jindoor, tindoor, METRIC_TOL),
             Twin(jindoor, tindoor, METRIC_TOL, device='cpu'),
             Twin(jrunner, runner, IOU_TOL, device='cpu')]
    monkeypatch.setattr(test_indoor_eval, 'average_precision',
                        twins[0].fn('average_precision'))
    for name in ('indoor_eval', 'eval_det_cls'):
        monkeypatch.setattr(test_indoor_eval, name, twins[1].fn(name))
    monkeypatch.setattr(jrunner, 'layout_ious', twins[2].fn('layout_ious'))
    getattr(test_indoor_eval, case)()
    assert sum(t.calls for t in twins) > 0


NUSCENES_CASES = [n for n in dir(test_nuscenes_eval)
                  if n.startswith('test_')]


@pytest.mark.parametrize('case', NUSCENES_CASES)
def test_nuscenes_protocol_equals_jax_on_its_cases(case, monkeypatch):
    twin = Twin(jnus, tnus, KITTI_TOL)
    for name in ('nuscenes_nds', 'simple_nuscenes_ap'):
        monkeypatch.setattr(test_nuscenes_eval, name, twin.fn(name))
    getattr(test_nuscenes_eval, case)()
    assert twin.calls > 0


def test_official_nuscenes_eval_raises_without_the_devkit():
    with pytest.raises(ImportError, match='nuscenes-devkit'):
        tnus.official_nuscenes_eval([], '/nonexistent')


# --------------------------------------------------------------------------
# the native eval library against its numpy versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize('seed,metric,n_dc', [(1, 2, 0), (3, 0, 0),
                                               (8, 0, 3)])
def test_native_statistics_equal_numpy(seed, metric, n_dc):
    """The native matcher at every threshold == the numpy matcher at each,
    3D (metric 2) and image boxes (metric 0) with and without DontCare
    boxes (their image-IoF, as ``kitti_eval.eval_class`` passes it)."""
    rng = np.random.RandomState(seed)
    n_gt, n_dt = 6, 9
    overlaps = rng.uniform(0, 1, (n_dt, n_gt))
    gt_datas = np.concatenate(
        [rng.uniform(0, 300, (n_gt, 4)), rng.uniform(-3, 3, (n_gt, 1))], 1)
    dt_scores = rng.uniform(0, 1, n_dt)
    dt_datas = np.concatenate(
        [np.sort(rng.uniform(0, 300, (n_dt, 2, 2)), 1).reshape(n_dt, 4),
         rng.uniform(-3, 3, (n_dt, 1)), dt_scores[:, None]], 1)
    dc_bboxes = np.concatenate([dt_datas[:n_dc, :2] - 5,
                                dt_datas[:n_dc, 2:4] + 5], 1)
    ignored_gt = rng.choice([-1, 0, 1], n_gt)
    ignored_det = rng.choice([-1, 0, 1], n_dt)
    thresholds = np.sort(rng.uniform(0, 1, 7))[::-1].copy()
    exp = np.zeros((len(thresholds), 4))
    for t, thr in enumerate(thresholds):
        tp, fp, fn, sim, _ = tke.compute_statistics(
            overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
            dc_bboxes, metric=metric, min_overlap=0.4, thresh=thr,
            compute_fp=True, compute_aos=True)
        exp[t] += [tp, fp, fn, sim if sim != -1 else 0]
    dc_overlaps = (tke.image_box_overlap(dt_datas[:, :4], dc_bboxes, 0)
                   if n_dc else np.zeros((n_dt, 0)))
    got = np.zeros((len(thresholds), 4))
    native.compute_statistics_thresholds(
        overlaps, dt_scores, dt_datas[:, 4], gt_datas[:, 4], ignored_gt,
        ignored_det, dc_overlaps, 0.4, thresholds, 1, got)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-9)
    assert exp[:, 0].sum() > 0
    if n_dc:  # the DontCare boxes take false positives away
        fp = [tke.compute_statistics(
            overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
            np.zeros((0, 4)), metric=0, min_overlap=0.4, thresh=thr,
            compute_fp=True, compute_aos=True)[1] for thr in thresholds]
        assert sum(fp) > exp[:, 1].sum()


# --------------------------------------------------------------------------
# bbox_overlaps_3d and the per-image IoU of the indoor protocol
# --------------------------------------------------------------------------

def _boxes3d(rng, n):
    return np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)),
                           rng.uniform(-0.3, 0.3, (n, 1)),
                           rng.uniform(0.4, 2.0, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


@pytest.mark.parametrize('mode', ['iou', 'iof'])
def test_bbox_overlaps_3d_equals_jax(mode):
    rng = np.random.RandomState(4)
    b1, b2 = _boxes3d(rng, 13), _boxes3d(rng, 9)
    got = tiou.bbox_overlaps_3d(torch.from_numpy(b1), torch.from_numpy(b2),
                                mode).numpy()
    # jitted: one compile (the eager call compiles each operation)
    ref = np.asarray(_jax_iou(b1, b2, mode=mode))
    assert got.shape == (13, 9) and 0.2 < (ref > 0).mean() < 1
    np.testing.assert_allclose(got, ref, rtol=0, atol=IOU_TOL)
    # leading dims are groups: each group as its own call
    stacked = tiou.bbox_overlaps_3d(torch.from_numpy(np.stack([b1, b1[::-1]])),
                                    torch.from_numpy(np.stack([b2, b2])),
                                    mode).numpy()
    np.testing.assert_array_equal(stacked[0], got)
    np.testing.assert_array_equal(stacked[1], got[::-1])
    with pytest.raises(ValueError, match='mode'):
        tiou.bbox_overlaps_3d(torch.from_numpy(b1), torch.from_numpy(b2),
                              'giou')


def test_per_image_iou_slices_equal_the_per_class_calls():
    """The protocol's one IoU call per image, sliced by class, equals the
    JAX protocol's one call per (class, image), bit for bit."""
    rng = np.random.RandomState(5)
    det = _boxes3d(rng, 17)
    gt = _boxes3d(rng, 11)
    det_labels, gt_labels = rng.randint(0, 3, 17), rng.randint(0, 3, 11)
    [whole] = tindoor.image_ious([dict(boxes=gt)], [dict(boxes=det)], 'cpu')
    for c in range(3):
        m, g = det_labels == c, gt_labels == c
        per_class = tindoor._box_iou_3d(det[m], gt[g], 'cpu')
        np.testing.assert_array_equal(whole[m][:, g].view(np.int32),
                                      per_class.view(np.int32))


# --------------------------------------------------------------------------
# the runner end to end, and the CLI
# --------------------------------------------------------------------------

def _jax_run(jpreset, name, root, ann, variables):
    # b=1: one compile; the port serves b=2 and a ragged last batch
    dataset, loader = jrunner.build_val_dataset(
        jpreset, name, root, ann, num_workers=2, batch_size=1)
    forward = jrunner.make_forward(jpreset, JaxImVoxelNet(jpreset.model))
    results = jrunner.run_inference(forward, variables, loader,
                                    len(dataset.data_infos))
    return dataset, loader, results


def _port_run(preset, name, root, ann, variables):
    dataset, loader = runner.build_val_dataset(
        preset, name, root, ann, num_workers=2, batch_size=2, device='cpu')
    model = port_model(preset.model, variables)
    results = runner.run_inference(model, preset.model, loader,
                                   len(dataset.data_infos), device='cpu')
    return dataset, results


def _first_batch_np(loader):
    return next(iter(loader.epoch(0)))


def _gt_as_prediction(dataset, kitti):
    """The GT of each sample as its detections, each with its own score;
    KITTI's boxes with the yaw the conversion's -pi hack undoes."""
    out, n = [], 0
    for i in range(len(dataset.data_infos)):
        ann = dataset.get_ann_info(i)
        boxes = ann['gt_bboxes_3d'].copy()
        if kitti:
            boxes[:, 6] += np.pi
        scores = 0.9 - 1e-3 * np.arange(n, n + len(boxes))
        n += len(boxes)
        out.append(dict(boxes=boxes, labels=ann['gt_labels_3d'],
                        scores=scores.astype(np.float32)))
    return out


def kitti_ap_ceiling(infos, difficulty):
    """The 11-point AP of a perfect detector on these GT: the protocol
    samples ``T = len(get_thresholds)`` recall positions (at most 41, one
    per valid GT box below that), so it reaches ``ceil(T / 4) / 11 * 100``
    (``tests/test_e2e_kitti.py``: 100 / 11 for one box)."""
    empty = dict(name=np.array([]), bbox=np.zeros((0, 4)))
    n = sum(tke.clean_data(info['annos'], empty, 0, difficulty)[0]
            for info in infos)
    t = len(tke.get_thresholds(np.linspace(0.9, 0.5, n), n))
    return 100.0 * len(range(0, t, 4)) / 11


E2E = {
    # preset, split writer, its arguments, weights seed, cls bias
    # frames of one of KITTI's sizes (1238x374), resized to the preset's
    # 320x96; seed 33: a calibration whose pixel margin is 6.7e-4
    'kitti': ('tiny_kitti_test', splits.kitti_split,
              dict(n=5, seed=33, frame_hw=(374, 1238)), 7, 0.0),
    # SUN RGB-D's 730x530 frames resized to 128x93; seed 2: cameras whose
    # pixel margin is 1.4e-4
    'sunrgbd': ('imvoxelnet_sunrgbd', splits.sunrgbd_split,
                dict(n=3, seed=2, n_classes=3), 8, 0.0),
}


SMALL_BACKBONE = (1, 1, 1, 1)      # ResNet stages of one bottleneck each


def _presets(kind):
    name = E2E[kind][0]
    jpreset, preset = jax_presets.get_preset(name), presets.get_preset(name)
    if kind == 'kitti':
        return (name,) + tuple(dataclasses.replace(p, model=dataclasses.replace(
            p.model, backbone_stage_blocks=SMALL_BACKBONE))
            for p in (jpreset, preset))
    jcfg, cfg = tiny_indoor_cfgs()
    out = []
    for p, c in ((jpreset, jcfg), (preset, cfg)):
        out.append(dataclasses.replace(
            p, model=c, data=dataclasses.replace(
                p.data, classes=p.data.classes[:3], test_size=(128, 96))))
    return (name,) + tuple(out)


@pytest.fixture(scope='module', params=sorted(E2E))
def e2e(request, tmp_path_factory):
    kind = request.param
    name, jpreset, preset = _presets(kind)
    _, write, kwargs, wseed, bias = E2E[kind]
    root = str(tmp_path_factory.mktemp(kind))
    ann = write(root, **kwargs)
    _, loader = jrunner.build_val_dataset(
        jpreset, name, root, ann, num_workers=2, batch_size=1)
    batch_np = {k: np.asarray(v) for k, v in
                _first_batch_np(loader).items()}
    variables = jax_variables(jpreset.model, batch_np, seed=wseed,
                              cls_bias=bias)
    jset, _, jres = _jax_run(jpreset, name, root, ann, variables)
    tset, tres = _port_run(preset, name, root, ann, variables)
    return dict(kind=kind, name=name, jpreset=jpreset, preset=preset,
                jset=jset, tset=tset, jres=jres, tres=tres,
                batches=[{k: np.asarray(v) for k, v in b.items()}
                         for b in loader.epoch(0)])


def test_e2e_fixture_keeps_its_pixel_margin(e2e):
    cfg = e2e['preset'].model
    for batch in e2e['batches']:
        assert projection_margin(cfg.n_voxels, cfg.voxel_size,
                                 batch) > PIXEL_MARGIN


def test_e2e_results_equal_the_jax_runners(e2e):
    """Every sample's detections: counts and labels exact, boxes and
    scores within 2e-3 (the ragged last batch included)."""
    jres, tres = e2e['jres'], e2e['tres']
    assert len(tres) == len(jres) == len(e2e['jset'].data_infos)
    assert sum(len(r['scores']) for r in tres) > 0
    for got, ref in zip(tres, jres):
        assert set(got) == set(ref)
        np.testing.assert_array_equal(got['labels'], ref['labels'])
        for key in ('boxes', 'scores'):
            np.testing.assert_allclose(got[key], ref[key], rtol=BOX_TOL,
                                       atol=BOX_TOL)


def test_e2e_metrics_equal_the_jax_runners(e2e, fast_jax_iou):
    """The protocol on each package's own results within 1e-6, and on the
    GT as the prediction: every metric at its ceiling (KITTI: also against
    the JAX protocol)."""
    kind, name = e2e['kind'], e2e['name']
    got = runner.evaluate_results(e2e['preset'], name, e2e['tset'],
                                  e2e['tres'], device='cpu')
    ref = jrunner.evaluate_results(e2e['jpreset'], name, e2e['jset'],
                                   e2e['jres'])
    _same(got, ref, METRIC_TOL)
    assert all(np.isfinite(v) for v in got.values())
    gt_pred = _gt_as_prediction(e2e['tset'], kind == 'kitti')
    got = runner.evaluate_results(e2e['preset'], name, e2e['tset'], gt_pred,
                                  device='cpu')
    if kind == 'kitti':
        # (the indoor protocol's goldens are held above; JAX's eager IoU
        # calls compile per shape, too slow to repeat here)
        _same(got, jrunner.evaluate_results(e2e['jpreset'], name,
                                            e2e['jset'], gt_pred),
              METRIC_TOL)
        for d, diff in enumerate(('easy', 'moderate', 'hard')):
            ceiling = kitti_ap_ceiling(e2e['tset'].data_infos, d)
            assert ceiling > 100 / 11
            assert got[f'KITTI/Car_3D_{diff}'] == pytest.approx(ceiling)
    else:
        assert got['mAP_0.25'] == got['mAP_0.50'] == pytest.approx(1.0)


@pytest.mark.parametrize('e2e', ['kitti'], indirect=True)
def test_convert_to_kitti_annos_equals_jax_on_a_written_split(e2e):
    """The lidar-box -> KITTI camera-anno conversion of the e2e KITTI
    split's served results and of its GT (the yaw hack undone), against
    the JAX function on the same info file, key for key."""
    infos = e2e['tset'].data_infos
    for results in (e2e['tres'], _gt_as_prediction(e2e['tset'], True)):
        got = tke.convert_to_kitti_annos(results, infos, ('Pedestrian',
                                                          'Car'))
        ref = jke.convert_to_kitti_annos(results, infos, ('Pedestrian',
                                                          'Car'))
        _same(got, ref, KITTI_TOL)
        assert sum(len(a['name']) for a in got) > 0


def test_cli_runs_a_reference_checkpoint(tmp_path):
    """``tools/test.py``'s ``main`` on a split and a ``{'state_dict': ...}``
    ``.pth``: the checkpoint's weights serve (not the seeded ones), the
    results file holds what ``run_inference`` returns for them, and an
    override reaches the preset."""
    root = str(tmp_path / 'kitti')
    ann = splits.kitti_split(root, 3, seed=13, frame_hw=(94, 310))
    small = f'model.backbone_stage_blocks={SMALL_BACKBONE}'
    preset = presets.apply_overrides(presets.get_preset('tiny_kitti_test'),
                                     [small])
    model = port_model(preset.model, jax_variables(
        jax_presets.apply_overrides(jax_presets.get_preset('tiny_kitti_test'),
                                    [small]).model,
        {k: np.asarray(v) for k, v in _first_batch_np(
            runner.build_val_dataset(preset, 'tiny_kitti_test', root, ann,
                                     batch_size=1, device='cpu')[1]).items()},
        seed=9, cls_bias=0.0))
    ckpt = str(tmp_path / 'weights.pth')
    torch.save({'state_dict': model.state_dict(), 'meta': {'epoch': 12}},
               ckpt)
    out = str(tmp_path / 'results.pkl')
    args = ['tiny_kitti_test', '--data-root', root, '--ann-file', ann,
            '--torch-checkpoint', ckpt, '--device', 'cpu', '--batch-size',
            '2', '--num-workers', '2', '--out', out, '--override', small]
    summary = test_cli.main(args)
    assert summary['n_samples'] == 3 and summary['n_batches'] == 2
    assert 'KITTI/Car_3D_moderate' in summary['metrics']
    dataset, loader = runner.build_val_dataset(
        preset, 'tiny_kitti_test', root, ann, batch_size=2, device='cpu')
    want = runner.run_inference(model, preset.model, loader, 3, 'cpu')
    import pickle
    with open(out, 'rb') as f:
        dumped = pickle.load(f)
    assert sum(len(r['scores']) for r in want) > 0
    for got, ref in zip(dumped, want):
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    strict = test_cli.main(args + ['--override',
                                   'model.anchor_head.score_thr=0.999'])
    assert sum(len(r['scores']) for r in strict['results']) < sum(
        len(r['scores']) for r in want)
    assert os.path.exists(out)
