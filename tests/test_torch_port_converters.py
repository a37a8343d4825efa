"""The port's dataset converters and ``tools/create_data.py`` against the
JAX package's, on synthetic raw trees the tests write
(``imvoxelnet_tpu_torch/utils/synthetic_raw.py``; the raw datasets are not
in the repository).

Each converter of both packages reads the same tree; the pickles must be
the same bytes, and equal key for key and array for array.  The port reads
an image's shape from its header (``data/image_io.py:image_shape``) where
the JAX converters decode it with ``cv2``: held to ``cv2.imread`` on PNG,
baseline and progressive JPEG, and JPEG with an EXIF rotation.  The KITTI
and ScanNet trees are written from the synthetic splits' info lists, which
the converters must give back (ScanNet's poses and intrinsic as the
``.sens`` format's float32).  The port's datasets read every converted
split.
"""

import os
import pickle
import runpy
import struct
import sys

import numpy as np
import pytest

from imvoxelnet_tpu.data.converters import kitti_converter as jax_kitti
from imvoxelnet_tpu.data.converters import nuscenes_converter as jax_nus
from imvoxelnet_tpu.data.converters import scannet_converter as jax_scannet
from imvoxelnet_tpu.data.converters import sunrgbd_converter as jax_sun
from imvoxelnet_tpu.data.converters import sunrgbd_total_converter as jax_tot

from imvoxelnet_tpu_torch.data import datasets, pipeline
from imvoxelnet_tpu_torch.data.converters import (kitti_converter,
                                                  nuscenes_converter,
                                                  scannet_converter,
                                                  sunrgbd_converter,
                                                  sunrgbd_total_converter)
from imvoxelnet_tpu_torch.data.image_io import image_shape
from imvoxelnet_tpu_torch.tools import create_data
from imvoxelnet_tpu_torch.utils import synthetic, synthetic_raw as raw
from imvoxelnet_tpu_torch.utils import synthetic_splits as splits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, ref, path='infos'):
    """Equal key for key, item for item, array for array (dtype too)."""
    assert type(got) is type(ref), (path, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _same(got[k], ref[k], f'{path}.{k}')
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f'{path}[{i}]')
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert got == ref, path


def _both(path, jax_fn, port_fn):
    """Run the JAX converter, keep its pickle, run the port's over it;
    returns both info lists after holding the files to the same bytes."""
    ref = jax_fn()
    with open(path, 'rb') as f:
        ref_bytes = f.read()
    got = port_fn()
    with open(path, 'rb') as f:
        assert f.read() == ref_bytes, path
    _same(got, ref)
    return got, ref


def _read(key, root, ann, classes, n_images=1, **img):
    """Every sample of a converted split through the port's dataset."""
    cfg = pipeline.ImagePipelineConfig(**img)
    ds = datasets.DATASETS[key](root, ann, classes, cfg, n_images=n_images,
                                max_gt=16)
    rng = np.random.RandomState(0)
    samples = [ds.get_sample(i, False, rng) for i in range(len(ds))]
    for s in samples:
        assert np.isfinite(s['images']).all()
        assert s['images'].shape[0] == n_images
    return ds, samples


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp('raw')
    out = {}
    root = str(base / 'kitti')
    ann = splits.kitti_split(root, 3, seed=0, frame_hw=(94, 310))
    with open(ann, 'rb') as f:
        out['kitti'] = (root, pickle.load(f))
    raw.kitti_raw(root, out['kitti'][1])
    root = str(base / 'scannet')
    ann = splits.scannet_split(root, 1, 4, seed=4, frame_hw=(120, 160))
    with open(ann, 'rb') as f:
        out['scannet'] = (root, pickle.load(f))
    raw.scannet_raw(root, out['scannet'][1])
    out['sunrgbd'] = str(base / 'sunrgbd')
    raw.sunrgbd_raw(out['sunrgbd'], 3, seed=2, frame_hw=(106, 146))
    out['total'] = raw.total3d_raw(str(base / 'total'), 3, seed=3,
                                   frame_hw=(106, 146))
    out['nuscenes'] = str(base / 'nuscenes')
    out['val_scenes'] = raw.nuscenes_raw(out['nuscenes'], 3, seed=5,
                                         frame_hw=(90, 160))
    return out


def test_image_shape_equals_cv2(tmp_path):
    """PNG (and PNG content named ``.jpg``, as the synthetic splits write),
    baseline and progressive JPEG, and a JPEG whose EXIF orientation (6)
    makes ``cv2.imread`` turn it."""
    import cv2

    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(((7, 13), (94, 310), (53, 73))):
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        paths.append(str(tmp_path / f'{i}.png'))
        synthetic.write_png(paths[-1], img)
        paths.append(str(tmp_path / f'{i}_png.jpg'))
        synthetic.write_png(paths[-1], img)
        for progressive in (0, 1):
            ok, buf = cv2.imencode('.jpg', img, [
                cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
            paths.append(str(tmp_path / f'{i}_{progressive}.jpg'))
            with open(paths[-1], 'wb') as f:
                f.write(buf.tobytes())
    tiff = (b'II*\x00' + struct.pack('<IH', 8, 1) +
            struct.pack('<HHIHH', 0x0112, 3, 1, 6, 0) + struct.pack('<I', 0))
    app1 = b'Exif\x00\x00' + tiff
    with open(paths[-1], 'rb') as f:
        data = f.read()
    paths.append(str(tmp_path / 'exif.jpg'))
    with open(paths[-1], 'wb') as f:
        f.write(data[:2] + b'\xff\xe1' + struct.pack('>H', len(app1) + 2) +
                app1 + data[2:])
    for path in paths:
        assert image_shape(path) == cv2.imread(path).shape[:2], path
    assert image_shape(paths[-1]) == (73, 53)


def test_kitti_converter_equals_jax_and_gives_the_split_back(trees):
    root, infos = trees['kitti']
    got, _ = _both(os.path.join(root, 'kitti_infos_val.pkl'),
                   lambda: jax_kitti.create_kitti_infos(root, 'val', 2),
                   lambda: kitti_converter.create_kitti_infos(root, 'val', 2))
    for g, r in zip(got, infos):
        _same(g['image'], r['image'])
        for key in r['calib']:
            _same(g['calib'][key], r['calib'][key], key)
        for key in r['annos']:
            _same(g['annos'][key], r['annos'][key], key)
    _, samples = _read('kitti', root, os.path.join(root,
                                                   'kitti_infos_val.pkl'),
                       ('Pedestrian', 'Car'), test_scale=(320, 96),
                       pad_size=(96, 320))
    assert len(samples) == 3


def test_sunrgbd_converters_equal_jax(trees):
    root = trees['sunrgbd']
    for monocular in (False, True):
        name = 'monocular_' if monocular else 'imvoxelnet_'
        path = os.path.join(root, f'sunrgbd_{name}infos_val.pkl')
        got, _ = _both(path, lambda: jax_sun.create_sunrgbd_infos(
            root, 'val', monocular=monocular, num_workers=2),
            lambda: sunrgbd_converter.create_sunrgbd_infos(
                root, 'val', monocular=monocular, num_workers=2))
        assert got[0]['annos'] == {'gt_num': 0}      # only a 'wall'
        assert all(i['annos']['gt_num'] > 0 for i in got[1:])
        assert all(tuple(i['image']['image_shape']) == (106, 146)
                   for i in got)
        _, samples = _read('sunrgbd', root, path, raw.SUNRGBD_CLASSES,
                           test_scale=(128, 96), pad_size=(96, 128))
        assert sum(s['gt_mask'].sum() for s in samples) > 0


def test_total3d_converter_equals_jax(trees):
    path = trees['total']
    got, _ = _both(path.replace('.json', '.pkl'),
                   lambda: jax_tot.convert_total_sunrgbd(path),
                   lambda: sunrgbd_total_converter.convert_total_sunrgbd(
                       path))
    assert all(abs(i['angles']).max() < np.deg2rad(8.0) for i in got)
    classes = sunrgbd_total_converter.TOTAL_CLASSES
    _, samples = _read('sunrgbd_total', os.path.dirname(path),
                       path.replace('.json', '.pkl'), classes,
                       test_scale=(128, 96), pad_size=(96, 128))
    assert all(np.isfinite(s['gt_layout']).all() for s in samples)


def test_scannet_sens_extraction_and_infos_equal_jax(trees):
    """The test's ``.sens`` stream through both packages'
    ``extract_posed_images`` (the same files) and ``create_scannet_infos``:
    the split's boxes exactly, its poses and intrinsic as float32."""
    root, infos = trees['scannet']
    posed = os.path.join(root, 'posed_images', 'scene0000_00')
    files = {}
    for extract in (jax_scannet.extract_posed_images,
                    scannet_converter.extract_posed_images):
        extract(root, 300, 2)
        files[extract] = {n: open(os.path.join(posed, n), 'rb').read()
                          for n in sorted(os.listdir(posed))}
    assert len(set(map(str, files.values()))) == 1 and len(
        next(iter(files.values()))) == 4 * 2 + 1
    got, _ = _both(
        os.path.join(root, 'scannet_imvoxelnet_infos_val.pkl'),
        lambda: jax_scannet.create_scannet_infos(root, 'val'),
        lambda: scannet_converter.create_scannet_infos(root, 'val'))
    g, r = got[0], infos[0]
    assert g['img_paths'] == r['img_paths']
    f32 = lambda m: np.asarray(m, np.float32).astype(np.float64)  # noqa
    _same(g['extrinsics'], [f32(p) for p in r['extrinsics']])
    _same(g['intrinsics'], f32(r['intrinsics']))
    for key in r['annos']:
        _same(g['annos'][key], r['annos'][key], key)
    _, samples = _read('scannet', root,
                       os.path.join(root, 'scannet_imvoxelnet_infos_val.pkl'),
                       tuple(f'c{i}' for i in range(18)), n_images=4,
                       test_scale=(160, 120), pad_size=(128, 160),
                       fixed_size_resize=True)
    assert samples[0]['gt_mask'].sum() == r['annos']['gt_num']


def test_nuscenes_converter_equals_jax(trees):
    """Two scenes (one listed for validation), six cameras a sample: the
    port's converter against the JAX one, the cars back in the lidar frame,
    and both splits through the port's dataset."""
    root, version = trees['nuscenes'], 'v1.0-mini'
    pkl = os.path.join(root, 'nuscenes_infos_train.pkl')
    got, _ = _both(
        pkl, lambda: list(jax_nus.create_nuscenes_infos(
            root, version, trees['val_scenes'])),
        lambda: list(nuscenes_converter.create_nuscenes_infos(
            root, version, trees['val_scenes'])))
    train, val = got
    assert len(train) == 2 and len(val) == 1
    for split, infos in (('train', train), ('val', val)):
        assert all(len(i['cams']) == 6 for i in infos)
        assert all(i['gt_names'][-1] == 'pedestrian' for i in infos)
        _, samples = _read('nuscenes', root, os.path.join(
            root, f'nuscenes_infos_{split}.pkl'), ('car',), n_images=6,
            test_scale=(160, 96), pad_size=(96, 160))
        for s, info in zip(samples, infos):
            assert 0 < s['gt_mask'].sum() <= (info['gt_names'] == 'car').sum()


def test_create_data_cli_equals_the_jax_cli(trees, tmp_path, monkeypatch,
                                            capsys):
    """Every subcommand of the port's ``tools/create_data.py`` writes the
    bytes the JAX CLI writes on the same tree; ``nuscenes`` exits with the
    JAX CLI's message."""
    def jax_cli(*argv):
        monkeypatch.setattr(sys, 'argv', ['create_data.py', *argv])
        runpy.run_path(os.path.join(REPO, 'tools', 'create_data.py'),
                       run_name='__main__')

    kitti_root = trees['kitti'][0]
    scannet_root = trees['scannet'][0]
    cases = [
        (['kitti', '--root-path', kitti_root, '--splits', 'val'],
         [os.path.join(kitti_root, 'kitti_infos_val.pkl')]),
        (['sunrgbd', '--root-path', trees['sunrgbd'], '--splits', 'val'],
         [os.path.join(trees['sunrgbd'],
                       'sunrgbd_imvoxelnet_infos_val.pkl')]),
        (['sunrgbd_monocular', '--root-path', trees['sunrgbd'], '--splits',
          'val'], [os.path.join(trees['sunrgbd'],
                                'sunrgbd_monocular_infos_val.pkl')]),
        (['sunrgbd_total', '--root-path', os.path.dirname(trees['total']),
          '--splits', 'val'], [trees['total'].replace('.json', '.pkl')]),
        (['scannet_images', '--root-path', scannet_root, '--max-frames',
          '2', '--workers', '2'],
         [os.path.join(scannet_root, 'posed_images', 'scene0000_00', n)
          for n in ('00000.jpg', '00001.txt', 'intrinsic.txt')]),
        (['scannet', '--root-path', scannet_root, '--splits', 'val'],
         [os.path.join(scannet_root, 'scannet_imvoxelnet_infos_val.pkl')]),
    ]
    for argv, outputs in cases:
        jax_cli(*argv)
        ref = [open(p, 'rb').read() for p in outputs]
        create_data.main(argv)
        assert [open(p, 'rb').read() for p in outputs] == ref, argv[0]
    argv = ['nuscenes', '--root-path', trees['nuscenes']]
    with pytest.raises(SystemExit) as ref:
        jax_cli(*argv)
    with pytest.raises(SystemExit) as got:
        create_data.main(argv)
    assert str(got.value) == str(ref.value) and 'devkit' in str(got.value)
    capsys.readouterr()
