"""The port's data path against the JAX package and OpenCV, on the CPU:
image decoding, the bilinear resize, the image pipeline, every dataset's
samples and the loader's batches, all bit for bit.

Both packages read the same files, which the tests write (PNG frames from
``utils/synthetic.py:write_png`` and OpenCV, info files from
``utils/synthetic_splits.py``); the JAX package decodes and resizes with
``cv2``, the port without it.
"""

import os
import pickle
import shutil

import cv2
import ml_dtypes
import numpy as np
import pytest
import torch

from imvoxelnet_tpu.data import datasets as jds
from imvoxelnet_tpu.data import loader as jloader
from imvoxelnet_tpu.data import pipeline as jpl

from imvoxelnet_tpu_torch import native
from imvoxelnet_tpu_torch.data import datasets as tds
from imvoxelnet_tpu_torch.data import image_io
from imvoxelnet_tpu_torch.data import loader as tloader
from imvoxelnet_tpu_torch.data import pipeline as tpl
from imvoxelnet_tpu_torch.utils import synthetic_splits as splits
from imvoxelnet_tpu_torch.utils.synthetic import png_filter_rows, write_png


def _filter_types(path):
    """The row filter types of a PNG file, as written."""
    import struct
    import zlib
    data = open(path, 'rb').read()
    pos, idat, w, h, ch = 8, b'', 0, 0, 0
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b'IHDR':
            w, h, _, color = struct.unpack('>IIBB', body[:10])
            ch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
        elif kind == b'IDAT':
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * ch + 1)[:, 0].tolist())


def _smooth(rng, h, w, ch):
    return splits.frame(rng, h, w)[..., :ch] if ch > 1 else \
        splits.frame(rng, h, w)[..., 0]


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('adaptive', [False, True])
def test_load_image_equals_cv2_on_libpng_files(tmp_path, channels, adaptive):
    """PNG files written by OpenCV decode as ``cv2.imread(path)[:, :,
    ::-1]``: gray replicated, alpha dropped.  OpenCV's default writes every
    row with the Sub filter; with ``IMWRITE_PNG_ALL_FILTERS`` libpng
    chooses each row's filter."""
    rng = np.random.RandomState(channels)
    img = _smooth(rng, 61, 97, channels)
    path = str(tmp_path / 'a.png')
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER,
                            cv2.IMWRITE_PNG_ALL_FILTERS] if adaptive else [])
    assert (len(_filter_types(path)) > 1) == adaptive
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    got = image_io.load_image(path)
    assert got.dtype == np.uint8 and got.shape == (61, 97, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
@pytest.mark.parametrize('filters', ['each', 0, 1, 2, 3, 4])
def test_load_image_equals_cv2_on_the_port_writers_files(tmp_path, channels,
                                                         filters):
    """The port's writer with one filter type forced on every row, or row
    ``y`` taking ``y % 5``; the name says ``.jpg``, the content is PNG."""
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (23, 41, channels)).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / 'b.jpg')
    write_png(path, img, None if filters == 'each' else
              np.full(23, filters))
    assert _filter_types(path) == (set(range(5)) if filters == 'each'
                                   else {filters})
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    np.testing.assert_array_equal(image_io.load_image(path), ref)


@pytest.mark.parametrize('bpp', [1, 2, 3, 4])
def test_png_unfilter_library_equals_its_plain_version(bpp):
    rng = np.random.RandomState(bpp)
    h, w = 9, 13
    px = rng.randint(0, 256, (h, w * bpp)).astype(np.uint8)
    raw = png_filter_rows(px, rng.randint(0, 5, h), bpp).tobytes()
    got = native.png_unfilter(raw, h, w * bpp, bpp)
    np.testing.assert_array_equal(got, image_io.png_unfilter_plain(
        raw, h, w * bpp, bpp))
    np.testing.assert_array_equal(got, px)
    bad = bytearray(raw)
    bad[3 * (w * bpp + 1)] = 5
    with pytest.raises(ValueError, match='row 3: filter type 5'):
        native.png_unfilter(bytes(bad), h, w * bpp, bpp)


def test_load_image_raises_naming_the_file_without_cv2(tmp_path,
                                                       monkeypatch):
    """A file that is not PNG needs cv2; where it is missing the error
    names the file."""
    import builtins
    path = str(tmp_path / 'c.jpg')
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == 'cv2':
            raise ImportError('no cv2 here')
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_cv2)
    with pytest.raises(RuntimeError, match='c.jpg.*needs cv2'):
        image_io.load_image(path)


# the KITTI test resize, SUN RGB-D's, the KITTI train scales' extremes
# (imvoxelnet_kitti train_scales ((1173, 352), (1387, 416))), identity and
# downscales
RESIZES = [((375, 1242), 1.024),
           ((530, 730), min(640 / 730, 480 / 530)),
           ((375, 1242), min(1173 / 1242, 352 / 375)),
           ((375, 1242), min(1387 / 1242, 416 / 375)),
           ((480, 640), 1.0), ((375, 1242), 0.7), ((530, 730), 0.61)]


@pytest.mark.parametrize('hw,factor', RESIZES)
def test_imresize_equals_cv2_bit_for_bit(hw, factor):
    rng = np.random.RandomState(hw[0])
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    got = image_io.imresize(img, factor)
    new_w, new_h = int(hw[1] * factor + 0.5), int(hw[0] * factor + 0.5)
    ref = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        image_io.resize_linear_u8_plain(img, (new_h, new_w)), ref)


def _random_u8(seed, hw, channels):
    """A random ``(h, w)`` (one channel: cv2 drops the axis) or ``(h, w,
    c)`` uint8 image."""
    img = np.random.RandomState(seed).randint(0, 256, hw + (channels,))
    return img.astype(np.uint8)[..., 0] if channels == 1 else \
        img.astype(np.uint8)


@pytest.mark.parametrize('channels', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('hw', [(480, 640), (242, 322), (2, 2)])
def test_exact_2x_downscale_equals_cv2s_inter_area_bit_for_bit(hw,
                                                               channels):
    """cv2.resize(INTER_LINEAR) serves an exact 2x downscale with
    INTER_AREA: the 2x2 mean rounded half up for 1, 3 and 4 channels, half
    to even for 2 and 5.  ``imresize``, the native resize and the plain
    one all give cv2's bits (242x322: an odd output width)."""
    cv2 = pytest.importorskip('cv2')
    img = _random_u8(hw[0] + channels, hw, channels)
    out_hw = (hw[0] // 2, hw[1] // 2)
    ref = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    for got in (image_io.imresize(img, 0.5),
                image_io.resize_linear_u8(img, out_hw),
                image_io.resize_linear_u8_plain(img, out_hw)):
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        native.resize_half_u8(img.reshape(hw + (channels,))),
        ref.reshape(out_hw + (channels,)))


@pytest.mark.parametrize('hw,out_hw', [
    ((480, 640), (120, 160)),      # exact 4x: linear in cv2
    ((480, 640), (240, 640)),      # 2x along one axis: linear
    ((480, 640), (480, 320)),
    ((482, 640), (241, 320)),      # exact 2x with an odd output height
])
def test_resize_takes_cv2s_path_around_exact_2x(hw, out_hw):
    """Only an exact 2x in both axes leaves the linear path, as in cv2;
    no size needs a special case in the test."""
    cv2 = pytest.importorskip('cv2')
    img = _random_u8(hw[0] + out_hw[1], hw, 3)
    ref = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(image_io.resize_linear_u8(img, out_hw),
                                  ref)
    np.testing.assert_array_equal(
        image_io.resize_linear_u8_plain(img, out_hw), ref)


PIPE_CFGS = {
    'kitti': dict(test_scale=(320, 96), pad_size=(96, 320),
                  train_scales=((290, 86), (350, 104)),
                  train_pad_size=(104, 352), flip_ratio=0.5),
    'scannet': dict(test_scale=(160, 120), pad_size=(128, 160),
                    fixed_size_resize=True),
}


@pytest.mark.parametrize('name', sorted(PIPE_CFGS))
@pytest.mark.parametrize('train', [False, True])
def test_process_image_equals_jax_bit_for_bit(name, train):
    rng_img = np.random.RandomState(3)
    img = splits.frame(rng_img, 94, 310)
    for seed in range(4):
        got, ginfo = tpl.process_image(
            img, tpl.ImagePipelineConfig(**PIPE_CFGS[name]), train,
            np.random.RandomState(seed))
        ref, rinfo = jpl.process_image(
            img, jpl.ImagePipelineConfig(**PIPE_CFGS[name]), train,
            np.random.RandomState(seed))
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.view(np.int32))
        assert ginfo == rinfo


def test_process_image_at_the_jax_tools_320x240_equals_jax_bit_for_bit():
    """The indoor learning and truncation tools' frames: a 640x480 frame at
    ``test_scale=(320, 256), pad_size=(256, 320)``, an exact 2x downscale
    that the JAX pipeline sends through cv2."""
    pytest.importorskip('cv2')
    img = splits.frame(np.random.RandomState(11), 480, 640)
    kw = dict(test_scale=(320, 256), pad_size=(256, 320))
    got, ginfo = tpl.process_image(img, tpl.ImagePipelineConfig(**kw),
                                   False, np.random.RandomState(0))
    ref, rinfo = jpl.process_image(img, jpl.ImagePipelineConfig(**kw),
                                   False, np.random.RandomState(0))
    assert got.shape == ref.shape == (256, 320, 3)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert ginfo == rinfo and ginfo['img_shape'][:2] == (240, 320)
    assert ginfo['scale_factor'] == rinfo['scale_factor'] == 0.5


def test_normalize_pad_u8_equals_jax_and_its_plain_version():
    img = np.random.RandomState(5).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    got = native.normalize_pad_u8(img, tpl.IMAGENET_MEAN, tpl.IMAGENET_STD,
                                  (40, 64))
    plain = tpl.pad_to(tpl.normalize(img), (40, 64))
    ref = jpl.pad_to(jpl.normalize(img), (40, 64))
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    with pytest.raises(ValueError, match='exceeds the pad size'):
        native.normalize_pad_u8(img, tpl.IMAGENET_MEAN, tpl.IMAGENET_STD,
                                (36, 64))


# --------------------------------------------------------------------------
# datasets: one small split of each family, read by both packages
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp('splits')
    out = {}
    out['kitti'] = (str(base / 'kitti'), splits.kitti_split(
        str(base / 'kitti'), 3, seed=1, frame_hw=(94, 310)))
    # the stereo dataset's right frames
    for name in os.listdir(base / 'kitti/training/image_2'):
        os.makedirs(base / 'kitti/training/image_3', exist_ok=True)
        shutil.copy(base / 'kitti/training/image_2' / name,
                    base / 'kitti/training/image_3' / name)
    out['sunrgbd'] = (str(base / 'sunrgbd'), splits.sunrgbd_split(
        str(base / 'sunrgbd'), 3, seed=2, frame_hw=(106, 146)))
    out['sunrgbd_total'] = (str(base / 'total'), splits.sunrgbd_split(
        str(base / 'total'), 3, seed=3, total3d=True, n_classes=33,
        frame_hw=(106, 146)))
    out['scannet'] = (str(base / 'scannet'), splits.scannet_split(
        str(base / 'scannet'), 2, 4, seed=4, frame_hw=(120, 160)))
    out['nuscenes'] = (str(base / 'nuscenes'), splits.nuscenes_split(
        str(base / 'nuscenes'), 2, seed=5, frame_hw=(90, 160)))
    return out


IMG = {
    'kitti': dict(test_scale=(320, 96), pad_size=(96, 320),
                  train_scales=((290, 86), (350, 104)),
                  train_pad_size=(128, 352), flip_ratio=0.5),
    'sunrgbd': dict(test_scale=(128, 96), pad_size=(96, 128),
                    train_scales=((112, 84), (144, 108)),
                    train_pad_size=(128, 160), flip_ratio=0.5),
    'scannet': dict(test_scale=(160, 120), pad_size=(128, 160),
                    fixed_size_resize=True),
    'nuscenes': dict(test_scale=(160, 96), pad_size=(96, 160)),
}
FAMILIES = [  # dataset key, split, image config, classes, extra arguments
    ('kitti', 'kitti', 'kitti', ('Pedestrian', 'Car'), {}),
    ('kitti_stereo', 'kitti', 'kitti', ('Car',), {}),
    ('sunrgbd', 'sunrgbd', 'sunrgbd', tuple(f'c{i}' for i in range(10)),
     {}),
    ('sunrgbd_perspective', 'sunrgbd', 'sunrgbd',
     tuple(f'c{i}' for i in range(10)), {}),
    ('sunrgbd_total', 'sunrgbd_total', 'sunrgbd',
     tuple(f'c{i}' for i in range(33)), {}),
    ('scannet', 'scannet', 'scannet', tuple(f'c{i}' for i in range(18)),
     dict(n_images=6)),
    ('nuscenes', 'nuscenes', 'nuscenes', ('car',), dict(n_images=6)),
]


def _pair(roots, key, split, img, classes, extra, test_mode=False):
    root, ann = roots[split]
    made = []
    for pkg, pl in ((jds, jpl), (tds, tpl)):
        made.append(pkg.DATASETS[key](
            root, ann, classes, pl.ImagePipelineConfig(**IMG[img]),
            max_gt=16, test_mode=test_mode, **extra))
    return made


def _assert_same_sample(got, ref):
    assert set(got) == set(ref)
    for key, val in ref.items():
        g = got[key]
        if isinstance(val, np.ndarray):
            assert g.dtype == val.dtype and g.shape == val.shape, key
            np.testing.assert_array_equal(g, val, err_msg=key)
        else:
            assert type(g) is type(val) and g == val, key


@pytest.mark.parametrize('family', FAMILIES, ids=[f[0] for f in FAMILIES])
def test_dataset_samples_equal_jax_bit_for_bit(roots, family):
    """Every sample of the split in test mode (no GT) and in train mode
    (GT, flips, train scales, origin jitter), from the same RandomState:
    every key equal, images to the bit."""
    for test_mode in (True, False):
        jset, tset = _pair(roots, *family, test_mode=test_mode)
        assert len(tset) == len(jset) > 0
        for index in range(len(jset)):
            for train in ((False,) if test_mode else (False, True)):
                for seed in range(3):
                    ref = jset.get_sample(index, train,
                                          np.random.RandomState(seed))
                    got = tset.get_sample(index, train,
                                          np.random.RandomState(seed))
                    _assert_same_sample(got, ref)
        if not test_mode:
            assert 'gt_boxes' in got and got['gt_mask'].any()


def test_collate_gives_the_detectors_torch_batch(roots):
    jset, tset = _pair(roots, *FAMILIES[4])
    rng = lambda: np.random.RandomState(0)  # noqa: E731
    samples = [tset.get_sample(i, True, rng()) for i in range(2)]
    got = tset.collate(samples)
    ref = jset.collate([jset.get_sample(i, True, rng()) for i in range(2)])
    assert set(got) == set(ref) >= {'images', 'intrinsics', 'extrinsics',
                                     'origins', 'img_shape', 'ratios',
                                     'gt_boxes', 'gt_labels', 'gt_mask',
                                     'gt_angles', 'gt_layout'}
    for key, val in ref.items():
        assert isinstance(got[key], torch.Tensor), key
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)
    assert got['img_shape'].dtype == torch.int32
    assert got['gt_labels'].dtype == torch.int32
    assert got['gt_mask'].dtype == torch.bool


@pytest.mark.parametrize('split,key', [('nuscenes', 'nuscenes'),
                                       ('sunrgbd', 'sunrgbd')])
def test_cbgs_index_table_equals_jax(roots, split, key):
    family = next(f for f in FAMILIES if f[0] == key)
    jset, tset = _pair(roots, *family)
    ref = jds.CBGSDataset(jset)
    got = tds.CBGSDataset(tset)
    assert got.sample_indices == ref.sample_indices
    assert len(got) == len(ref) > 0
    _assert_same_sample(got.get_sample(1, True, np.random.RandomState(0)),
                        ref.get_sample(1, True, np.random.RandomState(0)))


# --------------------------------------------------------------------------
# the loader
# --------------------------------------------------------------------------

@pytest.mark.parametrize('train', [False, True])
def test_loader_epoch_equals_jax_batch_for_batch(roots, train):
    """Order, shuffle and the ragged last batch as the JAX loader's; the
    bfloat16 images equal ``ml_dtypes``' cast bit for bit."""
    family = FAMILIES[0]
    jset, tset = _pair(roots, *family)
    kw = dict(batch_size=2, train=train, seed=3, num_workers=2,
              drop_last=False)
    ref = list(jloader.DataLoader(jset, images_dtype=ml_dtypes.bfloat16,
                                  **kw).epoch(1))
    got = list(tloader.DataLoader(tset, images_dtype=torch.bfloat16,
                                  **kw).epoch(1))
    assert len(got) == len(ref) == 2 and ref[-1]['images'].shape[0] == 1
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert g['images'].dtype == torch.bfloat16
        np.testing.assert_array_equal(g['images'].view(torch.int16).numpy(),
                                      r['images'].view(np.int16))
        for key in set(r) - {'images'}:
            np.testing.assert_array_equal(g[key].numpy(), r[key],
                                          err_msg=key)


def test_loader_raises_a_samples_error_and_stops():
    class Broken:
        def __len__(self):
            return 5

        def get_sample(self, index, train, rng):
            if index == 3:
                raise KeyError('sample 3 is broken')
            return dict(x=np.full(2, index, np.float32))

        def collate(self, samples):
            return dict(x=torch.from_numpy(np.stack([s['x']
                                                     for s in samples])))

    loader = tloader.DataLoader(Broken(), 2, train=False, drop_last=False)
    seen = []
    with pytest.raises(KeyError, match='sample 3 is broken'):
        for batch in loader.epoch():
            seen.append(batch['x'][:, 0].tolist())
    assert seen == [[0.0, 1.0]]


def test_device_prefetch_on_the_cpu_moves_each_batch():
    batches = [dict(x=torch.full((2,), float(i))) for i in range(3)]
    got = list(tloader.device_prefetch(iter(batches), 'cpu'))
    assert [float(b['x'][0]) for b in got] == [0.0, 1.0, 2.0]


def test_split_info_files_hold_the_datasets_schemas(roots):
    """The written splits read as the schemas say (a pickle the datasets
    load), with GT in every sample."""
    for split, (root, ann) in roots.items():
        with open(ann, 'rb') as f:
            infos = pickle.load(f)
        infos = infos['infos'] if isinstance(infos, dict) else infos
        assert len(infos) >= 2, split
