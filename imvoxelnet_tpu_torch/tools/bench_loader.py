"""Host input pipeline throughput: can the loader feed the card?

    python -m imvoxelnet_tpu_torch.tools.bench_loader [--samples 256]
        [--batch-size 8] [--workers 1,2,4,8] [--layout kitti|sunrgbd]
        [--image-size 375x1242] [--target SCENES_PER_S]

Counterpart of the JAX package's ``tools/bench_loader.py``, on the port's
``data/loader.py`` (threads) and ``data/pipeline.py`` (the native fused
normalize + pad): a synthetic on-disk split of ``--samples`` entries of
one frame, ``--layout kitti`` a PNG of 375 x 1242 (written by
``utils/synthetic_splits.kitti_split``, decoded by the port's own PNG
reader) through ``imvoxelnet_kitti``'s train pipeline, ``--layout
sunrgbd`` a 480 x 640 JPEG (written and decoded through cv2, which it
needs) through ``imvoxelnet_sunrgbd_fast``'s.  For each worker count it
runs one train-mode epoch and prints the samples/s, the wall ms and the
CPU ms (``time.process_time``) per sample; with ``--target`` the cores a
consumption rate needs, ``target * cpu_ms / 1000``, from the smallest CPU
cost seen (a wall-clock scaling curve means something only on a host with
that many cores).  Host numbers: no card is involved.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time

import numpy as np

from ..configs.presets import apply_overrides, get_preset
from ..data.loader import DataLoader
from ..utils.synthetic_splits import kitti_split
from .train import build_train_dataset


def kitti_root(root: str, n: int, h: int, w: int) -> str:
    """One KITTI frame of ``h x w`` and an info file listing it ``n``
    times; returns the info file."""
    with open(kitti_split(root, 1, seed=0, frame_hw=(h, w)), 'rb') as f:
        infos = pickle.load(f)
    ann = os.path.join(root, 'kitti_infos_train.pkl')
    with open(ann, 'wb') as f:
        pickle.dump(infos * n, f)
    return ann


def sunrgbd_root(root: str, n: int) -> str:
    """SUN RGB-D layout: one 480 x 640 JPEG and an info file (column-major
    K, Rt) listing it ``n`` times; returns the info file."""
    import cv2
    os.makedirs(os.path.join(root, 'image'))
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (480, 640, 3), np.uint8)
    cv2.imwrite(os.path.join(root, 'image', '000001.jpg'), img,
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    fx, cx, cy = 400.0, 320.0, 240.0
    k = np.array([[fx, 0, 0], [0, fx, 0], [cx, cy, 1]], np.float64)
    box = np.array([[0.5, 3.0, -0.5, 1.0, 1.0, 1.0, 0.3]])
    info = dict(
        image=dict(image_idx=1, image_path='image/000001.jpg',
                   image_shape=np.array([480, 640], np.int32)),
        calib=dict(K=k.reshape(-1), Rt=np.eye(3)),
        annos=dict(gt_num=1, gt_boxes_upright_depth=box,
                   name=np.array(['bed']), **{'class': np.array([0])}),
    )
    ann = os.path.join(root, 'infos.pkl')
    with open(ann, 'wb') as f:
        pickle.dump([info] * n, f)
    return ann


def epoch_rate(dataset, batch_size, workers):
    """One train-mode epoch: samples, wall s and CPU s."""
    loader = DataLoader(dataset, batch_size, train=True, num_workers=workers)
    n = 0
    t0, c0 = time.perf_counter(), time.process_time()
    for batch in loader.epoch(0):
        n += batch['images'].shape[0]
    return n, time.perf_counter() - t0, time.process_time() - c0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--samples', type=int, default=256)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--workers', default='1,2,4,8',
                        help='comma-separated worker counts')
    parser.add_argument('--image-size', default='375x1242')
    parser.add_argument('--layout', choices=('kitti', 'sunrgbd'),
                        default='kitti')
    parser.add_argument('--target', type=float, default=None,
                        help='device consumption rate (scenes/s) to size '
                             'cores for')
    args = parser.parse_args(argv)
    name = ('imvoxelnet_kitti' if args.layout == 'kitti'
            else 'imvoxelnet_sunrgbd_fast')
    preset = apply_overrides(get_preset(name), ['data.repeat_times=1'])
    out = dict(layout=args.layout, samples=args.samples,
               batch_size=args.batch_size, runs=[])
    with tempfile.TemporaryDirectory(prefix='loaderbench_') as root:
        if args.layout == 'kitti':
            h, w = (int(v) for v in args.image_size.split('x'))
            ann = kitti_root(root, args.samples, h, w)
        else:
            h, w = 480, 640
            ann = sunrgbd_root(root, args.samples)
        dataset = build_train_dataset(preset, root, ann)
        print(f'{len(dataset)} samples, batch {args.batch_size}, source '
              f'{h}x{w} -> pad {preset.data.train_size}, layout '
              f'{args.layout}')
        # a first epoch pays the first-touch costs (threads, the native
        # library's load, the page cache) for whichever count runs first
        epoch_rate(dataset, args.batch_size, 2)
        for workers in (int(x) for x in args.workers.split(',')):
            n, wall, cpu = epoch_rate(dataset, args.batch_size, workers)
            row = dict(workers=workers, samples_per_s=n / wall,
                       wall_ms_per_sample=wall / n * 1e3,
                       cpu_ms_per_sample=cpu / n * 1e3)
            out['runs'].append(row)
            print(f'workers={workers:2d}: {row["samples_per_s"]:8.1f} '
                  f'samples/s ({row["wall_ms_per_sample"]:.2f} ms/sample '
                  f'wall, {row["cpu_ms_per_sample"]:.2f} ms/sample CPU)')
    cpu_ms = min(r['cpu_ms_per_sample'] for r in out['runs'])
    out['host_cores'] = os.cpu_count()
    if args.target:
        out['cores_for_target'] = args.target * cpu_ms / 1e3
        print(f'sizing: {cpu_ms:.2f} ms CPU/sample -> {args.target:.0f} '
              f'scenes/s needs ~{out["cores_for_target"]:.1f} cores (+1 for '
              f'the training loop); this host has {os.cpu_count()} cores')
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
