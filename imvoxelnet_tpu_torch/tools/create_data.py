"""Raw dataset trees -> the info files the datasets read.

    python -m imvoxelnet_tpu_torch.tools.create_data DATASET --root-path R \\
        [--splits train val] [--max-frames 300] [--workers 8]

Counterpart of the JAX package's ``tools/create_data.py``, with its
subcommands and flags:

    kitti               -> kitti_infos_{split}.pkl
    sunrgbd             -> sunrgbd_imvoxelnet_infos_{split}.pkl
    sunrgbd_monocular   -> sunrgbd_monocular_infos_{split}.pkl (30 classes)
    sunrgbd_total       -> sunrgbd_total_infos_{split}.pkl (from its json)
    scannet             -> scannet_imvoxelnet_infos_{split}.pkl
    scannet_images      -> posed_images/ extracted from the .sens streams
    nuscenes            -> exits, as the JAX CLI does; the converter is
                           ``data/converters/nuscenes_converter.py:
                           create_nuscenes_infos``, called as a function
"""

from __future__ import annotations

import argparse
import os

from ..data.converters import (kitti_converter, scannet_converter,
                               sunrgbd_converter, sunrgbd_total_converter)

DATASETS = ('kitti', 'sunrgbd', 'sunrgbd_monocular', 'sunrgbd_total',
            'scannet', 'scannet_images', 'nuscenes')


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('dataset', choices=DATASETS)
    parser.add_argument('--root-path', required=True)
    parser.add_argument('--splits', nargs='+', default=['train', 'val'])
    parser.add_argument('--max-frames', type=int, default=300)
    parser.add_argument('--workers', type=int, default=8)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    root = args.root_path
    if args.dataset == 'kitti':
        for split in args.splits:
            kitti_converter.create_kitti_infos(root, split, args.workers)
    elif args.dataset in ('sunrgbd', 'sunrgbd_monocular'):
        for split in args.splits:
            sunrgbd_converter.create_sunrgbd_infos(
                root, split, monocular=args.dataset.endswith('monocular'),
                num_workers=args.workers)
    elif args.dataset == 'sunrgbd_total':
        for split in args.splits:
            sunrgbd_total_converter.convert_total_sunrgbd(os.path.join(
                root, f'sunrgbd_total_infos_{split}.json'))
    elif args.dataset == 'scannet_images':
        scannet_converter.extract_posed_images(root, args.max_frames,
                                               args.workers)
    elif args.dataset == 'scannet':
        for split in args.splits:
            scannet_converter.create_scannet_infos(root, split)
    else:
        raise SystemExit(
            'nuScenes info generation needs the nuscenes-devkit; '
            'run the reference converter or install the devkit.')


if __name__ == '__main__':
    main()
