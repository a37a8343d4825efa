"""Serve one sample of a split and draw its detections, on one card.

    python -m imvoxelnet_tpu_torch.tools.demo PRESET --data-root R \\
        --ann-file A [--index 0] [--checkpoint latest.pth | \\
        --torch-checkpoint X.pth] [--out-dir work_dirs/demo] [--obj] \\
        [--device cuda]

Counterpart of the JAX package's ``tools/demo.py`` (the reference's
``apis/inference.py`` + ``MultiViewMixin.show``): sample ``--index`` of
the preset's test-mode dataset through ``apis.init_detector`` /
``inference_detector`` (the card unless ``--device cpu``), its detections
drawn into every view (``utils/visualize.py:show_multi_view_result``,
``{index}_{view}.png``) and, with ``--obj``, written as a MeshLab
wireframe (``{index}.obj``).  Without a checkpoint the weights are random
from seed 0.  Needs cv2 for the drawing.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import apis
from ..eval import runner
from ..utils.visualize import export_boxes_obj, show_multi_view_result


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset')
    parser.add_argument('--data-root', required=True)
    parser.add_argument('--ann-file', required=True)
    parser.add_argument('--index', type=int, default=0)
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--torch-checkpoint', default=None)
    parser.add_argument('--out-dir', default='work_dirs/demo')
    parser.add_argument('--obj', action='store_true',
                        help='also export a MeshLab .obj wireframe')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None):
    """Run the demo; returns the detections and the files written."""
    args = parse_args(argv)
    preset, model = apis.init_detector(args.preset, args.checkpoint,
                                       args.torch_checkpoint,
                                       device=args.device)
    dataset, _ = runner.build_val_dataset(
        preset, args.preset, args.data_root, args.ann_file, num_workers=1,
        device=args.device)
    sample = dataset.get_sample(args.index, False, np.random.RandomState(0))
    res = apis.inference_detector(
        preset, model, sample['images'], sample['intrinsics'],
        sample['extrinsics'], sample['origin'], sample['ori_shape'],
        sample['img_shape'])
    top = np.sort(res['scores'])[::-1][:5].round(3).tolist()
    print(f'{len(res["scores"])} detections; top scores: {top}')
    paths = show_multi_view_result(dataset, args.index, res['boxes'],
                                   args.out_dir)
    if args.obj:
        paths.append(export_boxes_obj(
            res['boxes'], os.path.join(args.out_dir, f'{args.index}.obj')))
    print('wrote:', *paths, sep='\n  ')
    return dict(detections=res, paths=paths)


if __name__ == '__main__':
    main()
