"""Evaluate a preset on a validation split with the port, on one card.

    python -m imvoxelnet_tpu_torch.tools.test PRESET --data-root R \\
        --ann-file A [--checkpoint latest.pth | --torch-checkpoint X.pth] \\
        [--batch-size B] [--num-workers N] [--out results.pkl] \\
        [--show-dir D [--show-num 3] [--show-score-thr 0.3]] \\
        [--override PATH=VALUE] [--device cuda]

Counterpart of the JAX package's ``tools/test.py``: info file + image files
-> dataset -> image pipeline -> loader -> forward + decode/NMS on the card
-> per-sample results -> the dataset's protocol, printed as JSON with the
reference's metric names.  ``--checkpoint`` (the port's train state,
``tools/train.py``'s ``latest.pth``) and ``--torch-checkpoint`` (a
reference mmdet checkpoint, ``{'state_dict': ...}`` or a bare state dict)
load through one loader, straight into the model, whose parameter names
are the reference's; without either the weights are
random from seed 0, as the JAX package's are from its ``PRNGKey(0)``.
A float32 preset runs with TF32 off (``utils/precision.py``).
``--show-dir`` (the reference's ``--show``) draws the detections scoring
above ``--show-score-thr`` into every view of the first ``--show-num``
samples (``utils/visualize.py``, which needs cv2) and writes them as
``{index}_{view}.png``, after the inference and the protocol were timed.
"""

from __future__ import annotations

import argparse
import json
import pickle
import time

from ..configs.presets import apply_overrides, get_preset
from ..eval import runner
from ..models.detector import build_model
from ..utils import checkpoint as ckpt_lib
from ..utils.precision import compute_precision


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset')
    parser.add_argument('--data-root', required=True)
    parser.add_argument('--ann-file', required=True)
    parser.add_argument('--checkpoint', default=None,
                        help="the port's train state (tools/train.py's "
                             "latest.pth) to load")
    parser.add_argument('--torch-checkpoint', default=None,
                        help='reference mmdet checkpoint (.pth) to load')
    parser.add_argument('--batch-size', type=int, default=1)
    parser.add_argument('--num-workers', type=int, default=8)
    parser.add_argument('--out', default=None, help='dump results pkl')
    parser.add_argument('--show-dir', default=None,
                        help='render predicted wireframes into each view of '
                             'the first --show-num samples')
    parser.add_argument('--show-num', type=int, default=3)
    parser.add_argument('--show-score-thr', type=float, default=0.3)
    parser.add_argument('--override', action='append', default=None,
                        metavar='PATH=VALUE',
                        help='preset field override, e.g. '
                             'model.indoor_head.score_thr=0.1 (repeatable)')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None):
    """Run the evaluation; prints and returns a summary: ``metrics``,
    ``n_samples``, ``n_batches``, ``inference_s`` (loader + forward +
    decode, to the last result on the host) and ``eval_s`` (the
    protocol)."""
    args = parse_args(argv)
    preset = get_preset(args.preset)
    if args.override:
        preset = apply_overrides(preset, args.override)
    cfg = preset.model
    dataset, loader = runner.build_val_dataset(
        preset, args.preset, args.data_root, args.ann_file,
        num_workers=args.num_workers, batch_size=args.batch_size,
        device=args.device)
    model = build_model(cfg, device='cpu', seed=0)
    path = args.checkpoint or args.torch_checkpoint
    if path:
        model.load_state_dict(ckpt_lib.load_reference_state_dict(path),
                              strict=True)
    model.to(args.device)

    with compute_precision(cfg.compute_dtype):
        t0 = time.perf_counter()
        results = runner.run_inference(model, cfg, loader,
                                       len(dataset.data_infos), args.device)
        t1 = time.perf_counter()
        metrics = runner.evaluate_results(preset, args.preset, dataset,
                                          results, device=args.device)
        t2 = time.perf_counter()
    print(f'inference done: {len(results)} samples in {t1 - t0:.3f} s')
    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
    shown = []
    if args.show_dir:
        from ..utils.visualize import show_multi_view_result
        for idx in range(min(args.show_num, len(results))):
            r = results[idx]
            keep = r['scores'] > args.show_score_thr
            paths = show_multi_view_result(dataset, idx, r['boxes'][keep],
                                           args.show_dir)
            print('wrote:', *paths, sep='\n  ')
            shown += paths
    print(json.dumps(metrics, indent=2))
    return dict(metrics=metrics, results=results, n_samples=len(results),
                n_batches=len(loader), inference_s=t1 - t0, eval_s=t2 - t1,
                shown=shown)


if __name__ == '__main__':
    main()
