"""Export a preset's serving forward as a ``torch.export`` program (.pt2).

    python -m imvoxelnet_tpu_torch.tools.export PRESET --out F.pt2 \\
        [--checkpoint latest.pth | --torch-checkpoint ref.pth] \\
        [--batch-size 1] [--poly-batch] [--bake-weights] [--verify] \\
        [--override PATH=VALUE] [--device cuda]

Counterpart of the JAX package's ``tools/export.py``: the forward +
decode/NMS (``utils/export.py``, fixed-size outputs) traced once on the
device that will serve (the card unless ``--device cpu``), its kernels as
``torch.ops.imvx`` operators, saved with ``torch.export.save``.  Without
``--bake-weights`` the program takes the model's ``state_dict`` as its
first input and holds no weights.  ``--poly-batch`` exports a symbolic
batch dimension (``--batch-size``, at least 2, then sizes the traced and
the ``--verify`` batch).  ``--verify`` loads the artifact in the same
process (``utils/export.load_exported``) and holds its detections on the
example batch to the eager forward's (labels and ``valid`` exactly, boxes
and scores within 1e-5).  The weights are random from seed 0 unless a
checkpoint is given; the batch is ``utils/export.example_batch``.  A
float32 preset is traced and run with TF32 off.  Prints one JSON line.

The JAX tool's ``--platforms``, ``--view-sharded`` and ``--data-sharded``
are left out: a program here is traced for one card, and the multi-card
programs wait for the port's multi-card support.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..configs.presets import apply_overrides, get_preset
from ..models.detector import build_model
from ..utils import checkpoint as ckpt_lib
from ..utils import export as export_lib
from ..utils.precision import compute_precision


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset', nargs='?', default='imvoxelnet_kitti')
    parser.add_argument('--out', required=True)
    parser.add_argument('--batch-size', type=int, default=None,
                        help='samples of the traced batch (default 1; 2 '
                             'with --poly-batch)')
    parser.add_argument('--poly-batch', action='store_true',
                        help='export with a symbolic batch dim: one program '
                             'serves any batch size')
    parser.add_argument('--checkpoint', default=None,
                        help="the port's train state (tools/train.py's "
                             "latest.pth)")
    parser.add_argument('--torch-checkpoint', default=None,
                        help='reference mmdet checkpoint (.pth)')
    parser.add_argument('--bake-weights', action='store_true',
                        help='store the weights in the program (one-file '
                             'deploy)')
    parser.add_argument('--verify', action='store_true',
                        help='load the program and check it against the '
                             'eager forward')
    parser.add_argument('--override', action='append', default=None,
                        metavar='PATH=VALUE',
                        help='preset field override, e.g. '
                             'model.indoor_head.score_thr=0.1 (repeatable)')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None):
    """Export (and verify); prints and returns the summary dict."""
    args = parse_args(argv)
    preset = get_preset(args.preset)
    if args.override:
        preset = apply_overrides(preset, args.override)
    cfg = preset.model
    b = args.batch_size or (2 if args.poly_batch else 1)
    w, h = preset.data.test_size
    batch = export_lib.example_batch(b, preset.data.n_images_test, h, w,
                                     device=args.device)
    model = build_model(cfg, device='cpu', seed=0)
    path = args.checkpoint or args.torch_checkpoint
    if path:
        model.load_state_dict(ckpt_lib.load_reference_state_dict(path),
                              strict=True)
    model.to(args.device).eval()

    with compute_precision(cfg.compute_dtype):
        exported = export_lib.export_serving(
            cfg, model, batch, bake_variables=args.bake_weights,
            batch_size=None if args.poly_batch else b)
        size = export_lib.save_exported(exported, args.out)
        verified = None
        if args.verify:
            loaded = export_lib.load_exported(args.out).module()
            state = model.state_dict()
            with torch.no_grad():
                got = (loaded(batch) if args.bake_weights
                       else loaded(state, batch))
                want = export_lib.make_serving_fn(cfg, model)(state, batch)
            for key, ref in want.items():
                if ref.dtype in (torch.bool, torch.int32, torch.int64):
                    if not torch.equal(got[key], ref):
                        raise AssertionError(f'--verify: {key} differs')
                else:
                    torch.testing.assert_close(got[key], ref, rtol=1e-5,
                                               atol=1e-5)
            verified = True
    summary = dict(preset=args.preset, out=args.out, bytes=size,
                   device=str(batch['images'].device), devices=1,
                   weights='baked' if args.bake_weights else 'inputs',
                   outputs=export_lib.output_shapes(exported),
                   verified=verified)
    print(json.dumps(summary))
    return summary


if __name__ == '__main__':
    main()
