"""What the ``pre_nms_k=256`` truncation of the indoor NMS costs in mAP.

    python -m imvoxelnet_tpu_torch.tools.eval_nms_truncation [--scenes 200]
        [--train-scenes 32] [--steps 200] [--batch-size 8]
        [--pre-nms-k 256] [--seed 0] [--device cuda] [--root DIR]

Counterpart of the JAX package's ``tools/eval_nms_truncation.py``.  The
indoor decode keeps the top ``pre_nms_k`` candidates per class before the
rotated NMS, where the reference's ``box3d_multiclass_nms`` takes all of
them; this measures what the tail is worth under the protocol.  A
synthetic multi-class SUN RGB-D split (class-colored rectangles at the
boxes' projections, :func:`make_scene`, the JAX tool's writer: JPEG frames
through cv2, which it needs) trains a tiny ``_fast``-style v1 model with
the port's step for ``--steps`` steps, so that its scores are realistic and
imperfect (hundreds of candidates a class above ``score_thr`` 0); then each
val batch runs one forward and two decodes, truncated and exact
(``pre_nms_k=0``: B2's pairwise entry once and the scan, on the card), and
both go through ``eval/indoor_eval.py`` at mAP@0.25 and @0.15.  The
frames are resized to 341 x 256 (:data:`IMAGES`), not the JAX tool's
320 x 240.  Prints the
two mAPs, their difference and the exact decode's detections a scene; the
launches of each decode's first call are in the returned summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import tempfile

import numpy as np
import torch

from .. import kernels
from ..data.datasets import SunRgbdMultiViewDataset
from ..data.loader import DataLoader, to_device
from ..data.pipeline import ImagePipelineConfig
from ..eval.indoor_eval import indoor_eval
from ..models.detector import (ImVoxelNetConfig, NeckConfig, build_model,
                               imvoxelnet_predict)
from ..models.heads.imvoxel_heads import IndoorHeadConfig
from ..parallel import train as train_lib
from .make_synthetic_kitti import fill_rect

FX, CX, CY = 400.0, 320.0, 240.0
CLASSES = ('bed', 'table', 'chair')
# distinct base colors per class (BGR); intensity jittered per box
COLORS = ((255, 80, 80), (80, 255, 80), (80, 80, 255))
# the JAX tool resizes the 640x480 frames to 320x240, an exact 2x
# downscale, which cv2 serves with INTER_AREA and the port's resize does
# not (data/image_io.py): 341x256, padded to 352x256, as
# tools/validate_learning.py does
IMAGES = ImagePipelineConfig(test_scale=(352, 256), pad_size=(256, 352))


def make_scene(rng, root, idx):
    """One synthetic SUN RGB-D sample: boxes in the depth frame + an image
    with class-colored blobs at their projected locations."""
    import cv2
    n = rng.randint(2, 7)
    boxes, labels = [], []
    img = rng.randint(0, 60, (480, 640, 3)).astype(np.uint8)
    for _ in range(n):
        c = rng.randint(len(CLASSES))
        size = rng.uniform(0.6, 1.4, 3)
        center = np.array([rng.uniform(-1.5, 1.5), rng.uniform(2.5, 5.5),
                           rng.uniform(-1.0, 0.2)])
        yaw = rng.uniform(-np.pi / 2, np.pi / 2)
        box = np.concatenate([center - [0, 0, size[2] / 2], size, [yaw]])
        gc = np.array([box[0], box[1], box[2] + box[5] / 2])
        cam = np.array([gc[0], -gc[2], gc[1]])       # (x, -z, y), Rt = I
        u = int(FX * cam[0] / cam[2] + CX)
        v = int(FX * cam[1] / cam[2] + CY)
        # apparent size ~ focal * metric size / depth
        hw = max(8, int(FX * size[0] / (2 * cam[2])))
        hh = max(8, int(FX * size[2] / (2 * cam[2])))
        tint = rng.uniform(0.4, 1.0)                  # imperfect evidence
        color = tuple(int(ch * tint) for ch in COLORS[c])
        fill_rect(img, (u - hw, v - hh), (u + hw, v + hh), color)
        boxes.append(box)
        labels.append(c)
    path = f'image/{idx:06d}.jpg'
    cv2.imwrite(os.path.join(root, path), img)
    boxes = np.asarray(boxes, np.float64)
    k_colmajor = np.array([[FX, 0, 0], [0, FX, 0], [CX, CY, 1]], np.float64)
    info = dict(
        image=dict(image_idx=idx, image_path=path,
                   image_shape=np.array([480, 640], np.int32)),
        calib=dict(K=k_colmajor.reshape(-1), Rt=np.eye(3)),
        annos=dict(gt_num=n, gt_boxes_upright_depth=boxes,
                   name=np.array([CLASSES[c] for c in labels]),
                   **{'class': np.asarray(labels)}),
    )
    return info, dict(boxes=boxes, labels=np.asarray(labels))


def tiny_config(pre_nms_k):
    """The JAX tool's tiny ``_fast``-style model under the ``_fast``
    protocol's test config (``score_thr`` 0 floods the NMS with every
    candidate, where the truncation bites hardest)."""
    head = IndoorHeadConfig(
        n_classes=len(CLASSES), n_reg_outs=7, voxel_size=(0.32, 0.32, 0.32),
        dataset='sunrgbd', version=1, centerness_topk=18,
        nms_pre=1000, score_thr=0.0, iou_thr=0.15, max_out=1000,
        pre_nms_k=pre_nms_k)
    return ImVoxelNetConfig(
        n_voxels=(20, 20, 8), voxel_size=(0.32, 0.32, 0.32),
        fpn_out_channels=16,
        neck=NeckConfig(kind='fast', in_channels=16, out_channels=16,
                        n_blocks=(1, 1, 1)),
        head_kind='indoor', anchor_head=None, indoor_head=head,
        backbone_stage_blocks=(1, 1, 1, 1))


class TrainView:
    """The first ``n`` samples of a dataset, for the loader."""

    def __init__(self, base, n):
        self.base, self.n = base, n

    def __len__(self):
        return self.n

    def get_sample(self, i, train, srng):
        return self.base.get_sample(i, train, srng)

    def collate(self, samples):
        return self.base.collate(samples)


def collect(pred):
    out = []
    for b in range(pred['valid'].shape[0]):
        v = pred['valid'][b].cpu().numpy()
        out.append(dict(boxes=pred['boxes'][b].cpu().numpy()[v],
                        scores=pred['scores'][b].cpu().numpy()[v],
                        labels=pred['labels'][b].cpu().numpy()[v]))
    return out


def run(args, root):
    device = torch.device(args.device)
    rng = np.random.RandomState(args.seed)
    os.makedirs(os.path.join(root, 'image'), exist_ok=True)
    n_total = args.train_scenes + args.scenes
    infos, gts = [], []
    for i in range(n_total):
        info, gt = make_scene(rng, root, i)
        infos.append(info)
        gts.append(gt)
    with open(os.path.join(root, 'infos.pkl'), 'wb') as f:
        pickle.dump(infos, f)
    print(f'{args.train_scenes} train + {args.scenes} val scenes at {root}')

    ds = SunRgbdMultiViewDataset(root, os.path.join(root, 'infos.pkl'),
                                 CLASSES, IMAGES, max_gt=8)
    cfg = tiny_config(args.pre_nms_k)
    model = build_model(cfg, device=device, seed=args.seed)
    optimizer, scheduler = train_lib.make_optimizer(model, 3e-3, 1e-4, 0.1,
                                                    35.0, 1000)
    step = train_lib.make_train_step(model, optimizer, scheduler)
    loader = DataLoader(TrainView(ds, args.train_scenes), args.batch_size,
                        train=True, num_workers=4)
    k = 0
    while k < args.steps:
        for batch in loader.epoch(k // max(1, len(loader))):
            m = step(to_device(batch, device))
            k += 1
            if k % 50 == 0 or k == args.steps:
                print(f'step {k}:',
                      {n: round(float(x), 4) for n, x in m.items()},
                      flush=True)
            if k >= args.steps:
                break

    exact_cfg = dataclasses.replace(
        cfg, indoor_head=dataclasses.replace(cfg.indoor_head, pre_nms_k=0))
    model.eval()
    val_gts, trunc_dets, exact_dets, launches = [], [], [], {}
    vrng = np.random.RandomState(1)
    batch_idx = list(range(args.train_scenes, n_total))
    for s in range(0, len(batch_idx), args.batch_size):
        idxs = batch_idx[s:s + args.batch_size]
        batch = to_device(ds.collate([ds.get_sample(i, False, vrng)
                                      for i in idxs]), device)
        with torch.no_grad():
            head_outs, valid = model(batch)
            for name, c, dets in (('truncated', cfg, trunc_dets),
                                  ('exact', exact_cfg, exact_dets)):
                kernels.reset_launch_counts()
                pred = imvoxelnet_predict(c, head_outs, valid,
                                          batch['origins'])
                dets.extend(collect(pred)[:len(idxs)])
                launches.setdefault(name, kernels.launch_counts())
        val_gts.extend(gts[i] for i in idxs)
        if (s // args.batch_size) % 5 == 0:
            print(f'decoded {s + len(idxs)}/{len(batch_idx)} val scenes',
                  flush=True)

    results = {}
    trunc = f'pre_nms_k={args.pre_nms_k}'
    for name, dets in (('exact', exact_dets), (trunc, trunc_dets)):
        m = indoor_eval(val_gts, dets, CLASSES, iou_thrs=(0.25, 0.15),
                        device=device)
        results[name] = {k: v for k, v in m.items() if k.startswith('mAP')}
        print(name, {k: round(v, 4) for k, v in results[name].items()})
    deltas = {}
    for thr in ('0.25', '0.15'):
        key = f'mAP_{thr}'
        deltas[key] = results[trunc][key] - results['exact'][key]
        print(f'delta {key}: {deltas[key]:+.4f} '
              f'(exact {results["exact"][key]:.4f})')
    n_det = [len(d['boxes']) for d in exact_dets]
    print(f'mean detections/scene (exact): {np.mean(n_det):.1f}, '
          f'max {max(n_det)}')
    return dict(mAP=results, delta=deltas, launches=launches,
                mean_detections_exact=float(np.mean(n_det)),
                max_detections_exact=max(n_det))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--scenes', type=int, default=200,
                        help='val split size')
    parser.add_argument('--train-scenes', type=int, default=32)
    parser.add_argument('--steps', type=int, default=200)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--pre-nms-k', type=int, default=256,
                        help='the truncation under test')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--root', default=None,
                        help='where the split is written (default: a '
                             'temporary directory)')
    return parser


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        parser.error('no CUDA device (pass --device cpu to run on the CPU)')
    if args.root:
        out = run(args, args.root)
    else:
        with tempfile.TemporaryDirectory(prefix='nms_truncation_') as root:
            out = run(args, root)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
