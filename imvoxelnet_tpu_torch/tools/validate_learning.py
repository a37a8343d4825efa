"""Learning loops: overfit one fabricated scene and require the detector to
find its object.

    python -m imvoxelnet_tpu_torch.tools.validate_learning \\
        --family {kitti,indoor,scannet,total3d,nuscenes,all} [--device cuda]

Counterpart of the JAX package's ``tools/validate_learning.py`` (KITTI),
``validate_learning_indoor.py``, ``_scannet.py``, ``_total3d.py`` and
``_nuscenes.py``: each family writes its script's scene (one object and a
bright blob at its projection; ``utils/synthetic_splits.py``), trains its
script's tiny config on that one sample with ``make_optimizer(lr, 1e-4,
0.1, 35.0, epoch_steps)`` for 240 steps (Total3D 300), then serves it
through ``eval/runner.py`` (Total3D on the extrinsics it predicts) and
scores it with the dataset's protocol against its script's criterion.
Every layer of the port runs: info file -> dataset geometry ->
backprojection -> model -> targets and losses -> decode and NMS ->
protocol.

``lr`` and ``epoch_steps`` are the scripts' 3e-3 and 1000 (the LR steps
at epochs 8 and 11 fall past the loop's end) but for Total3D, whose loop
runs at 5e-4 with epochs of 25 steps (x0.1 at step 200, x0.01 at 275).
At 3e-3 the layout head diverges for some initial weights and scenes, in
the JAX package as in the port: the angles oscillate, or the layout's
exponentiated sizes overflow to NaN.  From the same initial weights on the
same batch both packages pass or both diverge.  This module's scene (its
frames at the script's 320x240, the GT box centred on its blob) diverges
at 3e-3 from the JAX ``PRNGKey(seed)`` weights of every seed 0-3, in both
packages, where the script passes on its own scene from ``PRNGKey(0)``;
at 5e-4 with the steps all eight runs pass (PERF_APPENDIX.md;
``tests/_torch_port_total3d_lr.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from ..configs.presets import DataConfig, Preset, get_preset
from ..data import datasets
from ..data.loader import DataLoader, to_device
from ..data.pipeline import ImagePipelineConfig
from ..eval import runner
from ..models.detector import ImVoxelNetConfig, NeckConfig, build_model
from ..models.heads.anchor3d_head import Anchor3DHeadConfig
from ..models.heads.imvoxel_heads import IndoorHeadConfig
from ..models.heads.layout_head import LayoutHeadConfig
from ..parallel import train as train_lib
from ..utils import synthetic_splits as splits
from ..utils.precision import compute_precision

FAMILIES = ('kitti', 'indoor', 'scannet', 'total3d', 'nuscenes')
# the scripts' optimizer but its LR and epoch (the family's): AdamW, wd
# 1e-4, backbone x0.1, clip 35
OPTIMIZER = (1e-4, 0.1, 35.0)


def _indoor_cfg(dataset, n_reg_outs, layout=False):
    """The indoor scripts' tiny config: the fast neck, head v1, 16x16x8
    voxels of 0.4 m, one class."""
    return ImVoxelNetConfig(
        n_voxels=(16, 16, 8), voxel_size=(0.4, 0.4, 0.4),
        fpn_out_channels=16,
        neck=NeckConfig(kind='fast', in_channels=16, out_channels=16,
                        n_blocks=(1, 1, 1)),
        head_kind='indoor', anchor_head=None,
        indoor_head=IndoorHeadConfig(
            n_classes=1, n_reg_outs=n_reg_outs, voxel_size=(0.4, 0.4, 0.4),
            dataset=dataset, version=1, nms_pre=128, score_thr=0.05,
            iou_thr=0.15, max_out=8, pre_nms_k=32),
        layout_head=LayoutHeadConfig(linear_size=64) if layout else None)


def _nuscenes_cfg():
    """``validate_learning_nuscenes.py``'s tiny config: the nuScenes neck,
    DCN in stages 3-4, one-block stages, 24x24x12 voxels."""
    head = Anchor3DHeadConfig(
        num_classes=1, feat_channels=32,
        anchor_ranges=((-4.4, -4.4, -1.0, 4.4, 4.4, -1.0),),
        anchor_sizes=((1.98, 4.67, 1.74),), anchor_rotations=(0.0, 1.57),
        dir_offset=0.7854, dir_limit_offset=0.0, loss_bbox_weight=1.0,
        nms_pre=128, score_thr=0.05, iou_thr=0.2, max_out=16)
    return ImVoxelNetConfig(
        n_voxels=(24, 24, 12), voxel_size=(0.4, 0.4, 0.4),
        fpn_out_channels=16,
        neck=NeckConfig(kind='nuscenes', in_channels=16, out_channels=32),
        head_kind='anchor3d', anchor_head=head,
        backbone_stage_blocks=(1, 1, 1, 1),
        stage_with_dcn=(False, False, True, True))


# the indoor scripts' 640x480 frames at 320x240, padded to 320x256
INDOOR_IMAGES = ImagePipelineConfig(test_scale=(320, 256),
                                    pad_size=(256, 320))


@dataclasses.dataclass(frozen=True)
class Family:
    """A learning loop: its scene writer, dataset, image pipeline and
    config, the protocol's preset name and dataset key, its criterion
    ``{metric: (op, bound)}``, its steps, its LR and the steps of an epoch
    of its LR schedule."""
    write: object
    dataset: object
    images: ImagePipelineConfig
    cfg: ImVoxelNetConfig
    name: str
    protocol: str
    classes: tuple
    criteria: dict
    steps: int = 240
    lr: float = 3e-3
    epoch_steps: int = 1000
    n_images: int = 1
    max_gt: int = 4


def families():
    kitti = get_preset('tiny_kitti_test')
    d = kitti.data
    return {
        'kitti': Family(
            splits.kitti_learning_scene, datasets.KittiMultiViewDataset,
            ImagePipelineConfig(test_scale=d.test_size,
                                pad_size=(d.test_size[1], d.test_size[0])),
            kitti.model, 'tiny_kitti_test', 'kitti', ('Car',),
            {'KITTI/Car_BEV_moderate_loose': ('>', 0.0)}, max_gt=8),
        'indoor': Family(
            splits.sunrgbd_learning_scene, datasets.SunRgbdMultiViewDataset,
            INDOOR_IMAGES, _indoor_cfg('sunrgbd', 7), 'imvoxelnet_sunrgbd',
            'sunrgbd', ('bed',), {'mAP_0.25': ('>', 0.99)}),
        'scannet': Family(
            splits.scannet_learning_scene, datasets.ScanNetMultiViewDataset,
            INDOOR_IMAGES, _indoor_cfg('scannet', 6), 'imvoxelnet_scannet',
            'scannet', ('chair',), {'mAP_0.25': ('>', 0.99)}, n_images=3),
        'total3d': Family(
            lambda root: splits.sunrgbd_learning_scene(root, total3d=True),
            datasets.SunRgbdTotalMultiViewDataset, INDOOR_IMAGES,
            _indoor_cfg('sunrgbd', 7, layout=True),
            'imvoxelnet_total_sunrgbd', 'sunrgbd', ('bed',),
            {'mAP_0.15': ('>', 0.99), 'pitch_mae': ('<', 1.5),
             'roll_mae': ('<', 1.5), 'layout_iou': ('>', 0.5)}, steps=300,
            lr=5e-4, epoch_steps=25),
        'nuscenes': Family(
            splits.nuscenes_learning_scene, datasets.NuScenesMultiViewDataset,
            ImagePipelineConfig(test_scale=(320, 192), pad_size=(192, 320)),
            _nuscenes_cfg(), 'imvoxelnet_nuscenes', 'nuscenes', ('car',),
            {'car_AP_dist_2.0': ('>', 0.99), 'car_ATE': ('<', 0.5),
             'NDS': ('>', 0.6)}, n_images=6, max_gt=8),
    }


def scene(family: str, root: str):
    """The family's scene written under ``root``: its dataset (with GT)
    and the dataset's one sample as a host batch."""
    fam = families()[family]
    dataset = fam.dataset(root, fam.write(root), fam.classes, fam.images,
                          n_images=fam.n_images, max_gt=fam.max_gt)
    batch = dataset.collate([dataset.get_sample(0, False,
                                                np.random.RandomState(0))])
    return dataset, batch


def learn(family: str, root: str, device='cuda', steps=None, log_every=60):
    """One learning loop on ``device`` (the card unless the caller asks for
    the CPU): the scene, ``steps`` updates (default the family's) from the
    weights ``build_model`` seeds with 0, the served result scored by the
    protocol.  The updates use cuDNN's deterministic algorithms, so that a
    loop on the card repeats: a few hundred steps of overfitting are
    chaotic, and the atomics of its default algorithms change where they
    end from run to run (PERF.md §6).  Returns the losses at each
    ``log_every`` step and the last, the loop's wall seconds (to the last
    update done on the card), the metrics and whether each criterion
    held."""
    fam = families()[family]
    dataset, host_batch = scene(family, root)
    batch = to_device(host_batch, device)
    model = build_model(fam.cfg, device='cpu', seed=0).to(device)
    optimizer, scheduler = train_lib.make_optimizer(model, fam.lr, *OPTIMIZER,
                                                    fam.epoch_steps)
    step = train_lib.make_train_step(model, optimizer, scheduler)
    steps = fam.steps if steps is None else steps
    losses = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        for i in range(steps):
            metrics = step(batch)
            if i % log_every == 0 or i == steps - 1:
                losses.append(dict(step=i, **{k: float(v)
                                              for k, v in metrics.items()}))
        if torch.device(device).type == 'cuda':
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic

    preset = Preset(name=fam.name, model=fam.cfg,
                    data=DataConfig(dataset=fam.protocol,
                                    classes=fam.classes))
    model.eval()
    loader = DataLoader(dataset, 1, train=False, num_workers=1,
                        drop_last=False)
    with compute_precision(fam.cfg.compute_dtype):
        results = runner.run_inference(model, fam.cfg, loader, 1, device)
        metrics = runner.evaluate_results(preset, fam.name, dataset, results,
                                          device=device)
    held = {k: (metrics[k] > bound if op == '>' else metrics[k] < bound)
            for k, (op, bound) in fam.criteria.items()}
    return dict(family=family, steps=steps, lr=fam.lr, seconds=seconds,
                losses=losses,
                detections=int(len(results[0]['scores'])),
                metrics={k: float(metrics[k]) for k in fam.criteria},
                passed=all(held.values()), held=held)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--family', choices=FAMILIES + ('all',),
                        default='all')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    names = FAMILIES if args.family == 'all' else (args.family,)
    out = []
    for name in names:
        with tempfile.TemporaryDirectory() as root:
            out.append(learn(name, root, args.device))
        print(json.dumps(out[-1]), flush=True)
    failed = [r['family'] for r in out if not r['passed']]
    if failed:
        raise SystemExit(f'learning loops failed: {failed}')
    print('LEARNING LOOPS OK')
    return out


if __name__ == '__main__':
    main()
