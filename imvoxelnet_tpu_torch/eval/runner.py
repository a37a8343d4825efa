"""The validation runner: inference over a val split on one card, then the
dataset's evaluation protocol.

Counterpart of ``imvoxelnet_tpu/eval/runner.py`` (``run_inference``,
``evaluate_results``, ``layout_ious``, ``build_val_dataset``) for one card
and no mesh.  Metric names follow the reference exactly
(``KITTI/{cls}_3D_{difficulty}``, ``{cls}_AP_{thr}``, ``mAP_{thr}``, ``NDS``).

The inference loop keeps the card busy: the loader decodes in its threads,
``data/loader.py:device_prefetch`` copies batch N+1 to the card on a side
stream while batch N runs, and each batch's forward + decode is followed by
one copy of all its outputs to pinned host memory, which is read only after
the next batch's forward has been queued.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import device_prefetch
from ..models.detector import imvoxelnet_predict

# the per-sample outputs of the decode, in their packed order
_OUTPUT_KEYS = ('boxes', 'scores', 'labels', 'valid')
_LAYOUT_KEYS = ('angles', 'layout')


def forward(model, cfg, batch):
    """The forward + decode of one batch (``simple_test``); a layout-head
    model serves on the extrinsics it predicts, as the reference does."""
    with torch.no_grad():
        head_outs, valid, *features_2d = model(
            batch, use_predicted_extrinsics=cfg.layout_head is not None)
        return imvoxelnet_predict(cfg, head_outs, valid, batch['origins'],
                                  *features_2d)


def _pack(out):
    """All of a batch's outputs as one ``(B, n)`` float32 tensor (labels and
    the valid mask are small integers, exact in float32), with what
    :func:`_unpack` needs to split it again."""
    keys = [k for k in _OUTPUT_KEYS + _LAYOUT_KEYS if k in out]
    b = out['scores'].shape[0]
    parts = [out[k].reshape(b, -1) for k in keys]
    spec = [(k, tuple(out[k].shape[1:]), out[k].dtype) for k in keys]
    return torch.cat([p.float() for p in parts], dim=1), spec


def _unpack(host, spec):
    """Per-sample result dicts of numpy arrays from a packed host batch:
    ``boxes``, ``scores`` and ``labels`` of the valid detections, and
    ``angles`` / ``layout`` for a layout-head model."""
    arrays, col = {}, 0
    b = host.shape[0]
    for key, shape, dtype in spec:
        n = int(np.prod(shape))
        arrays[key] = host[:, col:col + n].reshape((b,) + shape).to(
            dtype).numpy()
        col += n
    results = []
    for i in range(b):
        valid = arrays['valid'][i]
        res = {k: arrays[k][i][valid] for k in ('boxes', 'scores', 'labels')}
        for key in _LAYOUT_KEYS:
            if key in arrays:
                res[key] = arrays[key][i]
        results.append(res)
    return results


def run_inference(model, cfg, loader, n_samples, device='cuda'):
    """The forward + decode over one epoch of ``loader`` on ``device`` (the
    card unless the caller passes the CPU), one batch at a time, the ragged
    last batch served as it comes.

    Returns a list of per-sample dicts with numpy ``boxes/scores/labels``
    (+ ``angles``/``layout`` for Total3D presets)."""
    device = torch.device(device)
    results, pending = [], None
    for batch in device_prefetch(loader.epoch(0), device):
        packed, spec = _pack(forward(model, cfg, batch))
        if device.type == 'cuda':
            # one copy to pinned memory, waited for a batch later
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = packed, None
        if pending is not None:
            results += _finish(*pending)
        pending = (host, done, spec)
    if pending is not None:
        results += _finish(*pending)
    return results[:n_samples]


def _finish(host, done, spec):
    if done is not None:
        done.synchronize()
    return _unpack(host, spec)


def _gt_annos(dataset):
    gt_annos = []
    for i in range(len(dataset.data_infos)):
        ann = dataset.get_ann_info(i)
        gt_annos.append(dict(boxes=ann['gt_bboxes_3d'],
                             labels=ann['gt_labels_3d']))
    return gt_annos


def evaluate_results(preset, preset_name, dataset, results, device='cuda'):
    """Dispatch to the dataset's evaluation protocol; returns a flat metric
    dict with reference metric names.  The indoor protocol's IoUs and the
    Total3D ``layout_iou`` are computed on ``device``."""
    d = preset.data
    if d.dataset == 'kitti':
        from .kitti_eval import convert_to_kitti_annos, kitti_eval
        dt_annos = convert_to_kitti_annos(results, dataset.data_infos,
                                          d.classes)
        gt_annos = [info['annos'] for info in dataset.data_infos]
        return kitti_eval(gt_annos, dt_annos, list(d.classes),
                          eval_types=('bbox', 'bev', '3d'))

    if d.dataset == 'nuscenes':
        from .nuscenes_eval import nuscenes_nds
        return nuscenes_nds(_gt_annos(dataset), results, d.classes)

    from .indoor_eval import indoor_eval
    # SunRgbdPerspectiveMultiViewDataset / Total3D evaluate at IoU 0.15
    # (reference sunrgbd_monocular_dataset.py:84-99, :103-151)
    iou_thrs = ((0.15,) if ('perspective' in preset_name
                            or 'total' in preset_name) else (0.25, 0.5))
    metrics = indoor_eval(_gt_annos(dataset), results, d.classes, iou_thrs,
                          device=device)
    if preset.model.layout_head is not None:
        gt_angles = np.stack([info['angles'] for info in dataset.data_infos])
        pr = np.stack([r['angles'] for r in results])
        metrics['pitch_mae'] = float(
            np.mean(np.abs(pr[:, 0] - gt_angles[:, 0])) * 180 / np.pi)
        metrics['roll_mae'] = float(
            np.mean(np.abs(pr[:, 1] - gt_angles[:, 1])) * 180 / np.pi)
        # layout_iou (sunrgbd_monocular_dataset.py:141-151): per-sample
        # rotated 3D IoU between the predicted layout box and the GT layout,
        # both bottom-center
        metrics['layout_iou'] = float(np.mean(layout_ious(
            np.stack([r['layout'] for r in results]),
            np.stack([info['layout'] for info in dataset.data_infos]),
            device=device)))
    return metrics


def layout_ious(pred_layouts_gc, gt_layouts_stored, device='cuda'):
    """Aligned rotated-3D IoUs between predicted layout boxes
    (gravity-center, the LayoutHead output) and stored GT layouts (origin
    ``(.5, .5, .5)``), the ``DepthInstance3DBoxes.overlaps`` call of
    ``sunrgbd_monocular_dataset.py:141-148``: one pairwise IoU call over
    the ``S`` samples as groups, ``(S, 1)`` x ``(S, 1)`` boxes."""
    pred = np.asarray(pred_layouts_gc, np.float32).copy()
    pred[:, 2] -= pred[:, 5] / 2
    gt = np.asarray(gt_layouts_stored, np.float32).copy()
    gt[:, 2] -= gt[:, 5] / 2
    from ..ops import iou as iou_ops
    with torch.no_grad():
        iou = iou_ops.bbox_overlaps_3d(
            torch.from_numpy(pred[:, None]).to(device),
            torch.from_numpy(gt[:, None]).to(device))
    return iou[:, 0, 0].cpu().numpy()


def build_val_dataset(preset, preset_name, data_root, ann_file, num_workers=4,
                      batch_size=1, device='cuda'):
    """Test-mode dataset + loader for a preset's val split.  A bfloat16
    preset's images are cast on the host; for a CUDA ``device`` the
    loader's batches are pinned."""
    from ..data.datasets import DATASETS
    from ..data.loader import DataLoader
    from ..data.pipeline import ImagePipelineConfig

    d = preset.data
    img_cfg = ImagePipelineConfig(
        test_scale=d.test_size, pad_size=(d.test_size[1], d.test_size[0]),
        fixed_size_resize=(d.dataset == 'scannet'))
    ds_key = d.dataset
    if preset.model.layout_head is not None:
        ds_key = 'sunrgbd_total'
    dataset = DATASETS[ds_key](
        data_root, ann_file, d.classes, img_cfg,
        n_images=d.n_images_test, max_gt=d.max_gt, test_mode=True)
    images_dtype = (torch.bfloat16 if preset.model.compute_dtype == 'bfloat16'
                    else None)
    loader = DataLoader(dataset, batch_size, train=False,
                        num_workers=num_workers, drop_last=False,
                        images_dtype=images_dtype,
                        pin_memory=torch.device(device).type == 'cuda')
    return dataset, loader
