"""High-level inference API on one card.

Counterpart of ``imvoxelnet_tpu/apis.py`` (``mmdet3d/apis/inference.py:
17-89``, ``init_detector`` / ``inference_detector``): build a model from a
preset, load a checkpoint (the port's train state, or a reference ``.pth``)
and serve one scene, returning numpy detections.  The weights live in the
model, so there is no ``variables`` and no ``forward`` to hand around.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.presets import get_preset
from .data.loader import to_device
from .eval import runner
from .models.detector import build_model
from .utils import checkpoint as ckpt_lib
from .utils.precision import compute_precision


def init_detector(preset_name: str, checkpoint: str = None,
                  torch_checkpoint: str = None, device='cuda'):
    """The preset's model on ``device`` (the card unless the caller asks
    for the CPU), in eval mode: with the weights of ``torch_checkpoint`` (a
    reference mmdet ``.pth``) or ``checkpoint`` (``tools/train.py``'s
    ``latest.pth``), else seeded from 0 as ``build_model`` seeds them.
    Returns ``(preset, model)``."""
    preset = get_preset(preset_name)
    model = build_model(preset.model, device='cpu', seed=0)
    path = torch_checkpoint or checkpoint
    if path:
        model.load_state_dict(ckpt_lib.load_reference_state_dict(path),
                              strict=True)
    return preset, model.to(device)


def inference_detector(preset, model, images, intrinsic, extrinsics, origin,
                       ori_shape, img_shape):
    """Serve one scene on the model's device, under the preset's precision.

    Args:
      images: ``(V, H, W, 3)`` normalized and padded (float32, or the
        preset's compute dtype); intrinsic ``(3, 3)``; extrinsics
        ``(V, 4, 4)``; origin ``(3,)``; ori_shape / img_shape ``(2,)``
        ints (h, w).

    Returns a dict of numpy ``boxes (N, 7)``, ``scores (N,)``, ``labels
    (N,)`` of the kept detections, and for a layout-head preset the
    ``angles`` and ``layout`` it predicts."""
    cfg = preset.model
    device = next(model.parameters()).device
    batch = dict(
        images=torch.as_tensor(np.asarray(images))[None],
        intrinsics=torch.as_tensor(np.asarray(intrinsic, np.float32))[None],
        extrinsics=torch.as_tensor(np.asarray(extrinsics, np.float32))[None],
        origins=torch.as_tensor(np.asarray(origin, np.float32))[None],
        img_shape=torch.as_tensor(np.asarray(img_shape, np.int32))[None],
        ratios=torch.tensor(
            [float(ori_shape[0]) / (float(img_shape[0]) / 4.0)],
            dtype=torch.float32))
    model.eval()
    with compute_precision(cfg.compute_dtype):
        out = runner.forward(model, cfg, to_device(batch, device))
    out = {k: v[0].cpu().numpy() for k, v in out.items()}
    valid = out['valid']
    res = {k: out[k][valid] for k in ('boxes', 'scores', 'labels')}
    for key in ('angles', 'layout'):
        if key in out:
            res[key] = out[key]
    return res
