"""The system under test: the only module of the benchmark that imports
``imvoxelnet_tpu_torch``.

It builds the port's detector from a configuration file (the port's preset
of that name is the skeleton; every field the file gives overrides it, so
the file is the configuration as run), loads the benchmark's weights into
it, and hands out the two timed entries: the serving call
(``ImVoxelNet.forward`` then ``imvoxelnet_predict``, bfloat16 convs, no
gradient) and the training step of ``parallel/train.make_train_step``.
The kernel names are the program's (``kernels/csrc/*.cu``); the roofline
readers look for them in the trace.
"""

from __future__ import annotations

import dataclasses

import torch

from imvoxelnet_tpu_torch import kernels
from imvoxelnet_tpu_torch.configs.presets import get_preset
from imvoxelnet_tpu_torch.models import detector
from imvoxelnet_tpu_torch.parallel import train as train_lib
from imvoxelnet_tpu_torch.utils.precision import compute_precision

# device kernels of the port, by the names the trace gives them
B1_FORWARD = ('backproject_vec_kernel', 'backproject_row_kernel')
B1_BACKWARD = ('grad_count_kernel', 'grad_scan_kernel', 'grad_fill_kernel',
               'grad_sum_kernel')
B3 = ('conv_wgmma_kernel', 'split3_kernel')


def _update(obj, values: dict):
    """``obj`` (a frozen dataclass) with every field ``values`` names
    replaced, recursively; lists become tuples."""
    def conv(v):
        return tuple(conv(x) for x in v) if isinstance(v, list) else v
    changes = {}
    for key, value in values.items():
        if not any(f.name == key for f in dataclasses.fields(obj)):
            raise ValueError(f'{type(obj).__name__} has no field {key!r}')
        current = getattr(obj, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            changes[key] = _update(current, value)
        else:
            changes[key] = conv(value)
    return dataclasses.replace(obj, **changes)


def model_config(config: dict):
    """The port's ``ImVoxelNetConfig`` of a configuration file."""
    return _update(get_preset(config['preset']).model, config['model'])


def build_kernels(device) -> None:
    """Build (first run in a checkout) or load the kernels' libraries."""
    if torch.device(device).type == 'cuda':
        kernels.build.build_all()


def build_model(config: dict, state_dict: dict, device):
    """The port's detector of ``config`` holding ``state_dict`` (copied),
    in eval mode."""
    cfg = model_config(config)
    with torch.device('meta'):
        model = detector.ImVoxelNet(cfg)
    model.load_state_dict({k: v.to(device, copy=True)
                           for k, v in state_dict.items()}, assign=True)
    return model.eval()


def serve_call(model):
    """``call(batch) -> (detections, head_outs, valid)``: the serving entry
    at the model's precision, no gradient."""
    cfg = model.cfg

    def call(batch):
        with compute_precision(cfg.compute_dtype), torch.no_grad():
            head_outs, valid = model(batch)
            dets = detector.imvoxelnet_predict(cfg, head_outs, valid,
                                               batch['origins'])
        return dets, head_outs, valid
    return call


def train_step(model, config: dict):
    """``(step, optimizer)``: the port's optimizer for ``config['train']``
    and its training step on ``model``."""
    t = config['train']
    optimizer, scheduler = train_lib.make_optimizer(
        model, t['lr'], t['weight_decay'], t['backbone_lr_mult'],
        t['grad_clip_norm'], steps_per_epoch=t['steps_per_epoch'],
        lr_steps=tuple(t['lr_steps']))
    return train_lib.make_train_step(model, optimizer, scheduler), optimizer


# the layer spans of a traced run: (span, attribute of the model)
SERVE_MODULES = (('backbone_fpn', 'backbone'), ('backbone_fpn', 'neck'),
                 ('neck3d', 'neck_3d'), ('head_decode', 'bbox_head'))
TRAIN_MODULES = (('backbone_fpn', 'backbone'), ('backbone_fpn', 'neck'),
                 ('neck3d', 'neck_3d'), ('head', 'bbox_head'))


# the loss call inside the training step: the traced run's targets_loss span
LOSS_CALL = (train_lib, 'imvoxelnet_loss')
