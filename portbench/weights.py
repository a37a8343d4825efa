"""Seeded weights, made on the device in one draw, and handed as one
``state_dict`` to the program and to the reference alike.

The scheme is the port's preset init (``models/detector.py:init_weights``)
with its draws made here: lecun-normal convs (variance ``1 / fan_in``) with
zero biases, normal(0.01) for the anchor head's class and box convs and for
every conv of the indoor head, identity batch norms, ``Scale`` at 1.  Two
departures, both for the check's sake: no block's ``bn2`` scale starts at
zero (a zeroed ``bn2`` would cut its two convs out of every serving output,
so that no comparison could see them), and serving takes the class bias at
0, as ``tools/profile_forward.py:zero_cls_bias`` does, so that every score
sits near 0.5, above the score threshold, and decode and NMS see full
candidate sets.  Training keeps the reference's ``-log(99)``.
(``profile_forward``'s other two adjustments, ``level_angle_head`` and
``dcn_offsets``, act on a layout head and on deformable convs, which no
configuration here has.)
"""

from __future__ import annotations

import torch
from torch import nn

from .reference import anchor3d_head as a3d
from .reference import imvoxel_heads as ivh
from .reference import necks3d
from .reference.resnet import FrozenBatchNorm
from .traffic import torch_seed

CLS_BIAS_INIT = -4.59511985013459   # -log((1 - 0.01) / 0.01)
CONVS = (nn.Conv2d, nn.Conv3d, necks3d.Conv3x3x3, nn.Linear)


def _plan(model, serve: bool):
    """``{name: ('normal', std) | ('fill', value)}`` for every entry of
    ``model.state_dict()``."""
    head = model.bbox_head
    if isinstance(head, a3d.Anchor3DHead):
        small, cls_conv = {head.conv_cls, head.conv_reg}, head.conv_cls
    else:
        small = {m for m in head.modules() if isinstance(m, nn.Conv3d)}
        cls_conv = head.cls_conv
    plan = {}
    for prefix, mod in model.named_modules():
        dot = prefix + '.' if prefix else ''
        if isinstance(mod, CONVS):
            std = 0.01 if mod in small else mod.weight[0].numel() ** -0.5
            plan[dot + 'weight'] = ('normal', std)
            if getattr(mod, 'bias', None) is not None:
                plan[dot + 'bias'] = ('fill', 0.0)
        elif isinstance(mod, (FrozenBatchNorm, nn.BatchNorm3d)):
            plan.update({dot + 'weight': ('fill', 1.0),
                         dot + 'bias': ('fill', 0.0),
                         dot + 'running_mean': ('fill', 0.0),
                         dot + 'running_var': ('fill', 1.0),
                         dot + 'num_batches_tracked': ('fill', 0)})
        elif isinstance(mod, ivh.Scale):
            plan[dot + 'scale'] = ('fill', 1.0)
    cls_name = next(n for n, m in model.named_modules() if m is cls_conv)
    plan[cls_name + '.bias'] = ('fill', 0.0 if serve else CLS_BIAS_INIT)
    return plan


def make_state_dict(reference_cls, cfg, seed: int, device, serve: bool):
    """The ``state_dict`` of seed ``seed`` for a model of ``cfg``: the
    reference's module tree, built on the meta device, gives the names,
    shapes and the scheme; every normal draw comes from one ``randn`` call
    of a generator on ``device``."""
    with torch.device('meta'):
        model = reference_cls(cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    plan = _plan(model, serve)
    missing = set(shapes) - set(plan)
    if missing:
        raise ValueError(f'no init for {sorted(missing)[:5]}')
    normal = [k for k in shapes if plan[k][0] == 'normal']
    total = sum(shapes[k][0].numel() for k in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 3))
    noise = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for key, (shape, dtype) in shapes.items():
        kind, value = plan[key]
        if kind == 'normal':
            n = shape.numel()
            out[key] = noise[offset:offset + n].view(shape).mul_(value)
            offset += n
        else:
            out[key] = torch.full(shape, value, dtype=dtype, device=device)
    return out
