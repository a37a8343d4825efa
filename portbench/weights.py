"""Seeded weights, made on the device in one draw, and handed as one
``state_dict`` to the program and to the reference alike.

The scheme is the port's preset init (``models/detector.py:init_weights``)
with its draws made here: lecun-normal convs (variance ``1 / fan_in``) with
zero biases, identity batch norms, ``Scale`` at 1; on top of these the
reference module's ``init_overrides(model, serve)`` (``spec.reference``),
as the default reference's head takes normal(0.01) and its class bias.
One departure, for the check's sake: no block's ``bn2`` scale starts at
zero (a zeroed ``bn2`` would cut its two convs out of every serving output,
so that no comparison could see them).
"""

from __future__ import annotations

import torch
from torch import nn

from .reference.imvoxel_heads import Scale
from .reference.necks3d import Conv3x3x3
from .reference.resnet import FrozenBatchNorm
from .traffic import torch_seed

CONVS = (nn.Conv2d, nn.Conv3d, Conv3x3x3, nn.Linear)


def _plan(model):
    """``{name: ('normal', std) | ('fill', value)}`` for the entries of
    ``model.state_dict()`` that the generic scheme covers."""
    plan = {}
    for prefix, mod in model.named_modules():
        dot = prefix + '.' if prefix else ''
        if isinstance(mod, CONVS):
            plan[dot + 'weight'] = ('normal', mod.weight[0].numel() ** -0.5)
            if getattr(mod, 'bias', None) is not None:
                plan[dot + 'bias'] = ('fill', 0.0)
        elif isinstance(mod, (FrozenBatchNorm, nn.BatchNorm3d)):
            plan.update({dot + 'weight': ('fill', 1.0),
                         dot + 'bias': ('fill', 0.0),
                         dot + 'running_mean': ('fill', 0.0),
                         dot + 'running_var': ('fill', 1.0),
                         dot + 'num_batches_tracked': ('fill', 0)})
        elif isinstance(mod, Scale):
            plan[dot + 'scale'] = ('fill', 1.0)
    return plan


def make_state_dict(reference, cfg, seed: int, device, serve: bool):
    """The ``state_dict`` of seed ``seed`` for a model of ``cfg``: the
    reference module's model (``spec.reference``), built on the meta
    device, gives the names, shapes and the scheme; every normal draw
    comes from one ``randn`` call of a generator on ``device``, over the
    ``state_dict`` in its own order."""
    with torch.device('meta'):
        model = reference.ImVoxelNet(cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    plan = _plan(model)
    overrides = getattr(reference, 'init_overrides', None)
    if overrides is not None:
        plan.update(overrides(model, serve))
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
