"""Fold the backbone's frozen batch norms into the convs before them.

Counterpart of the JAX package's ``tools/fuse_conv_bn.py``
(``fuse_conv_bn_pair``, ``fuse_backbone``), on the port's
reference-named ``state_dict``: for each (conv, frozen BN) pair the conv's
weight is multiplied per output channel by ``bn.weight / sqrt(running_var
+ eps)``, and the BN becomes ``weight = sqrt(1 + eps)``, ``bias`` = the
shift ``bias - running_mean * scale``, ``running_mean = 0``,
``running_var = 1`` (the JAX constants: the BN then multiplies by exactly
1 and adds the shift).  The key set is unchanged, so a folded
``state_dict`` loads into the same model.  The pairs are the stem
(``conv1``/``bn1``), ``conv1-3``/``bn1-3`` of every bottleneck (a DCN
block's ``conv2.weight`` included; its ``conv_offset`` is not followed by
the BN and stays) and ``downsample.0``/``downsample.1``.  The forward
still applies each BN (``models/resnet.py:FrozenBatchNorm``): the fold
changes the weights, not the work.
"""

from __future__ import annotations

import re

import torch

EPS = 1e-5


def fuse_conv_bn_pair(conv_weight, bn, eps: float = EPS):
    """``(fused conv weight, fused BN)`` for a conv weight ``(O, ...)`` and
    a BN dict with ``weight``, ``bias``, ``running_mean``, ``running_var``
    (``(O,)`` each); other BN entries are kept."""
    scale = bn['weight'] / torch.sqrt(bn['running_var'] + eps)
    weight = conv_weight * scale.reshape((-1,) + (1,) * (conv_weight.dim()
                                                         - 1))
    fused = dict(bn)
    fused.update(weight=torch.sqrt(torch.ones_like(bn['running_var']) + eps),
                 bias=bn['bias'] - bn['running_mean'] * scale,
                 running_mean=torch.zeros_like(bn['running_mean']),
                 running_var=torch.ones_like(bn['running_var']))
    return weight, fused


_BN_KEYS = ('weight', 'bias', 'running_mean', 'running_var')


def backbone_pairs(state_dict, prefix: str = 'backbone.'):
    """The ``(conv, bn)`` module-name pairs of a ResNet ``state_dict``."""
    pairs = [(prefix + 'conv1', prefix + 'bn1')]
    block = re.compile(re.escape(prefix) + r'(layer\d+\.\d+)\.bn1\.weight$')
    for key in state_dict:
        m = block.match(key)
        if not m:
            continue
        base = prefix + m.group(1)
        pairs += [(f'{base}.conv{i}', f'{base}.bn{i}') for i in (1, 2, 3)]
        if f'{base}.downsample.0.weight' in state_dict:
            pairs.append((f'{base}.downsample.0', f'{base}.downsample.1'))
    return pairs


def fuse_backbone(state_dict, prefix: str = 'backbone.', eps: float = EPS):
    """A copy of ``state_dict`` with every (conv, frozen BN) pair of the
    backbone folded (:func:`fuse_conv_bn_pair`); same keys."""
    out = dict(state_dict)
    for conv, bn in backbone_pairs(state_dict, prefix):
        weight, fused = fuse_conv_bn_pair(
            state_dict[f'{conv}.weight'],
            {k: state_dict[f'{bn}.{k}'] for k in _BN_KEYS}, eps)
        out[f'{conv}.weight'] = weight
        out.update({f'{bn}.{k}': v for k, v in fused.items()})
    return out
