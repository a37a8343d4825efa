"""JAX variables -> the port's ``state_dict``.

``from_jax_variables`` is the inverse of the JAX package's reference
converter (``imvoxelnet_tpu/utils/checkpoint.py``: ``convert_resnet50``,
``convert_fpn``, ``convert_kitti_neck``, ``convert_anchor3d_head``): it turns
a ``{'params', 'batch_stats'}`` tree of numpy arrays into tensors under the
reference's mmdet names, so both packages can run the same weights.  Layouts:

  flax Conv (kH, kW, I, O)           -> torch Conv2d (O, I, kH, kW)
  flax Conv (kD, kH, kW, I, O)       -> torch Conv3d (O, I, kD, kH, kW)
  scale / bias + mean / var          -> weight / bias / running_mean /
                                        running_var (+ num_batches_tracked 0)
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv(kernel):
    k = np.asarray(kernel, np.float32)
    if k.ndim == 4:
        return _t(k.transpose(3, 2, 0, 1))
    return _t(k.transpose(4, 3, 0, 1, 2))


def _bn(sd, prefix, params, stats=None):
    stats = params if stats is None else stats
    sd[f'{prefix}.weight'] = _t(params['scale'])
    sd[f'{prefix}.bias'] = _t(params['bias'])
    sd[f'{prefix}.running_mean'] = _t(stats['mean'])
    sd[f'{prefix}.running_var'] = _t(stats['var'])
    sd[f'{prefix}.num_batches_tracked'] = torch.tensor(0, dtype=torch.long)


def _backbone(sd, p, stage_blocks):
    sd['backbone.conv1.weight'] = _conv(p['conv1']['kernel'])
    _bn(sd, 'backbone.bn1', p['bn1'])
    for stage, n_blocks in enumerate(stage_blocks, start=1):
        for b in range(n_blocks):
            blk = p[f'layer{stage}_{b}']
            tb = f'backbone.layer{stage}.{b}'
            for i in (1, 2, 3):
                sd[f'{tb}.conv{i}.weight'] = _conv(blk[f'conv{i}']['kernel'])
                _bn(sd, f'{tb}.bn{i}', blk[f'bn{i}'])
            if 'downsample_conv' in blk:
                sd[f'{tb}.downsample.0.weight'] = _conv(
                    blk['downsample_conv']['kernel'])
                _bn(sd, f'{tb}.downsample.1', blk['downsample_bn'])


def _fpn(sd, p):
    n_levels = sum(1 for k in p if k.startswith('lateral_'))
    for i in range(n_levels):
        for flax_name, mod in ((f'lateral_{i}', 'lateral_convs'),
                               (f'fpn_{i}', 'fpn_convs')):
            sd[f'neck.{mod}.{i}.conv.weight'] = _conv(p[flax_name]['kernel'])
            sd[f'neck.{mod}.{i}.conv.bias'] = _t(p[flax_name]['bias'])


def _kitti_neck(sd, p, s):
    mapping = (('block0', 0), ('down0', 1), ('block1', 2), ('down1', 3),
               ('block2', 4), ('out_conv', 5))
    for name, pos in mapping:
        tp = f'neck_3d.model.{pos}'
        if name.startswith('block'):
            sd[f'{tp}.conv1.weight'] = _conv(p[name]['conv1']['kernel'])
            sd[f'{tp}.conv2.weight'] = _conv(p[name]['conv2']['kernel'])
            _bn(sd, f'{tp}.bn1', p[name]['bn1']['bn'], s[name]['bn1']['bn'])
            _bn(sd, f'{tp}.bn2', p[name]['bn2'], s[name]['bn2'])
        else:
            sd[f'{tp}.0.weight'] = _conv(p[name]['conv']['kernel'])
            sd[f'{tp}.0.bias'] = _t(p[name]['conv']['bias'])
            _bn(sd, f'{tp}.1', p[name]['norm']['bn'], s[name]['norm']['bn'])


def _anchor3d_head(sd, p):
    for name in ('conv_cls', 'conv_reg', 'conv_dir_cls'):
        if name in p:
            sd[f'bbox_head.{name}.weight'] = _conv(p[name]['kernel'])
            sd[f'bbox_head.{name}.bias'] = _t(p[name]['bias'])


def from_jax_variables(variables_np, cfg) -> dict:
    """``{'params', 'batch_stats'}`` of the JAX ``ImVoxelNet`` (numpy
    arrays) -> the port's ``state_dict`` for ``ImVoxelNet(cfg)``."""
    params = variables_np['params']
    stats = variables_np.get('batch_stats', {})
    sd = {}
    _backbone(sd, params['backbone'], cfg.backbone_stage_blocks)
    _fpn(sd, params['neck'])
    _kitti_neck(sd, params['neck_3d'], stats['neck_3d'])
    _anchor3d_head(sd, params['bbox_head'])
    return sd
