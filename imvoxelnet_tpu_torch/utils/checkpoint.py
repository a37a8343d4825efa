"""JAX variables -> the port's ``state_dict``.

``from_jax_variables`` is the inverse of the JAX package's reference
converter (``imvoxelnet_tpu/utils/checkpoint.py``: ``convert_resnet50``,
``convert_fpn``, ``convert_kitti_neck`` (and ``convert_nuscenes_neck``, the
same), ``convert_imvoxel_neck``,
``convert_fast_neck``, ``convert_anchor3d_head``, ``convert_indoor_head``,
``convert_layout_head``):
it turns a ``{'params', 'batch_stats'}`` tree of numpy arrays into tensors
under the reference's mmdet names, so both packages can run the same
weights.  Layouts:

  flax Conv (kH, kW, I, O)           -> torch Conv2d (O, I, kH, kW)
  flax Conv (kD, kH, kW, I, O)       -> torch Conv3d (O, I, kD, kH, kW)
  flax ConvTranspose(transpose_kernel=True) (kD, kH, kW, O, I)
                                     -> torch ConvTranspose3d (I, O, kD, kH,
                                        kW): the same axis permutation
  flax Dense (I, O)                  -> torch Linear (O, I)
  scale / bias + mean / var          -> weight / bias / running_mean /
                                        running_var (+ num_batches_tracked 0)
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x):
    x = np.asarray(x, np.float32)
    # ascontiguousarray makes a 0-d array 1-d: keep the shape (Scale's ())
    return torch.from_numpy(np.ascontiguousarray(x).reshape(x.shape))


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
    """A DCN stage's conv2 (``DeformConv2d``) carries its own ``kernel``
    and a ``conv_offset`` conv with a bias (``convert_resnet50``'s
    ``stage_with_dcn``)."""
    sd['backbone.conv1.weight'] = _conv(p['conv1']['kernel'])
    _bn(sd, 'backbone.bn1', p['bn1'])
    for stage, n_blocks in enumerate(stage_blocks, start=1):
        for b in range(n_blocks):
            blk = p[f'layer{stage}_{b}']
            tb = f'backbone.layer{stage}.{b}'
            for i in (1, 2, 3):
                sd[f'{tb}.conv{i}.weight'] = _conv(blk[f'conv{i}']['kernel'])
                _bn(sd, f'{tb}.bn{i}', blk[f'bn{i}'])
            if 'conv_offset' in blk['conv2']:
                off = blk['conv2']['conv_offset']
                sd[f'{tb}.conv2.conv_offset.weight'] = _conv(off['kernel'])
                sd[f'{tb}.conv2.conv_offset.bias'] = _t(off['bias'])
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


def _block(sd, tp, p, s):
    """``BasicBlock3d``: flax ``bn1`` wraps its BN in ``bn``, ``bn2`` not."""
    sd[f'{tp}.conv1.weight'] = _conv(p['conv1']['kernel'])
    sd[f'{tp}.conv2.weight'] = _conv(p['conv2']['kernel'])
    _bn(sd, f'{tp}.bn1', p['bn1']['bn'], s['bn1']['bn'])
    _bn(sd, f'{tp}.bn2', p['bn2'], s['bn2'])


def _kitti_neck(sd, p, s):
    mapping = (('block0', 0), ('down0', 1), ('block1', 2), ('down1', 3),
               ('block2', 4), ('out_conv', 5))
    for name, pos in mapping:
        tp = f'neck_3d.model.{pos}'
        if name.startswith('block'):
            _block(sd, tp, p[name], s[name])
        else:
            sd[f'{tp}.0.weight'] = _conv(p[name]['conv']['kernel'])
            sd[f'{tp}.0.bias'] = _t(p[name]['conv']['bias'])
            _bn(sd, f'{tp}.1', p[name]['norm']['bn'], s[name]['norm']['bn'])


def _imvoxel_neck(sd, p, s, neck):
    """``ImVoxelNeck``: ``model.layers_down.{i}`` (conv 0, BN 1, blocks from
    4 for i > 0), ``layers_up_conv``, ``proj``, ``layers_up_res`` and
    ``conv_blocks`` (``convert_imvoxel_neck``)."""
    tm = 'neck_3d.model'
    for i in range(len(neck.channels)):
        off = 0
        if i > 0:
            sd[f'{tm}.layers_down.{i}.0.weight'] = _conv(
                p[f'down_conv_{i}']['kernel'])
            _bn(sd, f'{tm}.layers_down.{i}.1', p[f'down_bn_{i}']['bn'],
                s[f'down_bn_{i}']['bn'])
            off = 4
        for j in range(neck.down_layers[i]):
            _block(sd, f'{tm}.layers_down.{i}.{off + j}', p[f'down_{i}_{j}'],
                   s[f'down_{i}_{j}'])
    for i in range(len(neck.channels) - 1):
        sd[f'{tm}.layers_up_conv.{i}.weight'] = _conv(
            p[f'up_conv_{i}']['kernel'])
        sd[f'{tm}.proj.{i}.conv.weight'] = _conv(p[f'proj_conv_{i}']['kernel'])
        _bn(sd, f'{tm}.proj.{i}.norm', p[f'proj_bn_{i}']['bn'],
            s[f'proj_bn_{i}']['bn'])
        for j in range(neck.up_layers[i]):
            _block(sd, f'{tm}.layers_up_res.{i}.{j}', p[f'up_{i}_{j}'],
                   s[f'up_{i}_{j}'])
        tc = f'neck_3d.conv_blocks.{i}'
        sd[f'{tc}.0.weight'] = _conv(p[f'out_conv_{i}']['kernel'])
        sd[f'{tc}.0.bias'] = _t(p[f'out_conv_{i}']['bias'])
        _bn(sd, f'{tc}.1', p[f'out_bn_{i}']['bn'], s[f'out_bn_{i}']['bn'])


def _fast_neck(sd, p, s, neck):
    """``FastIndoorImVoxelNeck``: ``down_layer_{i}.{j}``, ``up_block_{i}``
    (transposed conv 0, BN 1, conv 3, BN 4) and ``out_block_{i}``
    (``convert_fast_neck``)."""
    for i, n in enumerate(neck.n_blocks):
        for j in range(n):
            tp, bp, bs = (f'neck_3d.down_layer_{i}.{j}', p[f'down_{i}_{j}'],
                          s[f'down_{i}_{j}'])
            for k in ('conv1', 'conv2'):
                sd[f'{tp}.{k}.weight'] = _conv(bp[k]['kernel'])
            for k in ('norm1', 'norm2'):
                _bn(sd, f'{tp}.{k}', bp[k]['bn'], bs[k]['bn'])
            if 'downsample_conv' in bp:
                sd[f'{tp}.downsample.0.weight'] = _conv(
                    bp['downsample_conv']['kernel'])
                _bn(sd, f'{tp}.downsample.1', bp['downsample_norm']['bn'],
                    bs['downsample_norm']['bn'])
    for i in range(1, len(neck.n_blocks)):
        tp = f'neck_3d.up_block_{i}'
        sd[f'{tp}.0.weight'] = _conv(p[f'up_convt_{i}']['kernel'])
        sd[f'{tp}.3.weight'] = _conv(p[f'up_conv_{i}']['kernel'])
        for name, pos in ((f'up_bn1_{i}', 1), (f'up_bn2_{i}', 4)):
            _bn(sd, f'{tp}.{pos}', p[name]['bn'], s[name]['bn'])
    for i in range(len(neck.n_blocks)):
        sd[f'neck_3d.out_block_{i}.0.weight'] = _conv(
            p[f'out_conv_{i}']['kernel'])
        _bn(sd, f'neck_3d.out_block_{i}.1', p[f'out_bn_{i}']['bn'],
            s[f'out_bn_{i}']['bn'])


def _anchor3d_head(sd, p):
    for name in ('conv_cls', 'conv_reg', 'conv_dir_cls'):
        if name in p:
            sd[f'bbox_head.{name}.weight'] = _conv(p[name]['kernel'])
            sd[f'bbox_head.{name}.bias'] = _t(p[name]['bias'])


def _indoor_head(sd, p, s, head):
    """``IndoorHead``: the three prediction convs, ``scales.{i}`` and the
    v1 towers ``{reg,cls}_convs.{j}`` (``convert_indoor_head``)."""
    for name in ('centerness_conv', 'reg_conv', 'cls_conv'):
        sd[f'bbox_head.{name}.weight'] = _conv(p[name]['kernel'])
    sd['bbox_head.cls_conv.bias'] = _t(p['cls_conv']['bias'])
    for i in range(head.n_scales):
        sd[f'bbox_head.scales.{i}.scale'] = _t(p[f'scale_{i}']['scale'])
    for j in range(head.n_convs if head.version == 1 else 0):
        for tower, tname in (('reg', 'reg_convs'), ('cls', 'cls_convs')):
            sd[f'bbox_head.{tname}.{j}.0.weight'] = _conv(
                p[f'{tower}_tower_{j}']['kernel'])
            _bn(sd, f'bbox_head.{tname}.{j}.1', p[f'{tower}_tower_bn_{j}'],
                s[f'{tower}_tower_bn_{j}'])


def _layout_head(sd, p):
    """``LayoutHead``: flax ``{angle,layout}_fc{1,2,3}`` -> the reference's
    ``head_2d.{angle,layout}_mlp.{0,3,6}`` (``convert_layout_head``)."""
    for head in ('angle', 'layout'):
        for fc, pos in (('fc1', 0), ('fc2', 3), ('fc3', 6)):
            dense = p[f'{head}_{fc}']
            sd[f'head_2d.{head}_mlp.{pos}.weight'] = _t(
                np.asarray(dense['kernel'], np.float32).T)
            sd[f'head_2d.{head}_mlp.{pos}.bias'] = _t(dense['bias'])


def neck_state_dict(neck_cfg, params, stats) -> dict:
    """The ``neck_3d.*`` entries for the JAX neck's own variables."""
    sd = {}
    if neck_cfg.kind in ('kitti', 'nuscenes'):
        _kitti_neck(sd, params, stats)
    elif neck_cfg.kind == 'imvoxel':
        _imvoxel_neck(sd, params, stats, neck_cfg)
    elif neck_cfg.kind == 'fast':
        _fast_neck(sd, params, stats, neck_cfg)
    else:
        raise ValueError(f'unknown neck {neck_cfg.kind!r}')
    return sd


def head_state_dict(cfg, params, stats) -> dict:
    """The ``bbox_head.*`` entries for the JAX head's own variables."""
    sd = {}
    if cfg.head_kind == 'anchor3d':
        _anchor3d_head(sd, params)
    else:
        _indoor_head(sd, params, stats, cfg.indoor_head)
    return sd


def from_jax_variables(variables_np, cfg) -> dict:
    """``{'params', 'batch_stats'}`` of the JAX ``ImVoxelNet`` (numpy
    arrays) -> the port's ``state_dict`` for ``ImVoxelNet(cfg)``."""
    params = variables_np['params']
    stats = variables_np.get('batch_stats', {})
    sd = {}
    _backbone(sd, params['backbone'], cfg.backbone_stage_blocks)
    _fpn(sd, params['neck'])
    sd.update(neck_state_dict(cfg.neck, params['neck_3d'], stats['neck_3d']))
    sd.update(head_state_dict(cfg, params['bbox_head'],
                              stats.get('bbox_head', {})))
    if cfg.layout_head is not None:
        _layout_head(sd, params['head_2d'])
    return sd
