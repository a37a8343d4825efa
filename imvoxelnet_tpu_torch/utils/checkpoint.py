"""The port's checkpoints: the train state on disk, reference weights, and
JAX variables or a JAX train state carried across.

``save_checkpoint`` / ``load_checkpoint`` are the counterparts of
``imvoxelnet_tpu/utils/checkpoint.py:save_checkpoint/load_checkpoint``: one
``torch.save`` file of ``{'state_dict', 'optimizer', 'scheduler', 'step',
'meta'}``, written atomically, read with ``weights_only=True``.  The model's
``state_dict`` carries the reference's mmdet names, so
:func:`load_reference_state_dict` (which reads a reference ``.pth``) reads
the weights of a port checkpoint too.

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

from pathlib import Path

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


def from_jax_train_state(params, batch_stats, opt_np, step, cfg):
    """A JAX train state (numpy trees) -> ``(state_dict, optimizer_state,
    scheduler_step)`` for :func:`restore_train_state`.

    ``opt_np`` holds AdamW's ``mu`` and ``nu`` as trees shaped like
    ``params`` (a leaf the optimizer leaves alone, a frozen one, is
    ``None``) and AdamW's update ``count``, taken by the caller out of the
    optax state (a pickle of it cannot be read without optax).  The moments
    take the parameters' layout transposes; the frozen parameters get no
    optimizer state, as the port's optimizer holds none for them.
    ``optimizer_state`` lists each group's parameters in
    ``parallel/train.py:make_optimizer``'s order; the hyperparameters come
    from the optimizer it is loaded into."""
    from ..models.detector import ImVoxelNet
    from ..parallel.train import param_label

    state_dict = from_jax_variables(
        {'params': params, 'batch_stats': batch_stats}, cfg)
    moments = {key: from_jax_variables(
        {'params': _filled(opt_np[key], params),
         'batch_stats': batch_stats}, cfg) for key in ('mu', 'nu')}
    with torch.device('meta'):
        names = [n for n, _ in ImVoxelNet(cfg).named_parameters()]
    groups = {'backbone': [], 'rest': []}
    for name in names:
        label = param_label(name)
        if label != 'frozen':
            groups[label].append(name)
    order = groups['backbone'] + groups['rest']
    count = int(opt_np['count'])
    # copies: the optimizer updates its state in place, and the tensors of
    # from_jax_variables share the caller's arrays
    state = {i: {'step': torch.tensor(float(count)),
                 'exp_avg': moments['mu'][name].clone(),
                 'exp_avg_sq': moments['nu'][name].clone()}
             for i, name in enumerate(order)}
    n_backbone = len(groups['backbone'])
    param_groups = [{'params': list(range(n_backbone))},
                    {'params': list(range(n_backbone, len(order)))}]
    # the schedule's count is the JAX state's step
    return (state_dict, {'state': state, 'param_groups': param_groups},
            int(step))


def _filled(tree, like):
    """``tree`` with each ``None`` leaf replaced by zeros shaped as
    ``like``'s leaf."""
    if hasattr(like, 'items'):
        tree = tree or {}
        return {k: _filled(tree.get(k), v) for k, v in like.items()}
    return np.zeros(np.shape(like), np.float32) if tree is None else tree


# --------------------------------------------------------------------------
# the train state on disk
# --------------------------------------------------------------------------

def save_checkpoint(path, model, optimizer, scheduler, step: int,
                    meta=None):
    """Write the train state to ``path`` atomically: a ``.tmp`` file, then
    ``os.replace``.  The scheduler's closure is rebuilt by
    ``make_optimizer``; only its count is kept."""
    path = Path(path)
    payload = dict(state_dict=model.state_dict(),
                   optimizer=optimizer.state_dict(),
                   scheduler={'last_epoch': scheduler.last_epoch},
                   step=int(step), meta=dict(meta or {}))
    tmp = path.with_suffix('.tmp')
    torch.save(payload, tmp)
    tmp.replace(path)                   # atomic on POSIX


def load_checkpoint(path, map_location='cpu'):
    """The payload :func:`save_checkpoint` wrote (tensors, numbers, strings
    and lists only: ``weights_only=True``)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_train_state(model, optimizer, scheduler, state_dict,
                        optimizer_state, scheduler_step: int) -> None:
    """Load a train state into the model and the optimizer and scheduler
    that ``make_optimizer`` built for it: the weights (strict), AdamW's
    moments and step counts, and the schedule moved to
    ``scheduler_step`` updates.  A saved group's hyperparameters replace
    the optimizer's; a group that lists only its parameters (a JAX state,
    :func:`from_jax_train_state`) keeps the optimizer's."""
    from ..parallel.train import set_schedule_step

    model.load_state_dict(state_dict, strict=True)
    current = optimizer.state_dict()['param_groups']
    optimizer.load_state_dict(dict(optimizer_state, param_groups=[
        dict(group, **saved) for group, saved in
        zip(current, optimizer_state['param_groups'])]))
    set_schedule_step(optimizer, scheduler, scheduler_step)


def load_reference_state_dict(path) -> dict:
    """The weights of a reference mmdet checkpoint (``{'state_dict': ...}``
    or a bare state dict), or of a port checkpoint, for
    ``model.load_state_dict(..., strict=True)``: the port's parameter names
    are the reference's."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    return ckpt.get('state_dict', ckpt)


# --------------------------------------------------------------------------
# the train state as a torch.distributed.checkpoint directory
# --------------------------------------------------------------------------
# Counterpart of the JAX package's save/load_checkpoint_sharded
# (utils/checkpoint.py:430-522, orbax): every rank writes its share of the
# tensors, nothing is gathered on one host.  The directory holds the model's
# state_dict under 'model.<name>' and AdamW's tensors under
# 'optim.<index>.<name>' (DCP's files, each replicated tensor written once),
# and 'train_state.pt', written by rank 0: the optimizer's param groups,
# the scheduler's count, the step and the metadata.

TRAIN_STATE = 'train_state.pt'


def _barrier():
    from ..parallel import mesh
    if mesh.is_distributed():
        torch.distributed.barrier()


def save_checkpoint_sharded(path, model, optimizer, scheduler, step: int,
                            meta=None):
    """Write the train state to the directory ``path`` atomically, from
    every rank of the process group (or from one process without one): the
    ranks write ``path.tmp``; after a barrier rank 0 adds
    ``train_state.pt`` and renames it to ``path`` (an older ``path`` moves
    aside first and is removed after)."""
    import shutil

    import torch.distributed.checkpoint as dcp

    from ..parallel import mesh

    path = Path(path)
    tmp = path.with_name(path.name + '.tmp')
    if mesh.rank() == 0 and tmp.exists():
        shutil.rmtree(tmp)
    _barrier()
    tensors = {f'model.{k}': v for k, v in model.state_dict().items()}
    for i, state in optimizer.state_dict()['state'].items():
        tensors.update({f'optim.{i}.{k}': v for k, v in state.items()})
    dcp.save(tensors, checkpoint_id=str(tmp))
    _barrier()
    if mesh.rank() == 0:
        torch.save(dict(param_groups=optimizer.state_dict()['param_groups'],
                        scheduler={'last_epoch': scheduler.last_epoch},
                        step=int(step), meta=dict(meta or {})),
                   tmp / TRAIN_STATE)
        old = path.with_name(path.name + '.old')
        if path.exists():
            path.rename(old)
        tmp.rename(path)
        if old.exists():
            shutil.rmtree(old)
    _barrier()


def _dcp_targets(path, model_sd=None, devices=None):
    """Tensors for every entry of a DCP directory: the model's own where
    ``model_sd`` is given, else new ones on ``devices[index]`` (AdamW's
    step counts on the host, as AdamW keeps them) or the host; and the
    AdamW state they form, ``{index: {name: tensor}}``."""
    import torch.distributed.checkpoint as dcp

    saved = dcp.FileSystemReader(str(path)).read_metadata()
    target, state = {}, {}
    for key, info in saved.state_dict_metadata.items():
        part, name = key.split('.', 1)
        if part == 'model' and model_sd is not None:
            target[key] = model_sd[name]
            continue
        device = 'cpu'
        if part == 'optim':
            index, name = name.split('.', 1)
            if devices is not None and name != 'step':
                device = devices[int(index)]
        target[key] = torch.empty(info.size, dtype=info.properties.dtype,
                                  device=device)
        if part == 'optim':
            state.setdefault(int(index), {})[name] = target[key]
    dcp.load(target, checkpoint_id=str(path))
    return target, state


def read_checkpoint_sharded(path):
    """The payload of a DCP directory as :func:`load_checkpoint` gives a
    ``latest.pth``'s (host tensors): ``state_dict``, ``optimizer``,
    ``scheduler``, ``step``, ``meta``."""
    path = Path(path)
    target, state = _dcp_targets(path)
    extra = torch.load(path / TRAIN_STATE, map_location='cpu',
                       weights_only=True)
    return dict(state_dict={k[len('model.'):]: v for k, v in target.items()
                            if k.startswith('model.')},
                optimizer=dict(state=state,
                               param_groups=extra['param_groups']),
                scheduler=extra['scheduler'], step=extra['step'],
                meta=extra['meta'])


def load_checkpoint_sharded(path, model, optimizer, scheduler):
    """Restore the directory :func:`save_checkpoint_sharded` wrote into the
    model and the optimizer and scheduler ``make_optimizer`` built for it
    (:func:`restore_train_state`), on every rank; returns ``(step,
    meta)``.  The weights load in place, AdamW's tensors onto their
    parameters' devices."""
    path = Path(path)
    model_sd = model.state_dict()
    devices = [p.device for g in optimizer.param_groups for p in g['params']]
    _, state = _dcp_targets(path, model_sd, devices)
    extra = torch.load(path / TRAIN_STATE, map_location='cpu',
                       weights_only=True)
    restore_train_state(model, optimizer, scheduler, model_sd,
                        dict(state=state, param_groups=extra['param_groups']),
                        extra['scheduler']['last_epoch'])
    return extra['step'], extra['meta']
