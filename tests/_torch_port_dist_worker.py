"""One rank of ``tests/test_torch_port_distributed.py`` (not collected by
pytest), and the cases it runs, which the test runs again in one process on
the global batch.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=P \\
        python tests/_torch_port_dist_worker.py OUT_DIR

Each case computes this process's share: with a gloo group of W ranks its
slice of the global batch (or of the views), alone the whole of it.  The
rank writes ``OUT_DIR/rank<r>.pt`` with every case's result; the inputs of
the indoor loss come from ``OUT_DIR/indoor_inputs.pt``, which the test
writes.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from imvoxelnet_tpu_torch.configs.presets import get_preset  # noqa: E402
from imvoxelnet_tpu_torch.models import detector  # noqa: E402
from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as ivh  # noqa
from imvoxelnet_tpu_torch.models.layers import BatchNorm3d  # noqa: E402
from imvoxelnet_tpu_torch.parallel import mesh  # noqa: E402
from imvoxelnet_tpu_torch.parallel import train as train_lib  # noqa: E402
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from imvoxelnet_tpu_torch.utils import synthetic  # noqa: E402

GLOBAL_BATCH = 4
VIEWS = 4


def bn_case():
    """Two train-mode forwards and backwards of a neck batch norm (nonzero
    running mean, so the second one's shift matters): outputs, input
    gradients, the weight and bias gradients summed over the ranks, and
    the running statistics after."""
    rng = np.random.RandomState(0)
    bn = BatchNorm3d(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
        bn.bias.copy_(torch.from_numpy(rng.randn(8) * 0.1))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(8)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 8)))
    bn.train()
    rows = mesh.batch_slice(GLOBAL_BATCH)
    out = dict(y=[], dx=[], dw=[], db=[])
    for it in range(2):
        x = torch.from_numpy(rng.randn(GLOBAL_BATCH, 8, 3, 4, 5).astype(
            np.float32) * 2.0 + 3.0)
        g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
        x = x[rows].clone().requires_grad_()
        y = bn(x)
        (y * g[rows]).sum().backward()
        dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
        if mesh.world_size() > 1:
            torch.distributed.all_reduce(dw)
            torch.distributed.all_reduce(db)
        out['y'].append(y.detach())
        out['dx'].append(x.grad)
        out['dw'].append(dw)
        out['db'].append(db)
        bn.zero_grad()
    out.update(running_mean=bn.running_mean.clone(),
               running_var=bn.running_var.clone(),
               num_batches_tracked=bn.num_batches_tracked.clone())
    return out


def kitti_setup(seed=0):
    preset = get_preset('tiny_kitti_test')
    cfg = dataclasses.replace(preset.model, backbone_stage_blocks=(1, 1, 1, 1))
    model = detector.build_model(cfg, device='cpu', seed=seed)
    optimizer, scheduler = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, 10, preset.lr_steps)
    return preset, model, optimizer, scheduler


def kitti_case():
    """One tiny KITTI step on this rank's slice of a global batch of 4:
    metrics, the weights, gradients and buffers after it; and the
    model and optimizer themselves (for the checkpoint case)."""
    preset, model, optimizer, scheduler = kitti_setup()
    step = train_lib.make_train_step(model, optimizer, scheduler)
    batch = synthetic.train_batch(preset.data, GLOBAL_BATCH, 'cpu', seed=0)
    metrics = {k: float(v) for k, v in step(mesh.shard_batch(batch)).items()}
    out = dict(
        metrics=metrics,
        params={n: p.detach().clone() for n, p in model.named_parameters()},
        grads={n: p.grad.clone() for n, p in model.named_parameters()
               if p.requires_grad},
        buffers={n: b.clone() for n, b in model.named_buffers()})
    return out, (model, optimizer, scheduler)


def train_state(model, optimizer, scheduler):
    """Everything a resume must give back, as plain tensors and numbers."""
    opt = optimizer.state_dict()
    return dict(model=model.state_dict(),
                optim={f'{i}.{k}': v for i, s in opt['state'].items()
                       for k, v in s.items()},
                groups=opt['param_groups'],
                last_epoch=scheduler.last_epoch)


def same_state(a, b):
    return (a['model'].keys() == b['model'].keys() and all(
        torch.equal(a['model'][k], b['model'][k]) for k in a['model'])
        and a['optim'].keys() == b['optim'].keys() and all(
        torch.equal(a['optim'][k], b['optim'][k]) for k in a['optim'])
        and a['groups'] == b['groups'] and a['last_epoch'] == b['last_epoch'])


def checkpoint_case(trained, path):
    """Save the trained state as a DCP directory from every rank, restore
    it into a model and optimizer of another seed, compare bit for bit."""
    model, optimizer, scheduler = trained
    ckpt_lib.save_checkpoint_sharded(path, model, optimizer, scheduler, 1,
                                     dict(epoch=1, preset='tiny_kitti_test'))
    _, fresh, fresh_opt, fresh_sched = kitti_setup(seed=1)
    step, meta = ckpt_lib.load_checkpoint_sharded(path, fresh, fresh_opt,
                                                  fresh_sched)
    return dict(step=step, meta=meta, restored_equal=same_state(
        train_state(model, optimizer, scheduler),
        train_state(fresh, fresh_opt, fresh_sched)))


def indoor_loss_case(inputs, batch_mean=True):
    """The SUN RGB-D head loss on this rank's images of ``inputs`` (the
    test's global batch), its losses averaged over the ranks (the global
    batch's) and the gradients of the rank's loss into its head maps."""
    rows = mesh.batch_slice(inputs['valid'].shape[0])
    heads = tuple([t[rows].clone().requires_grad_() for t in lv]
                  for lv in inputs['heads'])
    losses = ivh.indoor_head_loss(
        heads, inputs['valid'][rows], inputs['origins'][rows],
        inputs['gt_boxes'][rows], inputs['gt_labels'][rows],
        inputs['gt_mask'][rows], inputs['cfg'], batch_mean=batch_mean)
    sum(losses.values()).backward()
    values = torch.stack([losses[k].detach() for k in sorted(losses)])
    if mesh.world_size() > 1:
        values = mesh.mean_over_ranks(values)
    return dict(losses=dict(zip(sorted(losses), values.tolist())),
                grads=[[t.grad for t in lv] for lv in heads])


def tiny_scannet_cfg():
    """The tiny ScanNet config of ``_torch_port_fixtures.tiny_scannet_cfgs``
    (port side), without importing JAX."""
    return detector.ImVoxelNetConfig(
        n_voxels=(16, 16, 8), voxel_size=(0.4, 0.4, 0.4),
        fpn_out_channels=16,
        neck=detector.NeckConfig(kind='imvoxel', channels=(16, 24, 32, 48),
                                 out_channels=16, down_layers=(1, 1, 1, 1),
                                 up_layers=(1, 1, 1)),
        head_kind='indoor', anchor_head=None,
        indoor_head=ivh.IndoorHeadConfig(
            n_classes=3, n_reg_outs=6, voxel_size=(0.4, 0.4, 0.4),
            dataset='scannet', version=1, n_convs=0, centerness_topk=-1,
            limit=8, nms_pre=64, score_thr=0.01, iou_thr=0.15, max_out=16,
            pre_nms_k=32),
        backbone_stage_blocks=(1, 1, 1, 1))


def view_case(sharded):
    """A serving forward of one 4-view tiny ScanNet scene: head maps and
    the seen mask, split over the ranks by view when ``sharded``."""
    cfg = tiny_scannet_cfg()
    if sharded:
        cfg = dataclasses.replace(cfg, view_shard_axis='view')
    model = detector.build_model(cfg, device='cpu', seed=0)
    batch = synthetic.scannet_batch(1, VIEWS, 'cpu', seed=0, size=(128, 96))
    forward = mesh.view_sharded_forward(model) if sharded else model
    with torch.no_grad():
        head_outs, valid = forward(batch)
    return dict(outs=[t for lv in head_outs for t in lv], valid=valid)


def main(out_dir):
    torch.set_num_threads(1)
    mesh.init_distributed('cpu', timeout_s=60)
    inputs = torch.load(os.path.join(out_dir, 'indoor_inputs.pt'),
                        weights_only=False)
    kitti, trained = kitti_case()
    result = dict(bn=bn_case(), kitti=kitti,
                  checkpoint=checkpoint_case(
                      trained, os.path.join(out_dir, 'ckpt')),
                  indoor=indoor_loss_case(inputs),
                  indoor_per_image=indoor_loss_case(inputs, False),
                  views=view_case(True))
    torch.save(result, os.path.join(out_dir, f'rank{mesh.rank()}.pt'))
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1])
