"""Training step: AdamW + joint grad clip + step LR, for the KITTI, SUN
RGB-D, Total3D and ScanNet presets.

Counterpart of ``imvoxelnet_tpu/parallel/train.py`` (``param_labels``,
``make_optimizer``, ``make_train_step``) on one device:

  - AdamW, betas (0.9, 0.999), eps 1e-8, weight decay 1e-4; backbone at
    lr x 0.1 (``configs/imvoxelnet/imvoxelnet_kitti.py:144-149``);
  - one joint global-norm clip at 35 over every trainable gradient (:150),
    as ``optax.clip_by_global_norm``: scaled by ``35 / norm`` only where
    ``norm > 35``, with no epsilon added;
  - x0.1 at each epoch of ``lr_steps`` (:151-152), from update number
    ``epoch * steps_per_epoch`` on, as ``optax.piecewise_constant_schedule``;
  - frozen: the stem, ``layer1`` and every backbone batch norm
    (``frozen_stages=1``, ``norm_eval=True``).  The JAX package masks their
    updates to zero; here they get ``requires_grad=False`` and sit in no
    param group.  The layout head (``head_2d``) takes the default group.

One step is: forward in train mode, targets and losses, backward, clip,
update, LR step -- all queued on the device, with no host read, at the
precision of the model's ``compute_dtype`` (``utils/precision.py``: float32
means TF32 off).

Over a process group of W > 1 ranks (``parallel/mesh.py``), each on its
slice of the global batch, the step is the JAX package's one program over
the global batch: the batch norms and the loss normalizers take the global
batch's statistics inside the forward, and after the backward the gradients
are averaged over the ranks (:func:`mesh.average_gradients`) before the one
joint clip, so every rank makes the same update.  An explicit bucketed
all-reduce rather than ``DistributedDataParallel``: DDP would wrap the
module (``module.`` in every ``state_dict`` name), broadcast the buffers at
every forward and demand ``find_unused_parameters`` for the parameters
that reach no loss (the FPN's unused output convs, a layout head), while
here every trainable parameter already holds a gradient and the reduction
is one call at a known point.  The cost: the all-reduce does not overlap
the backward.
"""

from __future__ import annotations

import torch

from ..models.detector import imvoxelnet_loss
from ..utils.precision import compute_precision
from . import mesh

def param_label(name: str) -> str:
    """``'frozen'``, ``'backbone'`` or ``'rest'`` for a parameter of
    ``ImVoxelNet`` by its mmdet name."""
    keys = name.split('.')
    if keys[0] != 'backbone':
        return 'rest'
    if keys[1] in ('conv1', 'bn1', 'layer1'):
        return 'frozen'
    # norm_eval + requires_grad=False: every backbone batch norm
    if any(k.startswith('bn') for k in keys[2:]) or 'downsample.1' in name:
        return 'frozen'
    return 'backbone'


def param_labels(model) -> dict:
    return {name: param_label(name) for name, _ in model.named_parameters()}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by ``max_norm / norm`` where their joint L2
    norm exceeds ``max_norm``, on the device (no host read)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips every group's gradients by one joint
    norm (``optax.chain(clip_by_global_norm, adamw)``)."""

    def __init__(self, param_groups, max_norm: float, **kwargs):
        super().__init__(param_groups, **kwargs)
        self.max_norm = max_norm

    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g['params']
                 if p.grad is not None]
        clip_by_global_norm(grads, self.max_norm)
        return super().step(closure)


def make_optimizer(model, lr: float, weight_decay: float,
                   backbone_lr_mult: float, grad_clip_norm: float,
                   steps_per_epoch: int, lr_steps=(8, 11)):
    """The reference optimizer for ``model``: returns ``(optimizer,
    scheduler)``.  Freezes the ``'frozen'`` parameters
    (``requires_grad=False``); call ``scheduler.step()`` once per update."""
    groups = {'backbone': [], 'rest': []}
    for name, p in model.named_parameters():
        label = param_label(name)
        p.requires_grad_(label != 'frozen')
        if label != 'frozen':
            groups[label].append(p)
    optimizer = ClippedAdamW(
        [dict(params=groups['backbone'], lr=lr * backbone_lr_mult),
         dict(params=groups['rest'], lr=lr)],
        max_norm=grad_clip_norm, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)
    boundaries = [e * steps_per_epoch for e in lr_steps]

    def factor(update: int) -> float:
        return 0.1 ** sum(update >= b for b in boundaries)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def make_train_step(model, optimizer, scheduler):
    """``step(batch) -> metrics``: one update of ``model`` on ``batch`` (the
    detector's layout with ``gt_boxes``, ``gt_labels``, ``gt_mask``).

    Puts the model in train mode and runs inside
    ``compute_precision(model.cfg.compute_dtype)``.  ``metrics`` holds the
    losses (KITTI: ``loss_cls``, ``loss_bbox``, ``loss_dir``; indoor:
    ``loss_centerness``, ``loss_bbox``, ``loss_cls``, and with a layout head
    ``angle_loss`` and ``layout_loss`` too) and their sum ``loss``, in that
    order, as device tensors; over several ranks, their means over the
    ranks (the global batch's losses).
    Every trainable parameter gets a zero gradient up front, so that one that
    does not reach the loss (the FPN's unused output convs) still decays, as
    under optax.
    """
    cfg = model.cfg
    params = [p for g in optimizer.param_groups for p in g['params']]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)

    def step(batch):
        with compute_precision(cfg.compute_dtype):
            model.train()
            optimizer.zero_grad(set_to_none=False)
            head_outs, valid, *features_2d = model(batch)
            losses = imvoxelnet_loss(cfg, head_outs, batch, valid,
                                     *features_2d)
            total = sum(losses.values())
            total.backward()
            mesh.average_gradients(params)
            optimizer.step()
            scheduler.step()
        metrics = dict({k: v.detach() for k, v in losses.items()},
                       loss=total.detach())
        if mesh.world_size() > 1:
            mean = mesh.mean_over_ranks(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, mean.unbind()))
        return metrics
    return step


def set_schedule_step(optimizer, scheduler, update: int) -> None:
    """Move the schedule of :func:`make_optimizer` to ``update`` updates
    done, as a resumed run needs it: the scheduler's count and each group's
    LR as the unbroken run has them.  ``LambdaLR`` does not pickle its
    closure, so ``make_optimizer`` rebuilds it and only the count comes
    back."""
    lrs = [base * fn(update)
           for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group['lr'] = lr
    scheduler.load_state_dict(dict(scheduler.state_dict(), last_epoch=update,
                                   _last_lr=lrs))
