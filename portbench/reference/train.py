"""The training step, plain PyTorch: AdamW + one joint gradient clip +
step LR, as the port's ``parallel/train.py`` has it on one device.

  - AdamW, betas (0.9, 0.999), eps 1e-8, weight decay; the backbone at
    ``lr x backbone_lr_mult``;
  - one joint global-norm clip over every trainable gradient, scaled by
    ``max_norm / norm`` only where ``norm > max_norm``;
  - x0.1 at each epoch of ``lr_steps``;
  - frozen: the stem, ``layer1`` and every backbone batch norm.

One step is: forward in train mode, targets and losses, backward, clip,
update, LR step.  The caller sets the precision.
"""

from __future__ import annotations

import torch


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
    """``step(batch) -> metrics``: one update of ``model`` on ``batch``;
    ``metrics`` holds the losses and their sum ``loss`` as device tensors.
    Every trainable parameter gets a zero gradient up front, so that one
    that does not reach the loss still decays."""
    for g in optimizer.param_groups:
        for p in g['params']:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def step(batch):
        model.train()
        optimizer.zero_grad(set_to_none=False)
        head_outs, valid = model(batch)
        losses = model.loss(head_outs, batch, valid)
        total = sum(losses.values())
        total.backward()
        optimizer.step()
        scheduler.step()
        return dict({k: v.detach() for k, v in losses.items()},
                    loss=total.detach())
    return step
