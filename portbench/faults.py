"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that patches the port for its block.

* ``altered_answer``: the first detection of the first scene of every
  batch moved 1 m along x where the decode produces it;
* ``half_batch``: serving, the forward runs on the first half of the batch
  and copies it over the second; training, the loss is taken over the
  first half of the batch alone (its mean over the rest);
* ``frozen_state``: the optimizer's step returns and leaves every
  parameter as it was.

A cell on one card has no exchange between cards to leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr, make):
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def altered_answer():
    from imvoxelnet_tpu_torch.models import detector

    def make(predict):
        def altered(*args, **kwargs):
            dets = predict(*args, **kwargs)
            boxes = dets['boxes'].clone()
            boxes[0, 0, 0] += 1.0
            return dict(dets, boxes=boxes)
        return altered
    return _patched(detector, 'imvoxelnet_predict', make)


def _half(x):
    """The first half of the batch axis, repeated over the second."""
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:h]] + ([x[h:h + 1]] if x.shape[0] % 2
                                       else []))[:x.shape[0]]


def half_batch_serve():
    from imvoxelnet_tpu_torch.models import detector

    def make(forward):
        def halved(self, batch, *args, **kwargs):
            return forward(self, {k: _half(v) for k, v in batch.items()},
                           *args, **kwargs)
        return halved
    return _patched(detector.ImVoxelNet, 'forward', make)


def half_batch_train():
    from imvoxelnet_tpu_torch.parallel import train as train_lib

    def make(loss_fn):
        def halved(cfg, head_outs, batch, valid=None, *rest):
            h = batch['images'].shape[0] // 2

            def cut(x):
                if isinstance(x, (list, tuple)):
                    return type(x)(cut(t) for t in x)
                return x[:h]
            return loss_fn(cfg, cut(head_outs),
                           {k: v[:h] for k, v in batch.items()},
                           None if valid is None else valid[:h], *rest)
        return halved
    return _patched(train_lib, 'imvoxelnet_loss', make)


def frozen_state():
    from imvoxelnet_tpu_torch.parallel import train as train_lib

    def make(_step):
        def unchanged(self, closure=None):
            return None
        return unchanged
    return _patched(train_lib.ClippedAdamW, 'step', make)


SERVE = dict(altered_answer=altered_answer, half_batch=half_batch_serve)
TRAIN = dict(half_batch=half_batch_train, frozen_state=frozen_state)
