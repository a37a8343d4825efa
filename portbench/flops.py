"""The FLOPs of a batch or a training step, from the cell's shapes alone.

``counted`` runs the reference (``portbench/reference``) on the meta
device under ``torch.utils.flop_counter.FlopCounterMode``: convolutions and
matmuls, counted dense (padded taps included, which the tensor cores
execute as real multiply-adds), as the port's ``tools/flops.py`` counts.
No kernel and no value enters the count, so a change to how the program
computes a layer cannot change it.  A training step counts the forward
and the backward that the step's trainable parameters ask for: the loss
is replaced by the sum of the head outputs, whose backward reaches every
convolution the real loss reaches (the loss's own arithmetic holds no
convolution or matmul).  The reference is the cell's (``spec.reference``).
"""

from __future__ import annotations

import torch
from torch.fx.experimental import _config as fx_config
from torch.utils.flop_counter import FlopCounterMode


def meta_batch(batch):
    return {k: torch.empty_like(v, device='meta') for k, v in batch.items()}


def counted(reference, cfg, batch, train: bool) -> float:
    """FLOPs of one forward (``train``: forward and backward) of the model
    of ``cfg`` of the ``reference`` module on a batch of ``batch``'s
    shapes."""
    with torch.device('meta'):
        model = reference.ImVoxelNet(cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(train and reference.param_label(name) != 'frozen')
    model.train(train)
    # the backprojection's backward selects the seen rows with a mask: on
    # the meta device every row counts as seen, which moves no FLOP (its
    # index_add_ is no convolution or matmul)
    with FlopCounterMode(display=False) as counter, fx_config.patch(
            meta_nonzero_assume_all_nonzero=True):
        with torch.set_grad_enabled(train):
            head_outs, _ = model(meta_batch(batch))
            if train:
                leaves = [t for out in head_outs for t in
                          (out if isinstance(out, (list, tuple)) else [out])]
                sum(t.sum() for t in leaves).backward()
    return float(counter.get_total_flops())
