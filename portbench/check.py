"""The comparison that decides ``correct``, and its control.

The reference (``portbench/reference``) runs in float32 with TF32 off, on
the same weights (the benchmark's ``state_dict``) and the same batches.

Serving compares what the timed window produced for a sample of its
batches (``serve_numbers``), in two stages, because a greedy NMS is not
continuous in its inputs (a score a rounding lower reorders the candidates
and can keep another box) and bfloat16 convs against float32 ones would
make any direct comparison of the kept boxes meaningless:

* ``head_gap``: the forward, ``||program - reference|| / ||reference||``
  over the sample of each head output (class scores, box regressions,
  direction or centerness), the worst of them;
* ``valid_mismatch``: voxels whose seen-by-a-view mask differs;
* ``decode_mismatch``: the reference's own decode and NMS run on the
  program's head outputs and mask, and the detection slots that differ
  from those that reached the host (validity, label, box within 1e-3,
  score within 1e-5).

Training compares the first three steps of the very step object the window
then drives (``train_numbers``): each step's loss terms (``loss_gap``,
relative), the first gradient as the optimizer got it, worked out from
AdamW's state after one step (``grad_gap``), and the change of every
parameter and batch-norm statistic after the three (``change_gap``).  A
leaf's gap is ``| ||program|| - ||reference|| |`` over the larger of the
reference leaf's norm and the median leaf's; leaves whose reference
gradient is under a thousandth of the median leaf's (moved by round-off
alone under Adam; the median over the leaves the loss reaches at all) are
left out of both.

The control (``LowPrecisionConvs``) puts the reference in the program's
place with every convolution's operands rounded to the precision below the
configuration's bfloat16, with a per-tensor scale: float8 e4m3 for serving
(its head outputs drift 12-15x the bfloat16 reference's), symmetric int8
for training, where the gradients are rounded too (float8's rounding is
zero-mean and averages out of every norm and mean the step's check reads;
int8's flushes the small gradients).
"""

from __future__ import annotations

import dataclasses
import statistics

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

BOX_TOL, SCORE_TOL = 1e-3, 1e-5
LEAF_FLOOR = 1e-3


def fp8_round(x):
    """``x`` through float8 e4m3 with a per-tensor scale, back in its
    dtype; the gradient passes straight through the rounding."""
    scale = (x.detach().abs().amax().float() / 448.0).clamp(min=1e-30)
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).float()
         * scale).to(x.dtype)
    return x + (q - x).detach()


def int8_round(x):
    """``x`` through symmetric int8 with a per-tensor scale, back in its
    dtype; the gradient passes straight through the rounding."""
    scale = (x.detach().abs().amax().float() / 127.0).clamp(min=1e-30)
    q = (torch.round(x.detach().float() / scale).clamp(-127, 127)
         * scale).to(x.dtype)
    return x + (q - x).detach()


class _GradRounded(torch.autograd.Function):
    """Identity forward; the gradient rounded on its way back, so that the
    backward's convolutions take rounded operands too."""

    @staticmethod
    def forward(ctx, y, rounding):
        ctx.rounding = rounding
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return ctx.rounding(grad), None


class LowPrecisionConvs(TorchFunctionMode):
    """Every ``F.conv2d`` / ``conv3d`` inside takes
    its input and weight through ``rounding`` (:func:`fp8_round` or
    :func:`int8_round`), and, in a training step, the gradient of its
    output as well."""

    CONVS = (F.conv2d, F.conv3d)

    def __init__(self, rounding):
        super().__init__()
        self.rounding = rounding

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.CONVS:
            return func(*args, **kwargs)
        out = func(self.rounding(args[0]), self.rounding(args[1]),
                   *args[2:], **kwargs)
        if out.requires_grad:
            return _GradRounded.apply(out, self.rounding)
        return out


class precise:
    """float32 with TF32 off for the block; restores the flags."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def reference_model(reference, cfg, state_dict, device, dtype='float32'):
    """The model of ``cfg`` of the ``reference`` module
    (``spec.reference``) at ``dtype`` holding a copy of ``state_dict``."""
    model = reference.ImVoxelNet(dataclasses.replace(cfg,
                                                     compute_dtype=dtype))
    model.load_state_dict(state_dict)
    return model.to(device)


def _leaves(head_outs):
    """The head outputs as a list of kinds, each a list of tensors (an
    indoor head's levels)."""
    return [list(o) if isinstance(o, (list, tuple)) else [o]
            for o in head_outs]


def _rows(head_outs, rows):
    return [[t[rows] for t in kind] for kind in _leaves(head_outs)]


def first_forward(model):
    """``(outputs, remove)``: ``outputs`` is filled with the detached head
    outputs of ``model``'s next forward (``remove()`` drops the hook)."""
    outputs = []

    def hook(_mod, _args, out):
        if not outputs:
            outputs.append([[t.detach().clone() for t in kind]
                            for kind in _leaves(out[0])])
    return outputs, model.register_forward_hook(hook).remove


def head_gap_ratio(got, want, want16) -> float:
    """The worst output kind's ``||got - want|| / ||want16 - want||``:
    the program's gap from the float32 reference over the one the
    bfloat16 reference has by itself (kinds as :func:`_leaves` lists)."""
    worst = 0.0
    for g, w, h in zip(got, want, want16):
        err = sum(float(((a.float() - b.float()) ** 2).sum())
                  for a, b in zip(g, w))
        err16 = sum(float(((a.float() - b.float()) ** 2).sum())
                    for a, b in zip(h, w))
        worst = max(worst, (err / max(err16, 1e-30)) ** 0.5)
    return worst


def _decode_mismatch(got: dict, want: dict) -> int:
    """Detection slots of ``got`` (host tensors) that differ from
    ``want``'s."""
    gv, wv = got['valid'].bool(), want['valid'].cpu().bool()
    both = gv & wv
    box = (got['boxes'].float() - want['boxes'].cpu().float()).abs().amax(-1)
    score = (got['scores'].float() - want['scores'].cpu().float()).abs()
    label = got['labels'].long() != want['labels'].cpu().long()
    bad = (gv != wv) | (both & ((box > BOX_TOL) | (score > SCORE_TOL)
                                | label))
    return int(bad.sum())


def serve_numbers(reference, cfg, model, model16, kept,
                  block: int = 2) -> dict:
    """The serving numbers over ``kept``: dicts of ``batch``,
    ``head_outs``, ``valid`` (the program's, on the device) and ``dets``
    (what reached the host).  ``model`` is the model of ``cfg`` of the
    ``reference`` module, whose decode judges the program's;
    ``model16`` is the same at the program's precision, bfloat16 convs:
    ``head_gap_ratio`` holds the program's gap against the one that
    precision gives by itself, output by output.  The models run
    ``block`` rows at a time."""
    err, err16, ref_sq = None, None, None
    valid_mismatch = decode_mismatch = 0
    model.eval()
    model16.eval()
    with precise(), torch.no_grad():
        for item in kept:
            batch = item['batch']
            b = batch['images'].shape[0]
            for r0 in range(0, b, block):
                rows = slice(r0, min(b, r0 + block))
                sub = {k: v[rows] for k, v in batch.items()}
                r_outs, r_valid = model(sub)
                h_outs, _ = model16(sub)
                p_kinds = _rows(item['head_outs'], rows)
                r_kinds, h_kinds = _leaves(r_outs), _leaves(h_outs)
                if err is None:
                    err, err16, ref_sq = ([0.0] * len(r_kinds)
                                          for _ in range(3))
                for i, (pk, rk, hk) in enumerate(zip(p_kinds, r_kinds,
                                                     h_kinds)):
                    for p, r, h in zip(pk, rk, hk):
                        r = r.float()
                        err[i] += float(((p.float() - r) ** 2).sum())
                        err16[i] += float(((h.float() - r) ** 2).sum())
                        ref_sq[i] += float((r ** 2).sum())
                valid_mismatch += int(
                    (item['valid'][rows] != r_valid).sum())
            want = reference.imvoxelnet_predict(cfg, item['head_outs'],
                                                item['valid'],
                                                batch['origins'])
            decode_mismatch += _decode_mismatch(item['dets'], want)
    gaps = [(e / max(r, 1e-30)) ** 0.5 for e, r in zip(err, ref_sq)]
    gaps16 = [(e / max(r, 1e-30)) ** 0.5 for e, r in zip(err16, ref_sq)]
    return dict(head_gap=max(gaps), head_gap_bf16=max(gaps16),
                head_gap_ratio=max(g / max(h, 1e-30)
                                   for g, h in zip(gaps, gaps16)),
                valid_mismatch=valid_mismatch,
                decode_mismatch=decode_mismatch)


def control_serve_items(reference, cfg, control, batches, block: int = 2):
    """``kept`` items of the control in the program's place: its forward
    (``control``, a model of ``cfg`` of the ``reference`` module) with
    float8 convolution operands and the reference's decode of its
    outputs."""
    kept = []
    control.eval()
    with LowPrecisionConvs(fp8_round), torch.no_grad():
        for batch in batches:
            b = batch['images'].shape[0]
            outs, valids = [], []
            for r0 in range(0, b, block):
                rows = slice(r0, min(b, r0 + block))
                o, v = control({k: t[rows] for k, t in batch.items()})
                if not outs:
                    nested = [isinstance(k, (list, tuple)) for k in o]
                outs.append(_leaves(o))
                valids.append(v)
            head_outs = [[torch.cat([o[i][j] for o in outs])
                          for j in range(len(outs[0][i]))]
                         for i in range(len(outs[0]))]
            head_outs = [k if n else k[0] for k, n in zip(head_outs, nested)]
            valid = torch.cat(valids)
            dets = reference.imvoxelnet_predict(cfg, head_outs, valid,
                                                batch['origins'])
            kept.append(dict(batch=batch, head_outs=head_outs, valid=valid,
                             dets={k: v.cpu() for k, v in dets.items()}))
    return kept


# ---------------------------------------------------------------- training

def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def change_norms(before: dict, after: dict) -> dict:
    """``||after - before||`` of every float entry both hold."""
    return {k: float(torch.linalg.vector_norm(
        after[k].double() - before[k].to(after[k].device).double()))
        for k in after if k in before and after[k].is_floating_point()}


def moving(state_dict: dict) -> dict:
    """The parameters and batch-norm statistics of a ``state_dict`` (not
    the step counters)."""
    return {k: v for k, v in state_dict.items()
            if v.is_floating_point()}


def reference_steps(reference, cfg, config, state_dict, batches, device,
                    dtype: str = 'float32', rounding=None) -> dict:
    """The first steps on ``batches`` of the model of ``cfg`` of the
    ``reference`` module, with its optimizer and step, at ``dtype`` convs
    (``rounding``: the control, every convolution's operands rounded both
    ways, :class:`LowPrecisionConvs`): ``losses`` (a list
    of ``{term: value}``), ``grads`` (first-step gradient norms by name)
    and ``changes`` (norms of the change of every parameter and statistic
    after the steps)."""
    model = reference_model(reference, cfg, state_dict, device, dtype)
    t = config['train']
    optimizer, scheduler = reference.make_optimizer(
        model, t['lr'], t['weight_decay'], t['backbone_lr_mult'],
        t['grad_clip_norm'], steps_per_epoch=t['steps_per_epoch'],
        lr_steps=tuple(t['lr_steps']))
    step = reference.make_train_step(model, optimizer, scheduler)
    names = {p: n for n, p in model.named_parameters()}
    losses, grads = [], None
    outputs, remove = first_forward(model)
    with LowPrecisionConvs(rounding) if rounding else precise():
        for i, batch in enumerate(batches):
            metrics = step(batch)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                grads = norms(first_gradients(optimizer, names))
    remove()
    changes = change_norms(moving(state_dict), moving(model.state_dict()))
    return dict(losses=losses, grads=grads, changes=changes,
                head_outs=outputs[0])


def first_gradients(optimizer, names) -> dict:
    """Each parameter's first-step gradient as AdamW got it: ``exp_avg /
    (1 - beta1)`` after one step."""
    out = {}
    for group in optimizer.param_groups:
        for p in group['params']:
            state = optimizer.state.get(p, {})
            if 'exp_avg' in state:
                out[names[p]] = state['exp_avg'] / (1.0 - group['betas'][0])
    return out


def _leaf_gaps(got: dict, want: dict, keep, floor: float) -> dict:
    """Each leaf's gap ``| got - want | / max(want, floor)``."""
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], floor)
            for k in keep}


def _gaps(got: dict, want: dict):
    """The loss gap and the per-leaf gradient and change gaps of ``got``
    against ``want``."""
    loss_gap = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for g, w in zip(got['losses'], want['losses']) for k in w)
    median = statistics.median(v for v in want['grads'].values() if v > 0)
    live = [k for k, v in want['grads'].items() if v >= LEAF_FLOOR * median]
    floor = statistics.median(want['grads'][k] for k in live)
    grad = _leaf_gaps(got['grads'], want['grads'], live, floor)
    change_floor = statistics.median(want['changes'][k] for k in live)
    stats = [k for k, v in want['changes'].items() if v > 0
             and ('running_mean' in k or 'running_var' in k)]
    change = _leaf_gaps(got['changes'], want['changes'], live + stats,
                        change_floor)
    return loss_gap, grad, change


def train_numbers(got: dict, want: dict, want16: dict = None,
                  detail: dict = None) -> dict:
    """The training numbers of the program's readings ``got`` against the
    float32 reference's ``want`` (both as :func:`reference_steps` returns
    them): ``loss_gap``, and over the leaves the worst and the median
    ``grad_gap`` and ``change_gap``; with ``want16``, the bfloat16
    reference's readings, the first forward's ``head_gap_ratio``, the same
    gaps of that precision by itself and the program's over them
    (``*_ratio``).  ``detail``, where given, takes
    the worst leaves."""
    loss_gap, grad, change = _gaps(got, want)
    out = dict(loss_gap=loss_gap, grad_gap=max(grad.values()),
               change_gap=max(change.values()),
               grad_gap_median=statistics.median(grad.values()),
               change_gap_median=statistics.median(change.values()))
    if want16 is not None:
        out['head_gap_ratio'] = head_gap_ratio(
            got['head_outs'], want['head_outs'], want16['head_outs'])
        loss16, grad16, change16 = _gaps(want16, want)
        ref = dict(loss_gap=loss16, grad_gap=max(grad16.values()),
                   change_gap=max(change16.values()),
                   grad_gap_median=statistics.median(grad16.values()),
                   change_gap_median=statistics.median(change16.values()))
        for key, value in ref.items():
            out[key + '_bf16'] = value
            out[key + '_ratio'] = out[key] / max(value, 1e-30)
    if detail is not None:
        for name, gaps in (('grad', grad), ('change', change)):
            worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            detail[name] = [[k, v, got[name + 's'].get(k),
                             want[name + 's'][k]] for k, v in worst]
    return out
