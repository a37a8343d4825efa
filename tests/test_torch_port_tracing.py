"""The port's layer spans (``utils/tracing.py``) on the CPU, on a shallow
``tiny_kitti_test``: the spans a serving call (forward + decode) and a
training step open, under ``torch.profiler`` and under ``recording()``,
with their nesting; outputs and gradients bit for bit with the spans on and
off; nothing recorded or opened with neither sink on; and an exported
program with the same nodes as one traced with the spans taken out."""

import dataclasses
import sys

import pytest
import torch

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models.detector import (build_model,
                                                  imvoxelnet_predict)
from imvoxelnet_tpu_torch.parallel import train
from imvoxelnet_tpu_torch.utils import export as export_lib
from imvoxelnet_tpu_torch.utils import synthetic, tracing

OVERRIDES = ['model.backbone_stage_blocks=(1,1,1,1)',
             'model.anchor_head.nms_pre=4']

# span -> the span it opens inside (None: top level)
SERVE = {'forward': None, 'backbone_fpn': 'forward',
         'backproject': 'forward', 'neck3d': 'forward', 'head': 'forward',
         'predict': None, 'nms': 'predict'}
TRAIN = {'train_step': None, 'zero_grad': 'train_step',
         'forward': 'train_step', 'backbone_fpn': 'forward',
         'backproject': 'forward', 'neck3d': 'forward', 'head': 'forward',
         'loss': 'train_step', 'targets': 'loss', 'backward': 'train_step',
         'optimizer': 'train_step'}


@pytest.fixture(scope='module')
def tiny():
    preset = presets.apply_overrides(presets.get_preset('tiny_kitti_test'),
                                     OVERRIDES)
    cfg = dataclasses.replace(preset.model, compute_dtype='float32')
    data = preset.data
    serve_batch = synthetic.serving_batch(data.dataset, 2, 'cpu', seed=3,
                                          views=data.n_images_test,
                                          size=data.test_size)
    train_batch = synthetic.kitti_train_batch(2, 'cpu', seed=4,
                                              size=data.train_size)
    return dict(preset=preset, cfg=cfg, serve_batch=serve_batch,
                train_batch=train_batch)


def _serve(tiny, model):
    with torch.no_grad():
        head_outs, valid = model(tiny['serve_batch'])
        return head_outs, imvoxelnet_predict(tiny['cfg'], head_outs, valid)


def _model(tiny):
    model = build_model(tiny['cfg'], device='cpu', seed=5)
    with torch.no_grad():
        model.bbox_head.conv_cls.bias.zero_()     # detections pass
    return model


def _train_step(tiny, model):
    p = tiny['preset']
    opt, sched = train.make_optimizer(
        model, p.lr, p.weight_decay, p.backbone_lr_mult, p.grad_clip_norm,
        steps_per_epoch=10, lr_steps=p.lr_steps)
    return train.make_train_step(model, opt, sched), opt


def _profiled_spans(fn):
    """``[(name, parent name)]`` of the ``imvx.`` ranges ``fn`` opens under
    a CPU profiler, in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    found = sorted(
        ((e.time_range.start, -e.time_range.end, e.thread,
          e.name[len(tracing.PREFIX):]) for e in prof.events()
         if e.name.startswith(tracing.PREFIX)))
    out = []
    for i, (start, neg_end, thread, name) in enumerate(found):
        parents = [f for f in found[:i] if f[2] == thread
                   and f[0] <= start and -f[1] >= -neg_end]
        out.append((name, parents[-1][3] if parents else None))
    return out


def _recorded_spans(fn):
    with tracing.recording() as records:
        fn()
    for name, parent, _, t0, t1 in records:
        assert t1 is not None and t0 <= t1, name
        if parent is not None:
            assert records[parent][3] <= t0 and t1 <= records[parent][4]
    return [(r[0], None if r[1] is None else records[r[1]][0])
            for r in records]


@pytest.mark.parametrize('mode', ['serve', 'train'])
def test_spans_and_their_nesting_in_both_sinks(tiny, mode):
    model = _model(tiny)
    if mode == 'serve':
        want, fn = SERVE, lambda: _serve(tiny, model)
    else:
        step, _ = _train_step(tiny, model)
        want, fn = TRAIN, lambda: step(tiny['train_batch'])
    fn()                                             # warm
    profiled, recorded = _profiled_spans(fn), _recorded_spans(fn)
    assert sorted(profiled) == sorted(want.items())
    assert recorded == profiled


def test_outputs_and_gradients_are_the_same_with_spans_on_and_off(tiny):
    runs = []
    for sinks in (False, True):
        model = _model(tiny)
        step, opt = _train_step(tiny, model)
        if sinks:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            with prof, tracing.recording() as records:
                served = _serve(tiny, model)
                metrics = step(tiny['train_batch'])
            assert records
        else:
            served = _serve(tiny, model)
            metrics = step(tiny['train_batch'])
        grads = [opt.state[p]['exp_avg'].clone()
                 for g in opt.param_groups for p in g['params']]
        runs.append((served, metrics, grads,
                     [p.detach().clone() for p in model.parameters()]))
    (head0, dets0), m0, g0, p0 = runs[0]
    (head1, dets1), m1, g1, p1 = runs[1]
    for a, b in zip(head0, head1):
        assert torch.equal(a, b)
    for key in dets0:
        assert torch.equal(dets0[key], dets1[key]), key
    assert dets0['valid'].any()
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_no_sink_opens_no_range_and_records_nothing(tiny, monkeypatch):
    def refuse(*_):
        raise AssertionError('a record_function range was opened')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    with tracing.recording() as records:
        pass
    model = _model(tiny)
    step, _ = _train_step(tiny, model)
    _serve(tiny, model)
    step(tiny['train_batch'])
    assert records == []
    assert tracing.span('forward') is tracing.span('forward')


def test_exported_program_holds_the_nodes_it_holds_without_spans(
        tiny, monkeypatch):
    """Exported with both sinks on, the program has the node targets of one
    exported with every span swapped for a no-op context."""
    model = _model(tiny).eval()
    batch = {k: tiny['serve_batch'][k][:1] for k in export_lib.BATCH_KEYS}

    def targets():
        with torch.no_grad():
            program = torch.export.export(export_lib._Baked(tiny['cfg'], model),
                                          (batch,), strict=False)
        return [str(n.target) for n in program.graph.nodes]

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with tracing.recording() as records, prof:
        with_spans = targets()
    assert records == []
    assert not [e for e in prof.events()
                if e.name.startswith(tracing.PREFIX)]
    for module in list(sys.modules.values()):
        if getattr(module, 'span', None) is tracing.span:
            monkeypatch.setattr(module, 'span', lambda name: _NoSpan())
    assert targets() == with_spans


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid,
                args=args)


def test_profile_forward_stage_ms_from_the_spans():
    """``tools/profile_forward.py:span_ms`` on a hand-made trace of two
    steps: a kernel counts in every span around its launch, a backward
    kernel in the spans around its forward operator, one the engine
    launches for no operator in the main thread's ``backward``."""
    from imvoxelnet_tpu_torch.tools import analyze_trace, profile_forward
    p = tracing.PREFIX
    events = []
    for step in (0, 1000):
        t = step
        events += [
            _x('user_annotation', p + 'train_step', t + 1, 90),
            _x('user_annotation', p + 'forward', t + 2, 38),
            _x('user_annotation', p + 'dcn', t + 10, 20),
            _x('cpu_op', 'aten::mm', t + 12, 5, **{'Sequence number': t}),
            _x('cuda_runtime', 'cudaLaunchKernel', t + 13, 1,
               correlation=t + 1),
            _x('user_annotation', p + 'backward', t + 45, 40),
            _x('cpu_op', 'MmBackward0', t + 60, 10, tid=2,
               **{'Sequence number': t, 'Fwd thread id': 1}),
            _x('cuda_runtime', 'cudaLaunchKernel', t + 61, 1, tid=2,
               correlation=t + 2),
            _x('cuda_runtime', 'cudaLaunchKernel', t + 75, 1, tid=2,
               correlation=t + 3),
            _x('kernel', 'mm', t + 20, 10, tid=7, correlation=t + 1),
            _x('kernel', 'mm_bwd', t + 70, 20, tid=7, correlation=t + 2),
            _x('kernel', 'acc', t + 91, 4, tid=7, correlation=t + 3)]
    stacks = analyze_trace.launch_spans(events,
                                        analyze_trace.launch_map(events))
    assert stacks[2] == ['dcn', 'forward', 'train_step']
    assert stacks[3] == ['backward', 'train_step']
    ms = profile_forward.span_ms(events, 2)
    assert ms == {'train_step': pytest.approx(0.034),
                  'dcn': pytest.approx(0.030),
                  'forward': pytest.approx(0.030),
                  'backward': pytest.approx(0.004)}


def test_profile_forward_sync_calls_and_host_ms():
    """``tools/profile_forward.py``: the waiting host calls of a hand-made
    trace by their innermost span, and a recording's host ms by span."""
    from imvoxelnet_tpu_torch.tools import profile_forward
    p = tracing.PREFIX
    events = [
        _x('user_annotation', p + 'predict', 0, 50),
        _x('user_annotation', p + 'nms', 10, 20),
        _x('cuda_runtime', 'cudaMemcpy', 15, 2, correlation=1),
        _x('cuda_runtime', 'cudaLaunchKernel', 20, 1, correlation=2),
        _x('cuda_runtime', 'cudaStreamSynchronize', 40, 3),
        _x('cuda_runtime', 'cudaStreamSynchronize', 60, 3)]
    assert profile_forward.span_syncs(events) == {'nms': 1, 'predict': 1,
                                                  None: 1}
    records = [('forward', None, 1, 0, 4_000_000),
               ('neck3d', 0, 1, 1_000_000, 2_500_000),
               ('forward', None, 1, 10_000_000, 12_000_000)]
    assert profile_forward.host_ms(records, 2) == {'forward': 3.0,
                                                   'neck3d': 0.75}
    with tracing.recording() as model_free:
        with tracing.span('forward'):
            with tracing.span('neck3d'):
                pass
    ms = profile_forward.host_ms(model_free, 1)
    assert list(ms) == ['forward', 'neck3d']
    assert ms['forward'] >= ms['neck3d'] >= 0
