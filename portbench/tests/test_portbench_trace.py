"""The trace digest on a hand-made chrome trace: the window, the busy
union, layer billing direct and through a backward operator's sequence
number, and the idle gaps."""

from __future__ import annotations

from portbench import trace


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur, pid=pid,
                tid=tid, args=args)


def _events():
    return [
        _x('user_annotation', trace.ITER, 0, 100),
        _x('user_annotation', trace.LAYER + 'neck3d', 10, 30),
        _x('cpu_op', 'aten::conv3d', 12, 5, **{'Sequence number': 7}),
        _x('cuda_runtime', 'cudaLaunchKernel', 13, 1, correlation=1),
        _x('cuda_runtime', 'cudaLaunchKernel', 50, 1, correlation=2),
        # the backward thread: its operator names forward sequence 7
        _x('cpu_op', 'ConvolutionBackward0', 60, 10, tid=2,
           **{'Sequence number': 7, 'Fwd thread id': 1}),
        _x('cuda_runtime', 'cudaLaunchKernel', 61, 1, tid=2,
           correlation=3),
        _x('kernel', 'conv_fwd', 20, 10, pid=0, tid=7, correlation=1),
        _x('kernel', 'other', 55, 5, pid=0, tid=7, correlation=2),
        _x('kernel', 'conv_bwd', 70, 20, pid=0, tid=7, correlation=3),
    ]


def test_digest_bills_layers_and_reads_the_window():
    d = trace.digest(_events())
    assert d['iterations'] == 1
    assert d['window_s'] == 100 / 1e6
    assert abs(d['busy_s'] - 35 / 1e6) < 1e-12
    assert abs(d['layers']['neck3d'] - 30 / 1e6) < 1e-12
    assert abs(d['layers']['other'] - 5 / 1e6) < 1e-12
    assert d['kernels']['conv_bwd'] == 20 / 1e6
    # gaps 0-20, 30-55, 60-70, 90-100: the longest opens at 30, inside the
    # neck's span on the host
    name, length = d['idle_gaps'][0]
    assert abs(length - 25 / 1e6) < 1e-12
    assert name.startswith(trace.LAYER + 'neck3d')
    assert len(d['idle_gaps']) == 4


def test_union_length_merges_overlaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
