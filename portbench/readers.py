"""What the metric readers under ``portbench/metrics/`` share.  A reader
returns ``None`` where its run has nothing for it: another mode, no trace,
or no device event of its kernel."""

from __future__ import annotations

import statistics

from . import peaks


def mode_is(ctx, mode: str) -> bool:
    return ctx['mode'] == mode


def traced(ctx, mode: str):
    """The trace digest of a ``mode`` run, or ``None``."""
    if not mode_is(ctx, mode):
        return None
    return ctx.get('trace')


def layer_ms(ctx, mode: str, layer: str):
    """Device milliseconds an iteration billed to ``layer`` (its backward
    included in a training step)."""
    t = traced(ctx, mode)
    if t is None or not t['layers'].get(layer):
        return None
    return 1e3 * t['layers'][layer] / t['iterations']


def kernel_s(ctx, names) -> float:
    """Device seconds an iteration of the kernels named ``names``."""
    t = ctx['trace']
    return sum(v for k, v in t['kernels'].items()
               if any(n in k for n in names)) / t['iterations']


def mfu(ctx, mode: str):
    """Share (%) of the bfloat16 peak: the reference's count of the
    window's FLOPs over the traced window."""
    t = traced(ctx, mode)
    if t is None or not ctx.get('flops_per_iter'):
        return None
    return 100.0 * ctx['flops_per_iter'] * t['iterations'] / (
        t['window_s'] * peaks.PEAK_FLOPS_BF16)


def backproject_roofline(ctx, mode: str):
    """Share (%) of B1's bytes bound: the bytes its inputs need over the
    peak bandwidth, against its kernels' device time (a training step:
    forward and backward)."""
    t = traced(ctx, mode)
    if t is None:
        return None
    names = ctx['kernel_names']['b1'] + (
        ctx['kernel_names']['b1_grad'] if mode == 'train' else ())
    device = kernel_s(ctx, names)
    if device <= 0:
        return None
    return 100.0 * ctx['b1_bytes_per_iter'] / peaks.PEAK_BYTES / device


def conv3z_roofline(ctx, mode: str):
    """Share (%) of B3's operations bound: block0's operations over the
    bfloat16 peak, against B3's device time."""
    t = traced(ctx, mode)
    if t is None or not ctx.get('b3_flops_per_iter'):
        return None
    device = kernel_s(ctx, ctx['kernel_names']['b3'])
    if device <= 0:
        return None
    return 100.0 * ctx['b3_flops_per_iter'] / peaks.PEAK_FLOPS_BF16 / device


def idle_share(ctx, mode: str):
    """Share (%) of the traced window with no device event."""
    t = traced(ctx, mode)
    if t is None:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def peak_mem_gib(ctx, mode: str):
    """The window's peak of allocated device memory, GiB."""
    if not mode_is(ctx, mode) or not ctx.get('window_peak'):
        return None
    return ctx['window_peak'] / 2 ** 30


def p95_ms(ctx):
    """95th percentile of the window's iteration latencies, ms."""
    lat = ctx['latencies']
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]


def scenes_per_s(ctx):
    return ctx['iterations'] * ctx['batch'] / ctx['window_s']
