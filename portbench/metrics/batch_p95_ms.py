"""Serving: 95th percentile over all the window's batches of the time from
the host's enqueue to the detections on the host, ms."""

from portbench import readers


def read(ctx):
    return readers.p95_ms(ctx) if readers.mode_is(ctx, 'serve') else None
