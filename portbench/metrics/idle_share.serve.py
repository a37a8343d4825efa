"""Serving: share of the traced window with no device event."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, 'serve')
