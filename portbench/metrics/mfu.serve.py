"""Serving: the window's FLOPs (the reference's dense count) over its
seconds, as a share of the bfloat16 peak."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, 'serve')
