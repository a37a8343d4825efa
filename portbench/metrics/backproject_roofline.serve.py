"""Serving: share of B1's bytes bound."""

from portbench import readers


def read(ctx):
    return readers.backproject_roofline(ctx, 'serve')
