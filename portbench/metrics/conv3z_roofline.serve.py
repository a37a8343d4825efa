"""Serving: share of B3's operations bound on the KITTI neck's block0."""

from portbench import readers


def read(ctx):
    return readers.conv3z_roofline(ctx, 'serve')
