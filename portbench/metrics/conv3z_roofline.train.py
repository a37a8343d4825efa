"""Training: share of B3's operations bound, forward and input gradient of
block0."""

from portbench import readers


def read(ctx):
    return readers.conv3z_roofline(ctx, 'train')
