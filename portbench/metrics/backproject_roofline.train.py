"""Training: share of the bytes bound of B1's forward and backward."""

from portbench import readers


def read(ctx):
    return readers.backproject_roofline(ctx, 'train')
