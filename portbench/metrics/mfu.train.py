"""Training: the step's forward and backward FLOPs over the window, as a
share of the bfloat16 peak."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, 'train')
