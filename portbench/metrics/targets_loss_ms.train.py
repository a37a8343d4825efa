"""Training: device ms a step of the targets and the losses, their backward
included."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'train', 'targets_loss')
