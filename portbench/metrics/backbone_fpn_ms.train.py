"""Training: device ms a step of the backbone and the FPN, their backward
included."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'train', 'backbone_fpn')
