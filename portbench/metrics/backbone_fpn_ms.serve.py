"""Serving: device ms a batch of the ResNet-50 backbone and the FPN."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'serve', 'backbone_fpn')
