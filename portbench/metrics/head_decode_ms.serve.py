"""Serving: device ms a batch of the head, the decode and the NMS."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'serve', 'head_decode')
