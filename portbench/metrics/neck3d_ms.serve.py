"""Serving: device ms a batch of the 3D neck."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'serve', 'neck3d')
