"""Training: device ms a step of the 3D neck, its backward included."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'train', 'neck3d')
