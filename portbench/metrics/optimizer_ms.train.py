"""Training: device ms a step of the clip and AdamW."""

from portbench import readers


def read(ctx):
    return readers.layer_ms(ctx, 'train', 'optimizer')
