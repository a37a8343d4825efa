"""Training: scenes of all the window's completed steps over its seconds."""

from portbench import readers


def read(ctx):
    return readers.scenes_per_s(ctx) if readers.mode_is(ctx, 'train') else None
