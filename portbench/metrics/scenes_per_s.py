"""Serving: scenes whose detections reached the host in the window, over
its seconds."""

from portbench import readers


def read(ctx):
    return readers.scenes_per_s(ctx) if readers.mode_is(ctx, 'serve') else None
