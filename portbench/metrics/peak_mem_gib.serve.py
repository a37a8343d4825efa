"""Serving: the window's peak of allocated device memory, GiB."""

from portbench import readers


def read(ctx):
    return readers.peak_mem_gib(ctx, 'serve')
