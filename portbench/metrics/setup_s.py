"""Seconds from the process's start to the first timed iteration."""


def read(ctx):
    return ctx['setup_s']
