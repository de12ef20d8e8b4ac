"""Seconds from the start of the process to the first timed interval:
imports, the kernels' load (and, in a checkout's first run, their build),
the inputs and the warm-up."""


def read(ctx):
    return ctx.setup_s
