"""Device milliseconds a Heun step of the ``index_add`` kernels (their
CUDA names start ``indexFunc``): the protrusions' scatter of their pull
onto the cells; None where the window ran none."""

KERNELS = ("indexFunc",)


def read(ctx):
    if ctx.trace is None or not ctx.trace.steps:
        return None
    device_s = ctx.op_seconds(KERNELS)
    if not device_s > 0:
        return None
    return 1e3 * device_s / ctx.trace.steps
