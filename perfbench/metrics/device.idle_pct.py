"""The share of the traced window in which no operation ran on the
device, in %: 100 (1 - busy / window), busy the union of the device's
operations in the profiler's trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s > 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
