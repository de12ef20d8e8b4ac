"""The 90th percentile of the wall milliseconds from the end of one output
interval (at its flag readback) to the end of the next, over every
interval of the window."""
from perfbench.harness import quantile


def read(ctx):
    if ctx.window is None or len(ctx.window.intervals) < 2:
        return None
    return 1e3 * quantile(ctx.window.intervals, 0.9)
