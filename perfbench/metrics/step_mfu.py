"""The whole step's share of the chip's peak in the traced window, in %:
the least time of every pass of the step's kernels on the window's states
(each the larger of its bytes over 3.35 TB/s and its operations over 67
TFLOP/s), summed, over the window's wall seconds.  A kernel taken off the
path leaves its own roofline silent; this share still bounds the step."""
from perfbench.roofline import window_bound


def read(ctx):
    if ctx.trace is None:
        return None
    least = sum(window_bound(ctx, k) for k in ctx.cfg["kernels"])
    return 100.0 * least / ctx.trace.window_s
