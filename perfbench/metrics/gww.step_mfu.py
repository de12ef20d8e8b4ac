"""The whole growth_w_wall step's share of the chip's peak in the traced
window, in %: the least time of every pass of its kernels (K5 and the
pour K2 of its lattice build, twice a Heun step) on the window's states,
summed, over the window's wall seconds."""
from perfbench.roofline_gabriel import window_bound


def read(ctx):
    if ctx.trace is None:
        return None
    least = sum(window_bound(ctx, k) for k in ctx.cfg["kernels"])
    return 100.0 * least / ctx.trace.window_s
