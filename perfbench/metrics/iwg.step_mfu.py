"""The whole intercalation_w_gradient step's share of the chip's peak in
the traced window, in %: the least time of every pass of its kernels (K1
with the functor's work and the pour K2 of its lattice build, twice a
Heun step) on the window's states, summed, over the window's wall
seconds."""
from perfbench.roofline_iwg import window_bound


def read(ctx):
    if ctx.trace is None:
        return None
    least = [window_bound(ctx, k) for k in ctx.cfg["kernels"]]
    if None in least:
        return None
    return 100.0 * sum(least) / ctx.trace.window_s
