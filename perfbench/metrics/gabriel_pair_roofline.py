"""K5's share of its roofline in the traced window, in %: the least time
of its passes on the window's states (``perfbench/roofline_gabriel.py``)
over the device time of its kernel."""
from perfbench.roofline_gabriel import window_bound

KERNELS = ("gabriel_pair_kernel",)


def read(ctx):
    if ctx.trace is None or "gabriel_pair" not in ctx.cfg["kernels"]:
        return None
    device_s = ctx.op_seconds(KERNELS)
    if not device_s > 0:
        return None
    return 100.0 * window_bound(ctx, "gabriel_pair") / device_s
