"""K1's share of its roofline in the traced window of the
intercalation_w_gradient cell, in %: the least time of its passes on the
window's states with the functor's work (``perfbench/roofline_iwg.py``)
over the device time of the lattice pair kernel's launches."""
from perfbench.roofline_iwg import window_bound

KERNELS = ("lattice_pair_kernel", "extras_pair_kernel")


def read(ctx):
    if ctx.trace is None or "lattice_pair" not in ctx.cfg["kernels"]:
        return None
    device_s = ctx.op_seconds(KERNELS)
    least = window_bound(ctx, "lattice_pair")
    if not device_s > 0 or least is None:
        return None
    return 100.0 * least / device_s
