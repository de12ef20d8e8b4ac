"""K2's share of its roofline in the traced window, in %: the least time
of the window's lattice builds' pours over the device time of the pour
kernel (the wrapper's one memset of its block counts is left out: a
memset of the program is not told apart by name from others)."""
from perfbench.roofline import roofline_pct

KERNELS = ("pour_kernel",)


def read(ctx):
    return roofline_pct(ctx, "pour", KERNELS)
