"""K1's share of its roofline in the traced window, in %: the least time
of its passes on the window's states (``perfbench/roofline.py``) over the
device time of its two kernels."""
from perfbench.roofline import roofline_pct

KERNELS = ("lattice_pair_kernel", "extras_pair_kernel")


def read(ctx):
    return roofline_pct(ctx, "lattice_pair", KERNELS)
