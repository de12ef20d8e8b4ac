"""K1's share of its roofline in the traced window of the slot-order
integrator's cell, in %: the least time of its passes on the window's
states (``roofline.k1_work`` on the branching functor, at the engine the
traffic states) over the device time of its two kernels."""
from perfbench import roofline

KERNELS = ("lattice_pair_kernel", "extras_pair_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.op_seconds(KERNELS)
    if not device_s > 0:
        return None
    e = ctx.traffic["engine"]
    cube = float(ctx.cfg["cube_size"])
    least = sum(
        passes * roofline.bound(*roofline.k1_work(
            *xyz, n, cube, e["grid_size"], e["capacity"],
            e["extras_cap"]))[0]
        for xyz, n, passes in ctx.loop.pass_states())
    return 100.0 * least / device_s
