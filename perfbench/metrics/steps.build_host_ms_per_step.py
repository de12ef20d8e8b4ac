"""Host milliseconds a Heun step of the slot-order integrator's eager
lattice builds (the sort glue and the pour K2, two a step): the
``lattice.build`` spans' wall seconds over the traced window's Heun
steps; None where the program has no such span."""
from perfbench.spans import read_table


def read(ctx):
    return read_table(lambda s, c: 1e3 * s["lattice.build"][1]
                      / ctx.trace.steps)
