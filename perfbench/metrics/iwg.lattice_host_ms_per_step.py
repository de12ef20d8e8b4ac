"""Host milliseconds a Heun step of the lattice engine's eager pair
passes: the ``lattice.build`` (the sort glue and the pour K2) and
``lattice.pair`` (K1's wrapper) spans' wall seconds over the steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * (
        s["lattice.build"][1] + s["lattice.pair"][1]) / steps(s))
