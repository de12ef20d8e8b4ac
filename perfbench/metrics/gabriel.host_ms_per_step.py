"""Host milliseconds a Heun step of the Gabriel engine's lattice route:
the ``gabriel.build`` (the sort glue and the pour K2) and ``gabriel.pair``
(K5's wrapper) spans' wall seconds over the steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * (
        s["gabriel.build"][1] + s["gabriel.pair"][1]) / steps(s))
