"""Host milliseconds a Heun step of the protrusions' rewiring: the
``rewiring.update`` spans' wall seconds (the draws and the rule) over the
steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * s["rewiring.update"][1]
                      / steps(s))
