"""Host milliseconds a Heun step of the grid engine's gather passes: the
``grid.build`` (the cube ids, the sort and the scatter tables) and
``grid.pair`` (the candidate blocks' gathers, the force and the sums)
spans' wall seconds over the steps; None where the program has no such
spans."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * (
        s["grid.build"][1] + s["grid.pair"][1]) / steps(s))
