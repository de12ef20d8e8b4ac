"""The share of the traced window's grid engine passes that replayed a
captured CUDA graph: the ``grid.graph_replay`` counter (two passes a
step) over twice the ``integrator.heun_step`` spans (none where the
program keeps no such counter)."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(
        lambda s, c: c["grid.graph_replay"] / (2 * steps(s)))
