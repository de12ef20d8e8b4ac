"""The share of the traced window's Heun steps that replayed a captured
CUDA graph: the ``integrator.graph_replay`` counter over the
``integrator.heun_step`` spans (none where the program keeps no such
counter)."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: c["integrator.graph_replay"] / steps(s))
