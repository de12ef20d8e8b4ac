"""The share of the traced window's eager Heun steps whose glue replayed
captured CUDA graphs: the ``integrator.segment_replay`` counter (two
segments a step) over twice the ``integrator.heun_step`` spans (none
where the program keeps no such counter)."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(
        lambda s, c: c["integrator.segment_replay"] / (2 * steps(s)))
