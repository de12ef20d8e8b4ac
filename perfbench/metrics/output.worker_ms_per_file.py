"""Milliseconds per file of the writer's worker thread: the ``output.job``
spans' wall seconds (the transfer to the host, the formatting, the
write) over the jobs."""
from perfbench.spans import read_table


def read(ctx):
    return read_table(lambda s, c: 1e3 * s["output.job"][1]
                      / s["output.job"][0])
