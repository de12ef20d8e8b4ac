"""Megabytes a file that the writer's jobs wrote (the ``output.bytes``
counter over the ``output.job`` spans)."""
from perfbench.spans import read_table


def read(ctx):
    return read_table(lambda s, c: c["output.bytes"] / s["output.job"][0]
                      / 1e6)
