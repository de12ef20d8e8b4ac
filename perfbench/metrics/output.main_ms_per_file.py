"""Milliseconds per file that the main thread spends in the writer, as
the program times it: ``output.submit`` (the snapshot and the queue's
backpressure) and ``output.drain``, over the files submitted."""
from perfbench.spans import read_table


def read(ctx):
    return read_table(lambda s, c: 1e3 * (
        s["output.submit"][1] + s.get("output.drain", (0, 0.0, 0.0))[1])
        / s["output.submit"][0])
