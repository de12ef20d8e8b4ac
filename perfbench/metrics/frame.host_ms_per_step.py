"""Host milliseconds a Heun step spent inside the program's frames, less
the wait for the division count: the ``frame`` spans' wall seconds less
the ``growth.readback`` spans', over the steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * (
        s["frame"][1] - s["growth.readback"][1]) / steps(s))
