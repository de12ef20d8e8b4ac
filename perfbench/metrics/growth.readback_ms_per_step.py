"""Milliseconds a Heun step that the host waits for the division count
(the one ``.tolist()`` of ``growth.proliferate``, which waits for the
device's queue): the ``growth.readback`` spans' wall seconds over the
steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * s["growth.readback"][1]
                      / steps(s))
