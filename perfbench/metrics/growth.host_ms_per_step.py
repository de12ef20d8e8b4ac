"""Host milliseconds a Heun step of the growth layer's own issue: the self
seconds of ``growth.proliferate`` (its readback left out) and of
``growth.record_divisions``, over the steps."""
from perfbench.spans import read_table, steps


def read(ctx):
    return read_table(lambda s, c: 1e3 * (
        s["growth.proliferate"][2] + s["growth.record_divisions"][2])
        / steps(s))
