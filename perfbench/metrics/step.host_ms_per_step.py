"""Host milliseconds of a Heun step inside the program's top-level call
for it: the wall seconds of the ``model.step`` (an example's step) and
``integrator.take_steps`` (``Solution.take_steps``) spans over the traced
window's Heun steps; None where the program has neither span."""
from perfbench.spans import read_table

STEP = ("model.step", "integrator.take_steps")


def read(ctx):
    def ms(s, c):
        held = [s[k][1] for k in STEP if k in s]
        return 1e3 * sum(held) / ctx.trace.steps if held else None
    return read_table(ms)
