"""Host milliseconds a Heun step that no layer's span covers: the self
seconds (wall less the spans opened inside) of the step spans,
``model.step``, ``integrator.take_steps`` and ``frame``, over the traced
window's Heun steps; None where the program has none of them."""
from perfbench.spans import read_table

STEP = ("model.step", "integrator.take_steps", "frame")


def read(ctx):
    def ms(s, c):
        held = [s[k][2] for k in STEP if k in s]
        return 1e3 * sum(held) / ctx.trace.steps if held else None
    return read_table(ms)
