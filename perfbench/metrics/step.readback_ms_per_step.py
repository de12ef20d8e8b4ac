"""Milliseconds a Heun step that the host waits on the device for values:
the wall seconds of the ``<layer>.readback`` spans over the traced
window's Heun steps; None where the program has no step span
(``model.step``, ``integrator.take_steps`` or ``frame``), 0 where it
reads nothing back."""
from perfbench.spans import read_table

STEP = ("model.step", "integrator.take_steps", "frame")


def read(ctx):
    def ms(s, c):
        if not any(k in s for k in STEP):
            return None
        return 1e3 * sum(v[1] for k, v in s.items()
                         if k.endswith(".readback")) / ctx.trace.steps
    return read_table(ms)
