"""Host readbacks a Heun step: the count of the ``<layer>.readback``
spans (each a wait of the host for a value on the device) over the
traced window's Heun steps; None where the program has no step span
(``model.step``, ``integrator.take_steps`` or ``frame``), 0 where it
reads nothing back."""
from perfbench.spans import read_table

STEP = ("model.step", "integrator.take_steps", "frame")


def read(ctx):
    def per_step(s, c):
        if not any(k in s for k in STEP):
            return None
        return sum(v[0] for k, v in s.items()
                   if k.endswith(".readback")) / ctx.trace.steps
    return read_table(per_step)
