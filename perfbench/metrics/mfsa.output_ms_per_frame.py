"""Host milliseconds a frame of the tutorial example's ``write_frame``:
the ``output.frame`` span (its writes and the cell types' readback) over
the traced window's intervals, one frame each; None where the program
has no such span."""
from perfbench.spans import read_table


def read(ctx):
    if ctx.trace is None:
        return None
    frames = int(ctx.traffic["trace_intervals"])
    return read_table(lambda s, c: 1e3 * s["output.frame"][1] / frames
                      if s["output.frame"][0] else None)
