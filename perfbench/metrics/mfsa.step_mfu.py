"""The tutorial model's share of the chip's peak in the traced window of
the model_features_sequential_addition cell, in %: the least time of its
grid pair passes (two a Heun step) on the window's states, with the
model's work (``perfbench/roofline_mfsa.py``), summed, over the window's
wall seconds."""
from perfbench.roofline_mfsa import window_bound


def read(ctx):
    if ctx.trace is None:
        return None
    least = window_bound(ctx)
    if least is None:
        return None
    return 100.0 * least / ctx.trace.window_s
