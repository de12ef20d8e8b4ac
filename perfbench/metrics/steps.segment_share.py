"""The share of the slot-order integrator's pair passes in the traced
window whose glue replayed a captured CUDA graph: the
``integrator.segment_replay`` counter (a segment after each pass) over
the window's passes (``ctx.loop.pass_states()``); none where the program
keeps no such counter."""
from perfbench.spans import read_table


def read(ctx):
    passes = sum(p for _, _, p in ctx.loop.pass_states())
    return read_table(lambda s, c: c["integrator.segment_replay"] / passes)
