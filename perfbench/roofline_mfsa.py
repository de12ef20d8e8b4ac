"""Roofline arithmetic of the tutorial model's pair pass
(``examples/model_features_sequential_addition.cu``), by ``roofline.py``'s
rules: the least time one H100 could take for a pass is the larger of the
bytes it must move over the memory rate and the operations it must do
over the f32 rate.  The work is the model's, not an implementation's: no
kernel of the program runs this force (the grid engine evaluates it in
plain PyTorch operations over its candidate blocks), and a kernel written
later reads the same work.

Operations, counted from the example's force on every ordered pair of
live cells closer than ``r_max`` (:func:`perfbench.reference.pairs.
cell_pairs`): the distance, the band and its weight, the force and its
sums, the friction and the velocity it mixes, and the counts for every
pair; the exchange of w where i is mesenchymal and its w is not
negative; the bending (``bending_force_fast``, as ``roofline_iwg.py``
counts it) where both are epithelial; on a live cell's diagonal the type
test, and in the mesenchyme where w is not negative the decay of w.
Bytes: the live cells' 15 channels read once (x y z w ctype, the seven
of ``polarity_precompute`` and old_v) and their 12 sums written once
(x y z w theta phi, the friction, the three velocity sums, the two
counts).
"""
from __future__ import annotations

from perfbench import roofline
from perfbench.reference.pairs import cell_pairs
from perfbench.roofline_iwg import OPS_BEND

# f32 operations per ordered pair in reach: the distance (9), the type
# tests (2), the band (7), its weight (1), the force (3), its sums (3),
# the friction and the velocity sums (8), the counts (2)
OPS_PAIR = 35
# where i is mesenchymal with w >= 0: w taken from j (the test, the
# difference, its weight, the sum)
OPS_MES = 4
# a live cell's diagonal: the type test, and in the mesenchyme with
# w >= 0 the decay of w (the test, the product, the sum)
OPS_SELF = 1
OPS_SELF_MES = 3
# f32 channels of a live cell read, sums of a live cell written
IN_CHANS = 15
OUT_CHANS = 12
MESENCHYME, EPITHELIUM = 0.0, 1.0


def pass_work(x, y, z, w, ctype, n, r_max=1.0):
    """(bytes, operations, ordered pairs in reach) of one pair pass on
    the first ``n`` cells of a state of positions ``x``, ``y``, ``z``,
    field ``w`` and types ``ctype``."""
    i, j, _ = cell_pairs(x, y, z, n, r_max)
    takes = (ctype[:n] == MESENCHYME) & (w[:n] >= 0)
    mes_i = int(takes[i].sum())
    both = int(((ctype[i] == EPITHELIUM) & (ctype[j] == EPITHELIUM)).sum())
    n_ops = (i.numel() * OPS_PAIR + mes_i * OPS_MES + both * OPS_BEND
             + n * OPS_SELF + int(takes.sum()) * OPS_SELF_MES)
    return n * (IN_CHANS + OUT_CHANS) * 4, float(n_ops), i.numel()


def window_bound(ctx):
    """Least seconds of the traced window's pair passes (the loop's
    ``mfsa_states``: ``((x, y, z, w, ctype), n, passes)``), kept on
    ``ctx``; None where the loop keeps no such states."""
    states = getattr(ctx.loop, "mfsa_states", None)
    if states is None:
        return None
    if "mfsa_bound" not in ctx.__dict__:
        ctx.mfsa_bound = sum(
            passes * roofline.bound(*pass_work(*chans, n)[:2])[0]
            for chans, n, passes in states())
    return ctx.mfsa_bound
