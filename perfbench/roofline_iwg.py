"""Roofline arithmetic of the lattice pair pass (K1) with the
intercalation_w_gradient functor, beside ``roofline.py``'s branching K1
and K2, by its rules: the least time one H100 could take for a pass is
the larger of the bytes it must move over the memory rate and the
operations it must do over the f32 rate, the work computed from the
states with plain PyTorch, whatever kernel implements the pass.

Operations, counted from ``IntercalationWGradient`` in
``csrc/forces.cuh``: every live cell of the 27 cubes around a cell tested
for reach (the distance), and on every ordered pair in reach the friction
and the pair term, whose cost depends on the types: the band, the counts
and the sums for every pair, the morphogens' exchange where i is
mesenchymal, the bending where both are epithelial; on the diagonal the
type test, and the decay of w and f in the mesenchyme.  Bytes: the live
cells' 16 channels read once (the 13 of the functor's cell: x y z w f
ctype and the seven of ``polarity_precompute``, and old_v), the
occupancy, and the 13 sums of every slot written.
"""
from __future__ import annotations

from perfbench import roofline
from perfbench.reference.pairs import cell_pairs

# f32 operations per ordered pair in reach: the friction (8), the reach
# and type tests (2), the differences and j's type (5), the band (8), its
# weight (2), the force (3), the bending gate (2), the sums and counts (7)
OPS_PAIR = 37
# where i is mesenchymal: w and f taken from j (3 each)
OPS_MES = 6
# where both are epithelial: bending_force_fast and its angular terms
OPS_BEND = 62
# a live cell's diagonal: the type test, and in the mesenchyme the decay
# of w and f
OPS_SELF = 1
OPS_SELF_MES = 4
# f32 channels of a live cell read, sums of a slot written
IN_CHANS = 16
OUT_CHANS = 13


def k1_work(x, y, z, ctype, n, cube_size, grid_size, capacity):
    """(bytes, operations) of one lattice pair pass on the first ``n``
    cells of a state of positions ``x``, ``y``, ``z`` and types
    ``ctype``."""
    gx, gy, gz = roofline.grid_dims(grid_size)
    n_slots = gx * gy * gz * capacity
    counts = roofline.cube_counts(x, y, z, n, cube_size, grid_size)
    i, j, _ = cell_pairs(x, y, z, n, cube_size)
    mes_i = int((ctype[i] == 0.0).sum())
    both = int(((ctype[i] == 1.0) & (ctype[j] == 1.0)).sum())
    n_mes = int((ctype[:n] == 0.0).sum())
    n_ops = (roofline.stencil_candidates(counts) * roofline.OPS_DIST
             + i.numel() * OPS_PAIR + mes_i * OPS_MES + both * OPS_BEND
             + n * OPS_SELF + n_mes * OPS_SELF_MES)
    n_bytes = n * IN_CHANS * 4 + n_slots + n_slots * OUT_CHANS * 4
    return n_bytes, float(n_ops)


def pass_work(kernel, chans, n, cfg):
    """(bytes, operations) of one pass of ``kernel`` (``lattice_pair`` or
    ``pour``) on a state ``chans = (x, y, z, ctype)`` of the
    configuration."""
    e, cube = cfg["engine"], float(cfg["cube_size"])
    if kernel == "lattice_pair":
        return k1_work(*chans, n, cube, e["grid_size"], e["capacity"])
    if kernel == "pour":
        return roofline.k2_work(chans[0].shape[0], int(cfg["fields"]),
                                e["grid_size"], e["capacity"])
    raise ValueError(f"no work counted for kernel {kernel!r}")


def window_bound(ctx, kernel):
    """Least seconds of ``kernel``'s passes over the traced window's
    states (the loop's ``iwg_states``: ``((x, y, z, ctype), n, passes)``),
    kept on ``ctx`` for the other readers; None where the loop keeps no
    such states."""
    states = getattr(ctx.loop, "iwg_states", None)
    if states is None:
        return None
    memo = ctx.__dict__.setdefault("iwg_bounds", {})
    if kernel not in memo:
        memo[kernel] = sum(
            passes * roofline.bound(*pass_work(kernel, chans, n,
                                               ctx.cfg))[0]
            for chans, n, passes in states())
    return memo[kernel]
