"""Roofline arithmetic of the Gabriel lattice pass (K5), beside
``roofline.py``'s K1 and K2, by its rules: the least time one H100 could
take for a pass is the larger of the bytes it must move over the memory
rate and the operations it must do over the f32 rate, the work computed
from positions with plain PyTorch, whatever kernel implements the pass.

Operations: every live cell of the 27 cubes around a cell tested for
reach (the distance), every candidate in reach tested against every
other (the midpoint test), the force and friction on every kept pair of
cells.  Bytes: the occupancy as the lattice holds it (each cube's live
stable ids and the empty slot that ends them, 8 bytes each; a full cube
has none), the live cells' positions and old_v read once, and the pass's
rows of sums written (the force, the friction sum, the velocity sums and
the candidate flag).
"""
from __future__ import annotations

import torch

from perfbench import roofline
from perfbench.reference import growth_w_wall as ref

# f32 operations of K5's midpoint test of one candidate against another
# (the midpoint, three differences, products and sums, the compare), and
# per kept pair: the distance and the growth_w_wall_relu functor with its
# friction (csrc/forces.cuh)
OPS_MIDPOINT = 14
OPS_PAIR = roofline.OPS_DIST + 16
# rows of n_pad sums the pass writes: F x y z, sum_f, sum_v x y z, flag
OUT_ROWS = 8
# f32 channels of a live cell read: x y z and old_v
IN_CHANS = 6


def k5_work(x, y, z, n, cube_size, grid_size, capacity):
    """(bytes, operations) of one Gabriel lattice pass on the first ``n``
    cells of a state of ``x.shape[0]`` rows."""
    n_pad = x.shape[0]
    counts = roofline.cube_counts(x, y, z, n, cube_size, grid_size)
    p = ref.Params()
    X = {"x": x, "y": y, "z": z}
    i, _, _ = ref.near_pairs(X, n, cube_size)
    cand = torch.bincount(i, minlength=n).to(torch.float64)
    gi, gj, gd2 = ref.gabriel_pairs(X, n, p)
    kept = int(((gi != ref.WALL) & (gj != ref.WALL)
                & (torch.sqrt(gd2) < p.r_max)).sum())
    n_ops = (roofline.stencil_candidates(counts) * roofline.OPS_DIST
             + float((cand * cand).sum()) * OPS_MIDPOINT + kept * OPS_PAIR)
    id_bytes = 8 * float(torch.clamp(counts + 1, max=capacity).sum())
    n_bytes = id_bytes + 4 * IN_CHANS * n + 4 * OUT_ROWS * n_pad
    return n_bytes, n_ops


def pass_work(kernel, x, y, z, n, cfg):
    """(bytes, operations) of one pass of ``kernel`` (``gabriel_pair`` or
    ``pour``) on a state of the configuration."""
    e, cube = cfg["engine"], float(cfg["cube_size"])
    if kernel == "gabriel_pair":
        return k5_work(x, y, z, n, cube, e["grid_size"], e["capacity"])
    if kernel == "pour":
        return roofline.k2_work(x.shape[0], int(cfg["fields"]),
                                e["grid_size"], e["capacity"])
    raise ValueError(f"no work counted for kernel {kernel!r}")


def window_bound(ctx, kernel):
    """Least seconds of ``kernel``'s passes over the traced window's
    states (each state with the passes it stands for), kept on ``ctx``
    for the other readers."""
    memo = ctx.__dict__.setdefault("bounds", {})
    if kernel not in memo:
        memo[kernel] = sum(
            passes * roofline.bound(*pass_work(kernel, *xyz, n, ctx.cfg))[0]
            for xyz, n, passes in ctx.loop.pass_states())
    return memo[kernel]
