"""Roofline arithmetic of the port's kernels: the least time one H100
could take for a pass, from the work the pass's inputs need.

The least time is the larger of the bytes the pass must move over the
card's memory rate and the operations it must do over its f32 rate
outside the tensor cores; :func:`bound` says which binds.  Bytes count
each input byte read once and each output byte written once, whatever
the kernel reads again; operations count what these inputs need (pairs
tested, pairs in reach), not the most the kernel could do.  The counts
per pair are those of the port's functors (``csrc/forces.cuh``), and the
work is computed here from positions with plain PyTorch, the same
whatever kernel implements the pass.

K1 is the lattice pair pass, K2 the pour of a lattice build.  A further
kernel brings its work in a file of its own beside this one.
"""
from __future__ import annotations

import torch

from perfbench.reference.pairs import cell_pairs, cube_coords

# H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per evaluated pair, counted from the functors: the
# distance (3 differences, 3 products, 2 sums and the square root) plus
# the functor's pair term with its friction
OPS_DIST = 9
OPS_PER_PAIR = {"branching": OPS_DIST + 100}
# the branching functor's lattice channels read per live cell (its 8
# fields, old_v and the stable id) and sums written per slot and extra
# (F's 8 fields, the friction sum, 3 velocity sums, the epithelial count)
K1_IN_CHANS = {"branching": 12}
K1_OUT_CHANS = {"branching": 13}


def bound(n_bytes, n_ops):
    """(seconds, "bytes" or "operations"): the larger of ``n_bytes`` over
    the memory rate and ``n_ops`` over the f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_dims(grid_size):
    if isinstance(grid_size, (list, tuple)):
        return tuple(int(g) for g in grid_size)
    return (int(grid_size),) * 3


def cube_counts(x, y, z, n, cube_size, grid_size):
    """Live cells per cube of the grid, ``[gz, gy, gx]`` float64: each
    cell binned at ``floor(p / cube_size) + g // 2``, clipped into the
    grid."""
    gx, gy, gz = grid_dims(grid_size)
    cx, cy, cz = (cube_coords(a[:n], cube_size, g)
                  for a, g in ((x, gx), (y, gy), (z, gz)))
    cid = cx + (cy + cz * gy) * gx
    return torch.bincount(cid, minlength=gx * gy * gz).reshape(
        gz, gy, gx).to(torch.float64)


def stencil_candidates(counts):
    """Sum over the cells of the live cells in the 27 cubes around each
    cell's (itself included): the candidates a lattice pass must test."""
    gz, gy, gx = counts.shape
    pad = torch.nn.functional.pad(counts, (1, 1, 1, 1, 1, 1))
    near = sum(pad[dz:dz + gz, dy:dy + gy, dx:dx + gx]
               for dz in range(3) for dy in range(3) for dx in range(3))
    return float((counts * near).sum())


def k1_work(x, y, z, n, cube_size, grid_size, capacity, extras_cap,
            functor="branching"):
    """(bytes, operations) of one lattice pair pass on the first ``n``
    cells: the live cells' channels and the occupancy read, the sums of
    every slot and extra written; every live cell of the 27 cubes tested
    for reach, the force on every ordered pair in reach."""
    gx, gy, gz = grid_dims(grid_size)
    n_slots = gx * gy * gz * capacity
    counts = cube_counts(x, y, z, n, cube_size, grid_size)
    i, _, _ = cell_pairs(x, y, z, n, cube_size)
    n_bytes = (n * K1_IN_CHANS[functor] * 4 + n_slots
               + (n_slots + extras_cap) * K1_OUT_CHANS[functor] * 4)
    n_ops = (stencil_candidates(counts) * OPS_DIST
             + i.numel() * OPS_PER_PAIR[functor])
    return n_bytes, n_ops


def k2_work(n_pad, n_fields, grid_size, capacity):
    """(bytes, 0) of one pour: the sorted entries read (each cell's
    fields, old_v, stable id and target slot), every slot's channels and
    live flag written."""
    gx, gy, gz = grid_dims(grid_size)
    rows = n_fields + 3 + 2
    return 4 * rows * (n_pad + gx * gy * gz * capacity), 0


def pass_work(kernel, x, y, z, n, cfg):
    """(bytes, operations) of one pass of ``kernel`` (``lattice_pair`` or
    ``pour``) on a state of the configuration."""
    e, cube = cfg["engine"], float(cfg["cube_size"])
    if kernel == "lattice_pair":
        return k1_work(x, y, z, n, cube, e["grid_size"], e["capacity"],
                       e["extras_cap"])
    if kernel == "pour":
        return k2_work(x.shape[0], int(cfg["fields"]), e["grid_size"],
                       e["capacity"])
    raise ValueError(f"no work counted for kernel {kernel!r}")


def window_bound(ctx, kernel):
    """Least seconds of ``kernel``'s passes over the traced window's
    states (each state with the passes it stands for), kept on ``ctx``
    for the other readers."""
    memo = ctx.__dict__.setdefault("bounds", {})
    if kernel not in memo:
        memo[kernel] = sum(
            passes * bound(*pass_work(kernel, *xyz, n, ctx.cfg))[0]
            for xyz, n, passes in ctx.loop.pass_states())
    return memo[kernel]


def roofline_pct(ctx, kernel, names):
    """The kernel's share of its roofline in the traced window, in %:
    its least time over the device time of the operations ``names``;
    None where the window ran none of them."""
    if ctx.trace is None or kernel not in ctx.cfg["kernels"]:
        return None
    device_s = ctx.op_seconds(names)
    if not device_s > 0:
        return None
    return 100.0 * window_bound(ctx, kernel) / device_s
