"""Dense cube-lattice engine, per-pass rebuild branch.

Counterpart of ``yalla_tpu/ops/lattice_xla.py``.  The population lives in
a dense fixed-capacity cell list

    T[field][n_slots],   slot = cube_id * C + rank,

cube ids x-minor (ref solvers.cuh:349-365), empty slots masked by ``pid``.
Cells past a cube's capacity C spill into a small cube-sorted side list
(the overflow extras), which the pair pass handles exactly.

Ported: ``lattice_build`` (sort + pour + extras divert), ``slot_to_stable``,
``lattice_unbuild``, the plain stencil pass ``lattice_pairwise_resident``
and ``lattice_heun_steps`` at the
reference-exact cadence (a fresh binning before every pairwise pass).
The resident cadence, slot-space rebinning, thin x-cubes and mover
routing are not ported; ``lattice_heun_steps`` refuses them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dtypes import Float3
from .common import (ERR_PREFIX, apply_derived_aux, apply_post_pair,
                     cube_ids, evaluate_pairs, grid_dims, mask_tree,
                     out_of_grid_mask)

__all__ = ["LatticeLayout", "CubeSort", "sort_by_cube", "lattice_build",
           "lattice_unbuild", "slot_to_stable", "stencil_slots",
           "lattice_pairwise_resident", "lattice_heun_steps",
           "lattice_grid_for", "pick_lattice_dims"]


def lattice_grid_for(pos_max, cube_size, capacity=8):
    """Smallest grid covering ``|coord| <= pos_max`` (plus margin) whose
    row width ``gs * capacity`` is a multiple of 128 (the rule the JAX
    package's planner uses, kept so both packages pick the same grid)."""
    g0 = int(128 // np.gcd(capacity, 128))
    need = 2.0 * (pos_max + 0.75) / cube_size
    return int(max(-(-int(np.ceil(need)) // g0) * g0, 16))


def pick_lattice_dims(pos_max, cube_size, max_occ):
    """(grid_size, capacity) minimising ``gs^3 * C * (4C - 1)`` subject to
    ``C >= max_occ + 1`` and the row rule of :func:`lattice_grid_for`."""
    best = None
    for C in range(max(4, max_occ + 1), max(16, max_occ + 1) + 9):
        gs = lattice_grid_for(pos_max, cube_size, C)
        cost = gs ** 3 * C * (4 * C - 1)
        if best is None or cost < best[0]:
            best = (cost, gs, C)
    return best[1], best[2]


class LatticeLayout(NamedTuple):
    T: object              # Pt of f32[n_slots]
    Tov: object            # Float3 of f32[n_slots] (old_v)
    pid: torch.Tensor      # int64[n_slots], stable id; n_pad = empty
    slot_of: torch.Tensor  # int64[n_pad], slot per stable id; n_slots = none
    n_dropped: torch.Tensor  # 0-d int64: cells that fit neither a slot nor
    #                          the extras list
    n_oob: torch.Tensor      # 0-d int64: cells clipped into edge cubes
    # ---- overflow extras (extras_cap > 0 in lattice_build) ----
    E: object = None         # Pt of f32[extras_cap], cube-sorted
    Eov: object = None       # Float3 of f32[extras_cap]
    epid: torch.Tensor | None = None  # int64[extras_cap]; n_pad = empty
    n_extras: torch.Tensor | None = None


class CubeSort(NamedTuple):
    """The cube-id sort of one build: the stack the pour places (``S``:
    the sorted fields, old_v, stable id and target slot), per sorted
    entry its stable id, rank in its cube and whether it is active, and
    the first sorted position of each (z, y) row of cubes."""
    S: torch.Tensor           # f32[K, n_pad]
    order: torch.Tensor       # int64[n_pad]
    rank: torch.Tensor        # int64[n_pad]
    live: torch.Tensor        # bool[n_pad]
    slot_sorted: torch.Tensor  # int64[n_pad]; n_slots = not placed
    row_starts: torch.Tensor  # int32[gy * gz + 1]; last: the active count


def sort_by_cube(X, old_v, n, cube_size, grid_size, capacity):
    """Stable sort by cube id; entry of rank ``< capacity`` in its cube
    targets slot ``cid * C + rank``, the rest ``DST_SENTINEL``.  Row ``r``
    of cubes (ids ``[r * gx, (r + 1) * gx)``) starts at ``row_starts[r]``,
    found by binary search of its first id in the sorted ids."""
    from .lattice_pour import DST_SENTINEL
    dev = X.x.device
    n_pad = X.x.shape[0]
    gx, gy, gz = grid_dims(grid_size)
    C = capacity
    n_cubes = gx * gy * gz
    cid = cube_ids(X, n, cube_size, grid_size)
    iota = torch.arange(n_pad, device=dev)
    sorted_cid, order = torch.sort(cid, stable=True)
    # rank within the cube: distance to the first entry of its run, found
    # by binary search in the sorted ids (a cummax scan over segment
    # starts took 1.4 ms of each 500k-cell build on an H100 at 700 W)
    rank = iota - torch.searchsorted(sorted_cid, sorted_cid)
    live = sorted_cid < n_cubes
    ok = (rank < C) & live
    slot_sorted = torch.where(ok, sorted_cid * C + rank, n_cubes * C)
    dst = torch.where(ok, slot_sorted.to(torch.float32), DST_SENTINEL)
    S = torch.stack([a[order] for a in list(X) + list(old_v)]
                    + [order.to(torch.float32), dst])
    row_starts = torch.searchsorted(
        sorted_cid, torch.arange(gy * gz + 1, device=dev) * gx,
        out_int32=True)
    return CubeSort(S, order, rank, live, slot_sorted, row_starts)


def lattice_build(X, old_v, n, cube_size, grid_size, capacity,
                  extras_cap=0):
    """Sort by cube id and pour points into the dense lattice.

    Every field rides the stable cube-id sort; the sorted entries are
    placed at ``cid * C + rank`` by the pour (``ops/lattice_pour.py``:
    the CUDA kernel for GPU tensors).  With ``extras_cap > 0`` cells past
    a cube's capacity go to the ``E``/``Eov``/``epid`` side list in sorted
    order; only cells overflowing the side list too count as
    ``n_dropped``."""
    from .lattice_pour import pour_pallas
    dev = X.x.device
    n_pad = X.x.shape[0]
    C = capacity
    nx = len(X)
    n_oob = out_of_grid_mask(X, n, cube_size, grid_size).sum()
    S, order, rank, live, slot_sorted, row_starts = sort_by_cube(
        X, old_v, n, cube_size, grid_size, capacity)
    outp, occ, n_unrouted = pour_pallas(S, row_starts, grid_size, C)
    T = type(X)(*outp[:nx])
    Tov = Float3(*outp[nx:nx + 3])
    pid = torch.where(occ > 0.5, outp[nx + 3].to(torch.int64), n_pad)
    slot_of = torch.empty(n_pad, dtype=torch.int64, device=dev)
    slot_of[order] = slot_sorted

    over = (rank >= C) & live
    if not extras_cap:
        return LatticeLayout(T=T, Tov=Tov, pid=pid, slot_of=slot_of,
                             n_dropped=over.sum() + n_unrouted, n_oob=n_oob)

    # compact the overflow entries (in sorted order) into the side list
    e_idx = torch.cumsum(over, 0) - 1
    e_ok = over & (e_idx < extras_cap)
    # entries that do not fit land in a dump slot past the end
    e_src = torch.full((extras_cap + 1,), n_pad, dtype=torch.int64,
                       device=dev).scatter_(
        0, torch.where(e_ok, e_idx, extras_cap),
        torch.arange(n_pad, device=dev))[:extras_cap]
    e_live = e_src < n_pad
    pick = torch.clamp(e_src, max=n_pad - 1)
    sorted_leaves = S[:nx + 3]
    vals = torch.where(e_live, sorted_leaves[:, pick], 0.0)
    E = type(X)(*vals[:nx])
    Eov = Float3(*vals[nx:])
    epid = torch.where(e_live, order[pick], n_pad)
    return LatticeLayout(T=T, Tov=Tov, pid=pid, slot_of=slot_of,
                         n_dropped=(over & ~e_ok).sum() + n_unrouted,
                         n_oob=n_oob, E=E, Eov=Eov, epid=epid,
                         n_extras=e_ok.sum())


def slot_to_stable(layout, values, fill=0.0):
    """Gather slot-space tensors (a Pt, a dict or a single tensor) back to
    stable-id order; ``fill`` for ids with no slot (inactive, in extras or
    dropped)."""
    n_slots = layout.pid.shape[0]
    ok = layout.slot_of < n_slots
    pick = torch.where(ok, layout.slot_of, 0)

    def one(a):
        return torch.where(ok, a[pick], fill)
    if isinstance(values, dict):
        return {k: one(v) for k, v in values.items()}
    if isinstance(values, tuple):
        return type(values)(*(one(a) for a in values))
    return one(values)


def _merge_extras(layout, stable, extra_vals):
    """Write the extras' rows into a stable-order tensor at their ids."""
    n_pad = layout.slot_of.shape[0]
    idx = torch.where(layout.epid < n_pad, layout.epid, n_pad)
    # empty extras entries land in a dump row past the end
    return torch.cat([stable, stable.new_zeros(1)]).scatter_(
        0, idx, extra_vals)[:n_pad]


def lattice_unbuild(layout: LatticeLayout, X, old_v):
    """Back to stable-id arrays; ids with no slot and no extras entry
    (inactive or dropped) keep their previous values."""
    n_slots = layout.pid.shape[0]
    ok = layout.slot_of < n_slots
    pick = torch.where(ok, layout.slot_of, 0)
    outs = [torch.where(ok, t[pick], old)
            for t, old in zip(list(layout.T) + list(layout.Tov),
                              list(X) + list(old_v))]
    if layout.epid is not None:
        evals = list(layout.E) + list(layout.Eov)
        outs = [_merge_extras(layout, a, e) for a, e in zip(outs, evals)]
    nx = len(X)
    return type(X)(*outs[:nx]), Float3(*outs[nx:])


# pairs per block of the plain lattice pass (bounds its memory)
PAIR_BLOCK = 1 << 22


def stencil_slots(cx, cy, cz, grid_size, capacity):
    """The lattice slots of the 27-cube stencil around cubes (cx, cy, cz):
    ``[B, 27 * C]`` slot ids (0 where off-grid) and an in-grid mask."""
    gx, gy, gz = grid_dims(grid_size)
    C = capacity
    d = torch.arange(-1, 2, device=cx.device)
    dz, dy, dx = (a.reshape(1, -1) for a in
                  torch.meshgrid(d, d, d, indexing="ij"))
    x, y, z = cx[:, None] + dx, cy[:, None] + dy, cz[:, None] + dz
    ok = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    cube = torch.where(ok, (z * gy + y) * gx + x, 0)
    lanes = torch.arange(C, device=cx.device)
    slots = (cube[:, :, None] * C + lanes).reshape(cx.shape[0], 27 * C)
    return slots, ok.repeat_interleave(C, dim=1)


def lattice_pairwise_resident(pw_int, pw_friction, layout, n, cube_size, *,
                              grid_size, capacity):
    """Plain pairwise sums in lattice layout (no overflow extras).

    Each occupied slot's candidates are the C slots of the 27 cubes around
    its own (self included: the diagonal gets the full force), evaluated
    as ``[B, 27 C]`` pair blocks over blocks of B occupied slots with
    ``evaluate_pairs`` and the ``cube_size`` cutoff.  The ids passed to the
    force are stable ids.  (The JAX function sweeps the same stencil as
    shifted slices of the whole grid, which avoids gathers on the TPU.)
    Returns (F, sum_friction, sum_v 3-tuple, aux dict), all ``[n_slots]``,
    zero at empty slots."""
    del n
    gx, gy, _ = grid_dims(grid_size)
    C = capacity
    T, pid = layout.T, layout.pid
    n_slots, n_pad = pid.shape[0], layout.slot_of.shape[0]
    occ = pid < n_pad
    i_all = torch.nonzero(occ).squeeze(1)
    sums = []
    for i in i_all.split(max(1, PAIR_BLOCK // (27 * C))) or (i_all,):
        cube = torch.div(i, C, rounding_mode="floor")
        j, ok = stencil_slots(cube % gx, (cube // gx) % gy, cube // (gx * gy),
                              grid_size, C)
        sums.append(evaluate_pairs(
            pw_int, pw_friction, type(T)(*(a[i, None] for a in T)),
            type(T)(*(a[j] for a in T)), [a[j] for a in layout.Tov],
            pid[i, None], pid[j], ok & occ[j], sum_axes=(1,),
            cutoff=cube_size))

    def place(parts):
        out = torch.zeros(n_slots, dtype=torch.float32, device=pid.device)
        out[i_all] = torch.cat(parts)
        return out
    F = type(sums[0][0])(*(place([s[0][k] for s in sums])
                          for k in range(len(sums[0][0]))))
    sum_f = place([s[1] for s in sums])
    sum_v = tuple(place([s[2][c] for s in sums]) for c in range(3))
    aux = {k: place([s[3][k] for s in sums]) for k in sums[0][3]}
    return F, sum_f, sum_v, aux


def lattice_heun_steps(n_steps, rebuild_every, pw_int, pw_friction, fix_mode,
                       grid_size, capacity, z_block,
                       X, old_v, n, dt, cube_size, fix_point,
                       precompute=None, pallas=True, gen=None,
                       gen_args=None, force_r_max=None,
                       extras_cap=0, extras_block_cap=16, rebin_m_cap=0,
                       rebin_per_pass=False, route_movers=0.0, x_split=1):
    """``n_steps`` Heun steps on the dense lattice, rebuilding the binning
    before every pairwise pass (bit-matching the reference's per-pass
    ``grid.build``, solvers.cuh:494).

    Same integration semantics as ``solvers.heun_step`` (COM/point fixes,
    friction-weighted velocity mixing).  Same signature as the JAX
    integrator; the options this port does not implement are refused.
    The pair pass always runs through its kernel wrapper (``pallas`` must
    be True).  ``force_r_max`` only matters to the resident cadence and
    is ignored here."""
    from ..solvers import add_rhs, augment, nonfinite, truncate_aug
    del gen_args, force_r_max
    refused = {
        "rebuild_every": (rebuild_every != 1,
                          "only the per-pass rebuild cadence is ported"),
        "rebin_m_cap": (rebin_m_cap != 0, "rebin is not ported"),
        "rebin_per_pass": (bool(rebin_per_pass), "rebin is not ported"),
        "x_split": (x_split != 1, "thin x-cubes are not ported"),
        "route_movers": (route_movers != 0.0, "mover routing is not ported"),
        "gen": (gen is not None, "generic forces are not ported"),
        "pallas": (not pallas,
                   "the pair pass runs through its kernel wrapper"),
    }
    for option, (asked, why) in refused.items():
        if asked:
            raise NotImplementedError(f"lattice_heun_steps({option}=...): "
                                      f"{why}")
    from .lattice_pallas import lattice_pairwise_pallas
    gs, C = grid_size, capacity

    def deriv(lay, T, E=None):
        """Derivative in slot space (and in extras order for the extras)."""
        orig_type = type(T)
        lay = lay._replace(T=augment(T, n, precompute))
        if E is not None:
            lay = lay._replace(E=augment(E, n, precompute))
        outs = lattice_pairwise_pallas(
            pw_int, pw_friction, lay, n, cube_size, grid_size=gs,
            capacity=C, z_block=z_block, extras_block_cap=extras_block_cap)

        def finish(F, sum_f, sum_v, aux, X_aug, live):
            aux = apply_derived_aux(pw_int, aux, sum_f)
            F, aux = apply_post_pair(pw_int, F, aux, X_aug)
            dX = add_rhs(truncate_aug(F, orig_type), sum_f, sum_v)
            return mask_tree(dX, live), aux

        occ = lay.pid < lay.slot_of.shape[0]
        dX, aux = finish(*outs[:4], lay.T, occ)
        parts = [(dX, occ, lay.pid)]
        aux_e = None
        if E is not None:
            elive = lay.epid < lay.slot_of.shape[0]
            dXe, aux_e = finish(*outs[4], lay.E, elive)
            parts.append((dXe, elive, lay.epid))
        n_occ = sum(live.sum() for _, live, _ in parts)

        def com(f):
            s = sum(torch.where(live, getattr(d, f), 0.0).sum()
                    for d, live, _ in parts)
            return s / torch.clamp(n_occ, min=1)

        def at_point(f):
            # value at the pinned stable id's slot (or extras entry)
            return sum(torch.where(ids == fix_point, getattr(d, f), 0.0).sum()
                       for d, _, ids in parts)

        if fix_mode == "com":
            fix = [com(f) for f in "xyz"]
        elif fix_mode == "point":
            fix = [at_point(f) for f in "xyz"]
        elif fix_mode == "com_z":
            fix = [at_point("x"), at_point("y"), com("z")]
        else:
            raise ValueError(fix_mode)
        fixed = [d.replace(**{f: torch.where(live, getattr(d, f) - v, 0.0)
                              for f, v in zip("xyz", fix)})
                 for d, live, _ in parts]
        return fixed, aux, aux_e

    def dstable(Xc, ovc):
        lay = lattice_build(Xc, ovc, n, cube_size, gs, C, extras_cap)
        dXs, aux_s, aux_e = deriv(lay, lay.T, lay.E if extras_cap else None)
        dX = slot_to_stable(lay, dXs[0])
        aux = slot_to_stable(lay, aux_s)
        if extras_cap:
            dX = type(dX)(*(_merge_extras(lay, a, e)
                            for a, e in zip(dX, dXs[1])))
            blk = aux_e.pop("__err_extras_block")
            aux = {k: _merge_extras(lay, aux[k], aux_e[k]) for k in aux}
            aux["__err_extras_block"] = blk
        return dX, aux, lay.n_dropped, lay.n_oob

    dev = X.x.device
    dropped = oob = torch.zeros((), dtype=torch.int64, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    errs, aux = {}, {}
    for _ in range(n_steps):
        d1, aux1, dr1, ob1 = dstable(X, old_v)
        X1 = X + d1 * dt
        d2, aux, dr2, ob2 = dstable(X1, old_v)
        for k in aux:
            if k.startswith(ERR_PREFIX):
                aux[k] = torch.maximum(aux[k], aux1[k])
                errs[k] = torch.maximum(errs[k], aux[k]) if k in errs \
                    else aux[k]
        X = X + (d1 + d2) * (0.5 * dt)
        old_v = Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                       z=(d1.z + d2.z) * 0.5)
        dropped = torch.maximum(dropped, torch.maximum(dr1, dr2))
        oob = torch.maximum(oob, torch.maximum(ob1, ob2))
        bad = bad | nonfinite(X)
    aux = {**aux, **errs}
    aux["__err_lattice_dropped"] = dropped
    aux["__err_out_of_grid"] = oob
    aux["__err_non_finite"] = bad
    return X, old_v, aux
