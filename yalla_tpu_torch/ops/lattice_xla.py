"""Dense cube-lattice engine and its integrator.

Counterpart of ``yalla_tpu/ops/lattice_xla.py``.  The population lives in
a dense fixed-capacity cell list

    T[field][n_slots],   slot = cube_id * C + rank,

cube ids x-minor (ref solvers.cuh:349-365), empty slots masked by ``pid``.
Cells past a cube's capacity C spill into a small cube-sorted side list
(the overflow extras), which the pair pass handles exactly.

Ported: ``lattice_build`` (sort + pour + extras divert, mover routing,
thin x-cubes), ``lattice_rebin`` (slot-space rebinning), ``slot_to_stable``,
``lattice_unbuild``, the plain stencil pass ``lattice_pairwise_resident``
and its core ``pairwise_on_padded`` (channels with one halo plane at each
z and y edge: a z-slab's exchanged planes in ``parallel/lattice_spmd.py``),
the resident cadence's staleness certificate (``_gap_deficit`` and
``state_deficit``) and every cadence of ``lattice_heun_steps``: a fresh
binning before every pass, the resident cadence (``rebuild_every > 1``),
rebinning per chunk, per step or per pass, mover routing and generic forces
in the slot loop.  ``pallas`` keeps the JAX integrator's name: either
way the pour and the pair pass run through their kernel wrappers, and
``pallas=False`` (JAX's XLA route) means only that there are no overflow
extras.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import step_graph
from ..dtypes import Float3
from ..utils.profiling import span
from .common import (ERR_PREFIX, augment, cube_coord, cube_ids, derivative,
                     evaluate_pairs, fold_pair, fold_steps, grid_dims,
                     mean_v, momentum_fix, nonfinite, out_of_grid_mask)

__all__ = ["LatticeLayout", "CubeSort", "sort_by_cube", "lattice_build",
           "lattice_rebin", "lattice_unbuild", "slot_to_stable",
           "stencil_slots", "lattice_pairwise_resident", "pairwise_on_padded",
           "lattice_heun_steps", "add_at_slots",
           "lattice_overflow_count", "cube_extrema", "state_deficit",
           "lattice_grid_for", "pick_lattice_dims"]

# the fill of empty cubes' position extrema in the staleness certificate
BIG = 3e38


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
    entry its stable id, rank in its cube, whether it is active and
    whether it is bound for the extras list (past its cube's capacity, or
    routed there), and the first sorted position of each (z, y) row of
    cubes."""
    S: torch.Tensor           # f32[K, n_pad]
    order: torch.Tensor       # int64[n_pad]
    rank: torch.Tensor        # int64[n_pad]
    live: torch.Tensor        # bool[n_pad]
    slot_sorted: torch.Tensor  # int64[n_pad]; n_slots = not placed
    row_starts: torch.Tensor  # int32[gy * gz + 1]; last: the active count
    over: torch.Tensor        # bool[n_pad]


def sort_by_cube(X, old_v, n, cube_size, grid_size, capacity,
                 route_mask=None, x_split=1):
    """Stable sort by cube id; entry of rank ``< capacity`` in its cube
    targets slot ``cid * C + rank``, the rest ``DST_SENTINEL``.  Row ``r``
    of cubes (ids ``[r * gx, (r + 1) * gx)``) starts at ``row_starts[r]``,
    found by binary search of its first id in the sorted ids.

    ``route_mask`` (bool[n_pad]) sends cells to the extras list whatever
    their cube holds: they sort to the end of their cube's run (one
    stable sort on ``cid * 2 + routed``, the JAX package's third sort
    key), so unrouted cells keep the low ranks.  ``x_split`` bins x at
    ``cube_size / x_split``."""
    from .lattice_pour import DST_SENTINEL
    dev = X.x.device
    n_pad = X.x.shape[0]
    gx, gy, gz = grid_dims(grid_size)
    C = capacity
    n_cubes = gx * gy * gz
    cid = cube_ids(X, n, cube_size, grid_size, x_split)
    iota = torch.arange(n_pad, device=dev)
    if route_mask is None:
        sorted_cid, order = torch.sort(cid, stable=True)
        routed = None
    else:
        key, order = torch.sort(cid * 2 + route_mask.to(torch.int64),
                                stable=True)
        sorted_cid, routed = key // 2, (key % 2) == 1
    # rank within the cube: distance to the first entry of its run, found
    # by binary search in the sorted ids (a cummax scan over segment
    # starts took 1.4 ms of each 500k-cell build on an H100 at 700 W)
    rank = iota - torch.searchsorted(sorted_cid, sorted_cid)
    live = sorted_cid < n_cubes
    over = (rank >= C) & live
    if routed is not None:
        over = over | (routed & live)
    ok = live & ~over
    slot_sorted = torch.where(ok, sorted_cid * C + rank, n_cubes * C)
    dst = torch.where(ok, slot_sorted.to(torch.float32), DST_SENTINEL)
    S = torch.stack([a[order] for a in list(X) + list(old_v)]
                    + [order.to(torch.float32), dst])
    row_starts = torch.searchsorted(
        sorted_cid, torch.arange(gy * gz + 1, device=dev) * gx,
        out_int32=True)
    return CubeSort(S, order, rank, live, slot_sorted, row_starts, over)


def lattice_build(X, old_v, n, cube_size, grid_size, capacity,
                  extras_cap=0, route_mask=None, x_split=1):
    """Sort by cube id and pour points into the dense lattice.

    Every field rides the stable cube-id sort; the sorted entries are
    placed at ``cid * C + rank`` by the pour (``ops/lattice_pour.py``:
    the CUDA kernel for GPU tensors).  With ``extras_cap > 0`` cells past
    a cube's capacity go to the ``E``/``Eov``/``epid`` side list in sorted
    order; only cells overflowing the side list too count as
    ``n_dropped``.  ``route_mask`` (requires ``extras_cap > 0``) forces
    cells into the side list whatever their cube's occupancy; ``x_split``
    bins x at ``cube_size / x_split`` (``gx`` counts the thin cubes)."""
    from .lattice_pour import pour_pallas
    if route_mask is not None and not extras_cap:
        raise ValueError("lattice_build: route_mask requires overflow "
                         "extras (extras_cap > 0)")
    dev = X.x.device
    n_pad = X.x.shape[0]
    C = capacity
    nx = len(X)
    n_oob = out_of_grid_mask(X, n, cube_size, grid_size, x_split).sum()
    cs = sort_by_cube(X, old_v, n, cube_size, grid_size, capacity,
                      route_mask, x_split)
    outp, occ, n_unrouted = pour_pallas(cs.S, cs.row_starts, grid_size, C)
    T = type(X)(*outp[:nx])
    Tov = Float3(*outp[nx:nx + 3])
    pid = torch.where(occ > 0.5, outp[nx + 3].to(torch.int64), n_pad)
    slot_of = torch.empty(n_pad, dtype=torch.int64, device=dev)
    slot_of[cs.order] = cs.slot_sorted

    over = cs.over
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
    vals = torch.where(e_live, cs.S[:nx + 3, pick], 0.0)
    E = type(X)(*vals[:nx])
    Eov = Float3(*vals[nx:])
    epid = torch.where(e_live, cs.order[pick], n_pad)
    return LatticeLayout(T=T, Tov=Tov, pid=pid, slot_of=slot_of,
                         n_dropped=(over & ~e_ok).sum() + n_unrouted,
                         n_oob=n_oob, E=E, Eov=Eov, epid=epid,
                         n_extras=e_ok.sum())


def _set_at(a, idx, v, size):
    """``a`` (``[size]``) with ``v`` written at ``idx``; an index of
    ``size`` lands in a dump row past the end (JAX's ``mode="drop"``)."""
    return torch.cat([a, a.new_zeros(1)]).index_put_((idx,), v)[:size]


def lattice_rebin(layout, cube_size, grid_size, capacity, m_cap,
                  extras_cap=0, carry=None, carry_E=None, x_split=1):
    """Re-derive the binning from the CURRENT slot-space positions: the
    cube membership of ``lattice_unbuild`` then a fresh ``lattice_build``,
    without the global sort or the stable-order round trip.

    Stayers keep their slots; movers (cells whose cube changed) and every
    live overflow extra are compacted into a list of ``m_cap`` movers
    plus the extras, each takes a free lane of its target cube (freed
    lanes reused in lane order); a mover whose cube is full spills to the
    extras list, and past that is dropped -- ``lattice_build``'s capacity
    semantics.  Slot placement within a cube differs from a fresh build.

    Returns ``(layout, n_unrebinned)``: nonzero means the mover list
    overflowed ``m_cap`` and that many cells kept a stale cube.
    ``carry`` (a Pt of ``[n_slots]`` tensors) rides the same slot
    permutation, with ``carry_E`` its ``[extras_cap]`` counterpart when
    the layout has extras: then ``(layout, n_unrebinned, carry2[,
    carry_E2])``.  Values at vacated slots are stale, masked by
    occupancy like the state channels."""
    dev = layout.pid.device
    gx, gy, gz = grid_dims(grid_size)
    C = capacity
    n_cubes = gx * gy * gz
    n_slots = layout.pid.shape[0]
    n_pad = layout.slot_of.shape[0]
    T, Tov = layout.T, layout.Tov
    occ = layout.pid < n_pad
    cube_x = cube_size / x_split

    def cid_of(P, live):
        cid = (cube_coord(P.z, cube_size, gz) * gy
               + cube_coord(P.y, cube_size, gy)) * gx \
            + cube_coord(P.x, cube_x, gx)
        return torch.where(live, cid, n_cubes)

    def oob_of(P, live):
        bad = torch.zeros_like(live)
        for v, g, cs in ((P.x, gx, cube_x), (P.y, gy, cube_size),
                         (P.z, gz, cube_size)):
            c = torch.floor(v / cs).to(torch.int64) + g // 2
            bad = bad | (c < 0) | (c >= g)
        return bad & live

    cid_new = cid_of(T, occ)
    slot_iota = torch.arange(n_slots, device=dev)
    mover = occ & (cid_new != torch.div(slot_iota, C, rounding_mode="floor"))
    stay = occ & ~mover
    moved = torch.cumsum(mover, 0)
    n_unrebinned = torch.clamp(moved[-1] - m_cap, min=0)

    has_e = extras_cap > 0 and layout.epid is not None
    live_e = (layout.epid < n_pad) if has_e else None
    n_oob = oob_of(T, occ).sum()
    if has_e:
        n_oob = n_oob + oob_of(layout.E, live_e).sum()

    # free lanes per cube after removing movers, in lane order
    lane = torch.arange(C, device=dev)[None, :]
    free2 = (~stay).reshape(n_cubes, C)
    free_lane = torch.sort(torch.where(free2, lane, lane + C), dim=1).values
    free_cnt = free2.sum(1)

    # the first m_cap movers in slot order (n_slots past the last): the
    # k-th mover is where the running count first reaches k
    msrc = torch.searchsorted(moved, torch.arange(1, m_cap + 1, device=dev))
    pick = torch.clamp(msrc, max=n_slots - 1)
    lat_live = msrc < n_slots

    leaves_c = list(carry) if carry is not None else []
    lat_chans = list(T) + list(Tov) + leaves_c
    nx = len(T)
    if has_e:
        leaves_cE = list(carry_E) if carry is not None else []
        if len(leaves_cE) != len(leaves_c):
            raise ValueError("lattice_rebin: carry_E must mirror carry when "
                             "extras are enabled")
        e_chans = list(layout.E) + list(layout.Eov) + leaves_cE
        chans = [torch.cat([a[pick], e]) for a, e in zip(lat_chans, e_chans)]
        list_pid = torch.cat([torch.where(lat_live, layout.pid[pick], n_pad),
                              layout.epid])
        tq = torch.cat([torch.where(lat_live, cid_new[pick], n_cubes),
                        cid_of(layout.E, live_e)])
    else:
        chans = [a[pick] for a in lat_chans]
        list_pid = torch.where(lat_live, layout.pid[pick], n_pad)
        tq = torch.where(lat_live, cid_new[pick], n_cubes)

    # rank within target cube -> free lane (or extras spill, or drop)
    s_tq, s_idx = torch.sort(tq, stable=True)
    r = torch.arange(s_tq.shape[0], device=dev) \
        - torch.searchsorted(s_tq, s_tq)
    qc = torch.clamp(s_tq, max=n_cubes - 1)
    fits = (s_tq < n_cubes) & (r < free_cnt[qc])
    dst = torch.where(fits, qc * C + free_lane[qc, torch.clamp(r, max=C - 1)],
                      n_slots)
    over = (s_tq < n_cubes) & ~fits
    e_rank = torch.cumsum(over, 0) - 1
    e_ok = over & (e_rank < extras_cap)
    e_dst = torch.where(e_ok, e_rank, max(extras_cap, 1))
    n_dropped = (over & ~e_ok).sum()

    pid_s = list_pid[s_idx]
    chans_s = [a[s_idx] for a in chans]

    # clear the vacated slots, then scatter the re-homed entries
    pid2 = _set_at(layout.pid, torch.where(lat_live, msrc, n_slots),
                   torch.full_like(msrc, n_pad), n_slots)
    pid2 = _set_at(pid2, dst, pid_s, n_slots)
    outs = [_set_at(a, dst, v, n_slots) for a, v in zip(lat_chans, chans_s)]
    slot_of2 = _set_at(layout.slot_of, torch.where(pid_s < n_pad, pid_s,
                                                   n_pad),
                       torch.where(fits, dst, n_slots), n_pad)
    new = layout._replace(T=type(T)(*outs[:nx]),
                          Tov=Float3(*outs[nx:nx + 3]), pid=pid2,
                          slot_of=slot_of2, n_dropped=n_dropped, n_oob=n_oob)
    carry2 = type(carry)(*outs[nx + 3:]) if carry is not None else None
    if not has_e:
        return (new, n_unrebinned) if carry is None \
            else (new, n_unrebinned, carry2)
    epad = max(extras_cap, 1) + 1

    def pour_e(v, fill):
        buf = torch.full((epad,), fill, dtype=v.dtype, device=dev)
        return buf.index_put_((e_dst,), torch.where(e_ok, v, fill))[
            :extras_cap]
    new = new._replace(
        E=type(T)(*(pour_e(v, 0.0) for v in chans_s[:nx])),
        Eov=Float3(*(pour_e(v, 0.0) for v in chans_s[nx:nx + 3])),
        epid=pour_e(pid_s, n_pad), n_extras=e_ok.sum())
    if carry is None:
        return new, n_unrebinned
    carry_E2 = type(carry_E)(*(pour_e(v, 0.0) for v in chans_s[nx + 3:]))
    return new, n_unrebinned, carry2, carry_E2


def slot_to_stable(layout, values, fill=0.0):
    """Gather slot-space tensors (a Pt, a dict, a tuple or a single tensor)
    back to stable-id order; ``fill`` for ids with no slot (inactive, in
    extras or dropped)."""
    n_slots = layout.pid.shape[0]
    ok = layout.slot_of < n_slots
    pick = torch.where(ok, layout.slot_of, 0)

    def one(a):
        return torch.where(ok, a[pick], fill)
    if isinstance(values, dict):
        return {k: one(v) for k, v in values.items()}
    if hasattr(values, "_fields"):
        return type(values)(*(one(a) for a in values))
    if isinstance(values, tuple):
        return tuple(one(a) for a in values)
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


def lattice_overflow_count(layout):
    return layout.n_dropped


def _pad_axis(A, ax, before, after, fill):
    """``A`` with ``before`` and ``after`` planes of ``fill`` on axis
    ``ax``."""
    parts = []
    for k in (before, after):
        shape = list(A.shape)
        shape[ax] = k
        parts.append(A.new_full(shape, fill))
    return torch.cat([parts[0], A, parts[1]], dim=ax)


def _gap_deficit(P, Q, grid_size):
    """Missed-pair gap deficit of one force-evaluation state for the
    resident cadence, from the per-axis per-cube maxima ``P`` and minima
    ``Q`` (``[3, n_cubes]``, -/+ ``BIG`` where empty) of the cells'
    positions at that state, cube membership frozen at the build.

    A pair is missed only if its cubes are at least 2 apart along some
    axis yet it comes within ``force_r_max``: cells of cube a and b are at
    least ``Q[b] - P[a]`` apart on that axis, so ``-(min over such (a, b)
    of Q[b] - P[a])`` bounds the closure.  Pairs 2 apart along one axis
    (lateral offsets within +-1) take that axis's gap; pairs 2 apart along
    two axes must close both gaps, so they take the smaller deficit (the
    third axis pooled +-2); pairs 3 or more apart are the caller's
    displacement term.  The JAX package's ``_gap_deficit`` line for line:
    only max, min and subtraction, so both give the same bits."""
    gx, gy, gz = grid_dims(grid_size)
    shape3 = (gz, gy, gx)
    big = BIG
    # cube ids are x-minor: array axes are (z, y, x), so data axis u
    # (0 = x, 1 = y, 2 = z) lives on array axis 2 - u
    P3 = [P[u].reshape(shape3) for u in range(3)]
    Q3 = [Q[u].reshape(shape3) for u in range(3)]

    def pool(A, ax, k, keep_max):
        fill = -big if keep_max else big
        Ap = _pad_axis(A, ax, k, k, fill)
        m = None
        for t in range(2 * k + 1):
            s = Ap.narrow(ax, t, shape3[ax])
            m = s if m is None else (torch.maximum(m, s) if keep_max
                                     else torch.minimum(m, s))
        return m

    def shift(A, ax, d, fill):
        # a-centric partner value: out[i] = A[i + d]
        if d >= 0:
            return _pad_axis(A, ax, 0, d, fill).narrow(ax, d, shape3[ax])
        return _pad_axis(A, ax, -d, 0, fill).narrow(ax, 0, shape3[ax])

    deficit = P.new_full((), -big)
    # single-axis escapes: partner +2 along u, lateral pooled +-1
    for u in range(3):
        au = 2 - u
        Qp = Q3[u]
        for lat in range(3):
            if lat != au:
                Qp = pool(Qp, lat, 1, False)
        deficit = torch.maximum(deficit,
                                (P3[u] - shift(Qp, au, 2, big)).max())
    # two-axis (diagonal) escapes: partner (+2 u, +-2 v), third axis
    # pooled +-2; both gaps must close, so the pair deficit is the min
    for u in range(3):
        for v in range(u + 1, 3):
            au, av = 2 - u, 2 - v
            aw = 2 - (3 - u - v)
            for s in (2, -2):
                def bside(A, keep_max):
                    fill = -big if keep_max else big
                    Ap = pool(A, aw, 2, keep_max)
                    return shift(shift(Ap, au, 2, fill), av, s, fill)
                d_u = P3[u] - bside(Q3[u], False)
                if s > 0:
                    d_v = P3[v] - bside(Q3[v], False)
                else:
                    d_v = bside(P3[v], True) - Q3[v]
                deficit = torch.maximum(deficit,
                                        torch.minimum(d_u, d_v).max())
    return deficit


def cube_extrema(layout, T_at, E_at, cube_size, grid_size):
    """``(P, Q)``: per axis and cube the maximum and minimum position of
    the cells of state ``T_at`` (slot order, membership frozen at the
    build; -/+ ``BIG`` where empty), with the overflow extras ``E_at``
    (or None) entered at their current cube: the pair pass re-tables
    extras from their instantaneous positions every pass, so only their
    lattice partners' staleness matters."""
    gx, gy, gz = grid_dims(grid_size)
    n_cubes = gx * gy * gz
    n_pad = layout.slot_of.shape[0]
    occ = layout.pid < n_pad
    C = layout.pid.shape[0] // n_cubes
    if E_at is not None:
        elive = layout.epid < n_pad
        eci = torch.where(elive, cube_ids(E_at, layout.epid.shape[0],
                                          cube_size, grid_size), n_cubes)
    P, Q = [], []
    for f in "xyz":
        v = getattr(T_at, f)
        p = torch.where(occ, v, -BIG).reshape(n_cubes, C).amax(1)
        q = torch.where(occ, v, BIG).reshape(n_cubes, C).amin(1)
        if E_at is not None:
            de = getattr(E_at, f)
            p = torch.cat([p, p.new_zeros(1)]).scatter_reduce(
                0, eci, torch.where(elive, de, -BIG), "amax")[:n_cubes]
            q = torch.cat([q, q.new_zeros(1)]).scatter_reduce(
                0, eci, torch.where(elive, de, BIG), "amin")[:n_cubes]
        P.append(p)
        Q.append(q)
    return torch.stack(P), torch.stack(Q)


def state_deficit(layout, T_at, E_at, cube_size, grid_size):
    """The gap deficit (:func:`_gap_deficit`) of one evaluation state."""
    return _gap_deficit(*cube_extrema(layout, T_at, E_at, cube_size,
                                      grid_size), grid_size)


# pairs per block of the plain lattice pass (bounds its memory)
PAIR_BLOCK = 1 << 22


def stencil_slots(cx, cy, cz, grid_size, capacity, x_split=1):
    """The lattice slots of the stencil around cubes (cx, cy, cz): 3 x 3
    cubes in z and y by ``2 x_split + 1`` in x.  Returns ``[B, 9 (2
    x_split + 1) C]`` slot ids (0 where off-grid) and an in-grid mask."""
    gx, gy, gz = grid_dims(grid_size)
    C = capacity
    d = torch.arange(-1, 2, device=cx.device)
    dxs = torch.arange(-x_split, x_split + 1, device=cx.device)
    dz, dy, dx = (a.reshape(1, -1) for a in
                  torch.meshgrid(d, d, dxs, indexing="ij"))
    x, y, z = cx[:, None] + dx, cy[:, None] + dy, cz[:, None] + dz
    ok = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    cube = torch.where(ok, (z * gy + y) * gx + x, 0)
    lanes = torch.arange(C, device=cx.device)
    slots = (cube[:, :, None] * C + lanes).reshape(cx.shape[0],
                                                   dz.shape[1] * C)
    return slots, ok.repeat_interleave(C, dim=1)


def lattice_pairwise_resident(pw_int, pw_friction, layout, n, cube_size, *,
                              grid_size, capacity, x_split=1):
    """Plain pairwise sums in lattice layout (no overflow extras): the
    lattice's channels with an empty plane at each z and y edge through
    :func:`pairwise_on_padded`.  Returns (F, sum_friction, sum_v 3-tuple,
    aux dict), all ``[n_slots]``, zero at empty slots."""
    del n
    gx, gy, gz = grid_dims(grid_size)
    n_pad = layout.slot_of.shape[0]

    def padded(a, fill):
        a = a.reshape(gz, gy, gx * capacity)
        return _pad_axis(_pad_axis(a, 0, 1, 1, fill), 1, 1, 1, fill)
    P = type(layout.T)(*(padded(a, 0.0) for a in layout.T))
    Pov = Float3(*(padded(a, 0.0) for a in layout.Tov))
    return pairwise_on_padded(
        pw_int, pw_friction, P, Pov, padded(layout.pid < n_pad, False),
        padded(layout.pid, n_pad), cube_size, grid_size=gx,
        capacity=capacity, x_split=x_split)


def pairwise_on_padded(pw_int, pw_friction, P, Pov, Pocc, Ppid, cube_size, *,
                       grid_size, capacity, z_block=None, x_split=1):
    """Plain pass over channels that already carry one halo plane at each
    z and y edge, ``[gz + 2, gy + 2, gx * C]``: a z-slab's planes
    exchanged with its neighbours, or empty ones.  Returns the flat
    ``[gz * gy * gx * C]`` sums of the interior, zero at empty slots.

    Each occupied interior slot's candidates are the C slots of the cubes
    of its stencil (:func:`stencil_slots` in the padded grid: +-1 cube in
    z and y, +-``x_split`` thin cubes in x; self included: the diagonal
    gets the full force), occupied per ``Pocc``, evaluated in pair blocks
    with ``evaluate_pairs`` and the ``cube_size`` cutoff.  The ids passed
    to the force are ``Ppid``'s, unique across the padded grid (stable
    ids inside; ``lattice_pallas.slab_on_padded`` gives the halo planes
    ids past ``n_pad``), so ``i == j`` holds on the diagonal only.  (The JAX
    function sweeps the same stencil as shifted slices of the whole grid,
    which avoids gathers on the TPU; ``z_block`` is its slab height, not
    needed here.)"""
    del z_block
    gx = grid_dims(grid_size)[0]
    C = capacity
    gz, gy = Pocc.shape[0] - 2, Pocc.shape[1] - 2
    W = gx * C
    n_slots = gz * gy * W
    T = type(P)(*(a.reshape(-1) for a in P))
    ov = [a.reshape(-1) for a in Pov]
    occ, pid = Pocc.reshape(-1), Ppid.reshape(-1)
    dev = occ.device
    i_all = torch.nonzero(Pocc[1:-1, 1:-1].reshape(-1)).squeeze(1)
    width = 9 * (2 * x_split + 1) * C
    sums = []
    for i in i_all.split(max(1, PAIR_BLOCK // width)) or (i_all,):
        cube = torch.div(i, C, rounding_mode="floor")
        cx, cy = cube % gx, (cube // gx) % gy
        cz = cube // (gx * gy)
        ip = ((cz + 1) * (gy + 2) + cy + 1) * W + i % W
        j, ok = stencil_slots(cx, cy + 1, cz + 1, (gx, gy + 2, gz + 2), C,
                              x_split)
        sums.append(evaluate_pairs(
            pw_int, pw_friction, type(T)(*(a[ip, None] for a in T)),
            type(T)(*(a[j] for a in T)), [a[j] for a in ov],
            pid[ip, None], pid[j], ok & occ[j], sum_axes=(1,),
            cutoff=cube_size))

    def place(parts):
        out = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        out[i_all] = torch.cat(parts)
        return out
    F = type(sums[0][0])(*(place([s[0][k] for s in sums])
                          for k in range(len(sums[0][0]))))
    sum_f = place([s[1] for s in sums])
    sum_v = tuple(place([s[2][c] for s in sums]) for c in range(3))
    aux = {k: place([s[3][k] for s in sums]) for k in sums[0][3]}
    return F, sum_f, sum_v, aux


def _check_cadence(n_steps, rebuild_every, pallas, gen, extras_cap,
                   rebin_m_cap, rebin_per_pass, x_split):
    """Refuse, with ``ValueError``, exactly the combinations the JAX
    integrator asserts against (so they hold under ``python -O``)."""
    if rebuild_every < 1 or n_steps % rebuild_every:
        raise ValueError(f"lattice_heun_steps: n_steps {n_steps} is not a "
                         f"multiple of rebuild_every {rebuild_every}")
    if x_split != 1 and not (rebuild_every == 1
                             and (rebin_m_cap == 0 or rebin_per_pass)):
        raise ValueError("lattice_heun_steps: x_split > 1 requires "
                         "per-pass-exact binning: rebuild_every == 1 with "
                         "rebin_m_cap == 0 (plain rebuilds) or "
                         "rebin_per_pass")
    if extras_cap and not pallas:
        raise ValueError("lattice_heun_steps: overflow extras require "
                         "pallas=True (JAX's XLA route has none)")
    if extras_cap and gen is not None:
        raise ValueError("lattice_heun_steps: generic forces do not "
                         "compose with overflow extras")
    if rebin_m_cap and rebin_per_pass and rebuild_every != 1:
        raise ValueError("lattice_heun_steps: rebin_per_pass implies "
                         "rebuild_every == 1")


def _max_disp(new, ref, live):
    """The largest per-axis displacement of the live slots."""
    return torch.stack([torch.where(live, torch.abs(
        getattr(new, f) - getattr(ref, f)), 0.0).max() for f in "xyz"]).max()


def add_at_slots(F, dX, slot_of, lo, hi, fields=None):
    """``F``, sums of the slots ``lo`` to ``hi`` in slot order, with a
    generic force's ``dX`` (stable order) added at each cell's slot
    (``slot_of``) in that range; a cell with no slot there adds nothing.
    ``fields`` names the fields ``dX`` writes (None: all of F's)."""
    n_local = hi - lo
    mine = (slot_of >= lo) & (slot_of < hi)
    idx = torch.where(mine, slot_of - lo, n_local)
    upd = {}
    for f in fields if fields is not None else F._fields:
        a = getattr(F, f)
        upd[f] = torch.cat([a, a.new_zeros(1)]).index_add(
            0, idx, torch.where(mine, getattr(dX, f), 0.0))[:n_local]
    return F.replace(**upd)


def _with_flags(aux, dropped, oob, bad, unre=None):
    """``aux`` with the run's build flags (and the rebin overflow)."""
    aux = dict(aux)
    aux["__err_lattice_dropped"] = dropped
    aux["__err_out_of_grid"] = oob
    aux["__err_non_finite"] = bad
    if unre is not None:
        aux["__err_rebin_overflow"] = unre
    return aux


def lattice_heun_steps(n_steps, rebuild_every, pw_int, pw_friction, fix_mode,
                       grid_size, capacity, z_block,
                       X, old_v, n, dt, cube_size, fix_point,
                       precompute=None, pallas=True, gen=None,
                       gen_args=None, force_r_max=None,
                       extras_cap=0, extras_block_cap=16, rebin_m_cap=0,
                       rebin_per_pass=False, route_movers=0.0, x_split=1,
                       segment=step_graph.eager):
    """``n_steps`` Heun steps on the dense lattice, the JAX integrator's
    signature and cadences.  Same integration semantics as
    ``solvers.heun_step`` (COM/point fixes, friction-weighted velocity
    mixing).  The pour and the pair pass run through their kernel
    wrappers (``pour_pallas``, ``lattice_pairwise_pallas``: the CUDA
    kernels on GPU tensors, their plain versions on CPU ones) whatever
    ``pallas`` says.  ``pallas=False``, the JAX default, is JAX's XLA
    route, which has no overflow extras: there ``extras_cap`` raises
    ``ValueError``, where JAX asserts, and the pass computes the same
    function as JAX's plain stencil pass.

    * ``rebuild_every == 1``, ``rebin_m_cap == 0``: a fresh binning before
      every pairwise pass (bit-matching the reference's per-pass
      ``grid.build``, solvers.cuh:494).
    * ``rebuild_every > 1``: the state stays in slot order for
      ``rebuild_every`` steps between builds.  With ``force_r_max`` the
      run certifies itself: ``__err_stale`` is raised where the per-state
      gap deficit (``state_deficit``) closes past the binning margin
      ``cube_size - force_r_max``, or twice the largest displacement past
      ``2 cube_size - force_r_max``; ``stale_max_disp`` and
      ``stale_shear_closure`` publish the two measures.  ``route_movers``
      (> 0, with extras) sends cells whose old_v-extrapolated chunk
      displacement could eat half the margin into the extras list.
    * ``rebin_m_cap > 0``: the state stays in slot order across chunks
      (``lattice_rebin`` with a mover list of ``rebin_m_cap``), per chunk
      or, at ``rebuild_every == 1``, per step; with ``rebin_per_pass``
      before every pass, the predictor derivative riding the rebin.  A
      mover-list overflow raises ``__err_rebin_overflow``.
    * ``gen`` (a ``GenericForce``, called with ``gen_args``) runs inside
      the slot loop: the state gathered to stable order for it, its dX
      added at ``slot_of`` (only ``gen.fields`` when given).

    The loop is Python over fixed shapes: no value is read back to the
    host inside it.  At a fresh binning before every pass the builds are
    eager calls of ``lattice_build`` (each the span ``lattice.build``,
    traced) and the glue after each is
    ``segment(tag, body, inputs, copy) -> body(inputs)`` (tags ``first``
    and ``second``; ``copy``: its outputs leave the step), which
    ``step_graph.segment`` replays as a CUDA graph
    (``solvers.lattice_segment_key``)."""
    _check_cadence(n_steps, rebuild_every, pallas, gen, extras_cap,
                   rebin_m_cap, rebin_per_pass, x_split)
    from .lattice_pallas import lattice_pairwise_pallas
    gs, C = grid_size, capacity
    dev = X.x.device
    has_e = bool(extras_cap)

    def scalar(v):
        # an f32 device scalar without a host-to-device copy
        return torch.full((), v, dtype=torch.float32, device=dev)

    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    track = force_r_max is not None
    if track:
        cube_t, r_max_t = scalar(cube_size), scalar(force_r_max)
        margin = cube_t - r_max_t
    route_on = (route_movers > 0 and has_e and rebin_m_cap == 0
                and rebuild_every > 1 and track)

    def build_lay(Xc, ovc):
        rmask = None
        if route_on:
            vmax = torch.maximum(torch.abs(ovc.x), torch.maximum(
                torch.abs(ovc.y), torch.abs(ovc.z)))
            reach = scalar(dt) * float(rebuild_every * route_movers)
            rmask = vmax * reach > 0.5 * margin
        return lattice_build(Xc, ovc, n, cube_size, gs, C, extras_cap,
                             route_mask=rmask, x_split=x_split)

    def rebin(lay, carry=None, carry_E=None):
        return lattice_rebin(lay, cube_size, gs, C, rebin_m_cap, extras_cap,
                             carry, carry_E, x_split=x_split)

    def deriv(lay, T, E=None, nc=n):
        """Derivative in slot space, and in extras order for the extras:
        ``(dX, aux, dXe, aux_e)``, the last two None without extras.
        ``nc``: the count, a 0-d device tensor inside a segment's
        graph."""
        pt = type(T)
        lay = lay._replace(T=augment(T, nc, precompute))
        if E is not None:
            lay = lay._replace(E=augment(E, nc, precompute))
        outs = lattice_pairwise_pallas(
            pw_int, pw_friction, lay, nc, cube_size, grid_size=gs,
            capacity=C, z_block=z_block, extras_block_cap=extras_block_cap,
            x_split=x_split)
        add_gen = None
        if gen is not None:
            def add_gen(F):
                # the force on the state gathered to stable order
                dXg = gen.fn(slot_to_stable(lay, T), nc, gen_args)
                return add_at_slots(F, dXg, lay.slot_of, 0, lay.pid.shape[0],
                                    gen.fields)
        n_pad = lay.slot_of.shape[0]
        occ = lay.pid < n_pad
        dX, aux = derivative(pw_int, outs[:4], lay.T, pt, occ, add_gen)
        parts = [(dX, occ, lay.pid)]
        aux_e = None
        if E is not None:
            elive = lay.epid < n_pad
            dXe, aux_e = derivative(pw_int, outs[4], lay.E, pt, elive)
            parts.append((dXe, elive, lay.epid))
        n_occ = sum(live.sum() for _, live, _ in parts)
        fixed = momentum_fix(parts, n_occ, fix_mode, fix_point)
        return fixed[0], aux, fixed[-1] if E is not None else None, aux_e

    def to_stable_aux(lay, aux, aux_e):
        """Slot-order aux (and extras-order ``aux_e``) in stable order,
        the extras' rows at their ids; ``__err_extras_block`` stays
        scalar."""
        out = slot_to_stable(lay, aux)
        if aux_e is not None:
            aux_e = dict(aux_e)
            blk = aux_e.pop("__err_extras_block")
            out = {k: _merge_extras(lay, v, aux_e[k]) if k in aux_e else v
                   for k, v in out.items()}
            out["__err_extras_block"] = blk
        return out

    def nonfinite_lay(lay):
        return nonfinite(lay.T) | nonfinite(lay.E) if has_e \
            else nonfinite(lay.T)

    def run_chunk(lay):
        """``rebuild_every`` resident steps and the staleness certificate
        on a fresh binning; returns (layout, stable-order aux, non-finite
        flag).  The certificate's extrema are taken at every state a pass
        evaluates (``state_deficit``), and the displacement against the
        chunk's binning positions of the lattice slots (the extras are
        re-tabled from their positions every pass)."""
        occ = lay.pid < lay.slot_of.shape[0]
        E0 = lay.E if has_e else None
        dfc = state_deficit(lay, lay.T, E0, cube_size, gs) if track \
            else None
        T, Tov, E, Eov = lay.T, lay.Tov, E0, lay.Eov
        acc = acc_e = None
        disp = scalar(0.0)
        for _ in range(rebuild_every):
            lay_t = lay._replace(Tov=Tov, Eov=Eov)
            d1, aux1, d1e, aux1e = deriv(lay_t, T, E)
            T1 = T + d1 * dt
            E1 = E + d1e * dt if has_e else None
            d2, aux, d2e, aux_e = deriv(lay_t, T1, E1)
            acc = fold_steps(acc, fold_pair(aux, aux1))
            T_new = T + (d1 + d2) * (0.5 * dt)
            disp = torch.maximum(disp, torch.maximum(
                _max_disp(T_new, lay.T, occ), _max_disp(T1, lay.T, occ)))
            T, Tov = T_new, mean_v(d1, d2)
            if has_e:
                acc_e = fold_steps(acc_e, fold_pair(aux_e, aux1e))
                E, Eov = E + (d1e + d2e) * (0.5 * dt), mean_v(d1e, d2e)
            if track:
                dfc = torch.maximum(dfc, torch.maximum(
                    state_deficit(lay, T1, E1, cube_size, gs),
                    state_deficit(lay, T, E, cube_size, gs)))
        lay = lay._replace(T=T, Tov=Tov, E=E if has_e else lay.E, Eov=Eov)
        aux_last = to_stable_aux(lay, acc, acc_e)
        aux_last["stale_max_disp"] = disp
        if track:
            closure = dfc + cube_t
            flag = (closure > margin) | (2.0 * disp > 2.0 * cube_t - r_max_t)
            aux_last["__err_stale"] = flag.to(torch.float32)
            aux_last["stale_shear_closure"] = closure
        return lay, aux_last, nonfinite_lay(lay)

    def run_rebin_per_pass():
        """The state never leaves slot order: each pass re-derives the
        binning by ``lattice_rebin``, and the corrector runs in the
        predictor state's binning with the predictor derivative carried
        through the rebin (``X_new = X1 + dt/2 (d2 - d1)``).  Aux stays in
        slot order and is gathered to stable ids once at the end; flags
        max over passes (their contract is global-any: slot orders differ
        by the movers)."""
        def fold_aux(acc, aux2, aux1):
            # the corrector's aux; flags max'ed with the accumulated (from
            # zeros) and the predictor's global max
            out = dict(aux2)
            for k in out:
                if k.startswith(ERR_PREFIX):
                    prev = acc[k] if acc is not None \
                        else torch.zeros_like(out[k])
                    out[k] = torch.maximum(torch.maximum(out[k], prev),
                                           aux1[k].max())
            return out

        lay = lattice_build(X, old_v, n, cube_size, gs, C, extras_cap,
                            x_split=x_split)
        dropped, oob, bad, unre = lay.n_dropped, lay.n_oob, false, zero_i

        def note(lay, un):
            nonlocal dropped, oob, unre
            unre = torch.maximum(unre, un)
            dropped = torch.maximum(dropped, lay.n_dropped)
            oob = torch.maximum(oob, lay.n_oob)

        aux_c = auxe_c = None
        for _ in range(n_steps):
            lay, un = rebin(lay)
            note(lay, un)
            d1, aux1, d1e, aux1e = deriv(lay, lay.T, lay.E if has_e else None)
            if has_e:
                lay = lay._replace(T=lay.T + d1 * dt, E=lay.E + d1e * dt)
                lay, un, d1, d1e = rebin(lay, d1, d1e)
            else:
                lay = lay._replace(T=lay.T + d1 * dt)
                lay, un, d1 = rebin(lay, d1)
            note(lay, un)
            d2, aux, d2e, aux_e = deriv(lay, lay.T, lay.E if has_e else None)
            lay = lay._replace(T=lay.T + (d2 - d1) * (0.5 * dt),
                               Tov=mean_v(d1, d2))
            if has_e:
                lay = lay._replace(E=lay.E + (d2e - d1e) * (0.5 * dt),
                                   Eov=mean_v(d1e, d2e))
                auxe_c = fold_aux(auxe_c, aux_e, aux1e)
            aux_c = fold_aux(aux_c, aux, aux1)
            bad = bad | nonfinite_lay(lay)
        Xo, ovo = lattice_unbuild(lay, X, old_v)
        return Xo, ovo, _with_flags(to_stable_aux(lay, aux_c, auxe_c),
                                    dropped, oob, bad, unre)

    if rebin_m_cap and rebin_per_pass:
        return run_rebin_per_pass()

    auxs = None
    if rebin_m_cap:
        # slot order across chunks: each chunk re-derives the binning in
        # slot space; the first rebins the fresh build
        lay = lattice_build(X, old_v, n, cube_size, gs, C, extras_cap,
                            x_split=x_split)
        dropped, oob, bad, unre = lay.n_dropped, lay.n_oob, false, zero_i
        for _ in range(n_steps // rebuild_every):
            lay, un = rebin(lay)
            unre = torch.maximum(unre, un)
            dropped = torch.maximum(dropped, lay.n_dropped)
            oob = torch.maximum(oob, lay.n_oob)
            lay, aux_last, bad_c = run_chunk(lay)
            bad = bad | bad_c
            auxs = fold_steps(auxs, aux_last)
        X, old_v = lattice_unbuild(lay, X, old_v)
        return X, old_v, _with_flags(auxs, dropped, oob, bad, unre)

    dropped = oob = zero_i
    bad = false
    if rebuild_every > 1:
        for _ in range(n_steps // rebuild_every):
            lay = build_lay(X, old_v)
            dropped = torch.maximum(dropped, lay.n_dropped)
            oob = torch.maximum(oob, lay.n_oob)
            lay, aux_last, bad_c = run_chunk(lay)
            X, old_v = lattice_unbuild(lay, X, old_v)
            bad = bad | bad_c
            auxs = fold_steps(auxs, aux_last)
        return X, old_v, _with_flags(auxs, dropped, oob, bad)

    def glue(lay, nc):
        """A fresh build's pass and its derivative in stable order, the
        extras' rows merged: ``(dX, aux)``."""
        dXs, aux_s, dXe, aux_e = deriv(lay, lay.T, lay.E if has_e else None,
                                       nc)
        dX = slot_to_stable(lay, dXs)
        if has_e:
            dX = type(dX)(*(_merge_extras(lay, a, e)
                            for a, e in zip(dX, dXe)))
        return dX, to_stable_aux(lay, aux_s, aux_e)

    def first(t):
        lay, Xc, nc = t
        d1, aux1 = glue(lay, nc)
        return d1, aux1, Xc + d1 * dt

    def second(t):
        lay, Xc, d1, aux1, auxs, dropped, oob, bad, \
            (dr1, ob1, dr2, ob2), nc = t
        d2, aux = glue(lay, nc)
        Xn = Xc + (d1 + d2) * (0.5 * dt)
        return (Xn, mean_v(d1, d2), fold_steps(auxs, fold_pair(aux, aux1)),
                torch.maximum(dropped, torch.maximum(dr1, dr2)),
                torch.maximum(oob, torch.maximum(ob1, ob2)),
                bad | nonfinite(Xn))

    def glue_in(lay):
        # what the glue reads of a build: all but its counts
        return lay._replace(n_dropped=None, n_oob=None, n_extras=None)

    # the accumulators keep one structure from the first step on (each a
    # tensor of its own, the aux from zeros): one key for each segment
    oob = torch.zeros_like(zero_i)
    for _ in range(n_steps):
        with span("lattice.build"):
            lay = build_lay(X, old_v)
        counts = (lay.n_dropped, lay.n_oob)
        d1, aux1, X1 = segment("first", first, (glue_in(lay), X, n), False)
        with span("lattice.build"):
            lay = build_lay(X1, old_v)
        counts += (lay.n_dropped, lay.n_oob)
        if auxs is None:
            auxs = {k: torch.zeros_like(v) for k, v in aux1.items()}
        X, old_v, auxs, dropped, oob, bad = segment(
            "second", second, (glue_in(lay), X, d1, aux1, auxs, dropped,
                               oob, bad, counts, n), True)
    return X, old_v, _with_flags(auxs, dropped, oob, bad)
