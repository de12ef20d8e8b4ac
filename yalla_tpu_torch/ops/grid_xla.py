"""Spatial-hash grid engine and the gather-form Gabriel refinement.

Counterpart of ``yalla_tpu/ops/grid_xla.py`` (ref solvers.cuh:345-644):

* binning is a stable sort of the cube ids; ``cube_start`` / ``cube_end``
  are scatter-min / scatter-max tables over the sorted order;
* the 27-cube sweep is 9 contiguous row ranges of the sorted order (three
  consecutive cube ids per (dy, dz) row), each read at a fixed
  ``row_cap`` capacity; a fuller row raises ``__err_grid_overflow``;
* ``gabriel_pairwise`` keeps pair (i, j) unless a *closer* candidate lies
  inside the sphere of radius ``0.5 * dist * gabriel_coefficient`` on the
  i-j midpoint (ref solvers.cuh:509-602), over the ``max_candidates``
  nearest candidates (``torch.topk``); more raise
  ``__err_gabriel_candidates``.

``gabriel_windowed`` is the JAX package's default Gabriel route off the
lattice kernel: consecutive cube-sorted points share nine windows of the
sorted order, and the points whose rows do not fit their subgroup's
windows are salvaged exactly by the gather form (more of them than
``salvage_cap`` raise ``__err_gabriel_window``).  The window geometry
decides which points misfit, so the port keeps JAX's: the block size, the
subgroups, the median anchor and the windows of whole 64-entry segments.
The gather form is the brute-force oracle of both.  ``grid_pairwise`` and
``gabriel_pairwise`` take the ``(i_offset, i_size)`` window of the sharded
cells path (``parallel/spmd.py``): the rows ``[i_offset, i_offset +
i_size)`` summed against the whole population.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .common import cube_ids, evaluate_pairs, out_of_grid_mask

__all__ = ["GridTables", "build_grid", "row_ranges", "grid_pairwise",
           "grid_pair_sums", "gabriel_pairwise", "gabriel_windowed",
           "window_geometry", "grid_overflow", "grid_out_of_bounds"]

# elements of one chunk of subgroups' [subgroups, g, 9, We] candidate
# tensors in ``gabriel_windowed``
WINDOW_BLOCK = 1 << 23


class GridTables(NamedTuple):
    order: torch.Tensor       # int64[n_pad]: point id per sorted slot
    cid: torch.Tensor         # int64[n_pad]: cube id per point (unsorted)
    cube_start: torch.Tensor  # int64[n_cubes + 1]: first sorted slot per cube
    cube_end: torch.Tensor    # int64[n_cubes + 1]: last sorted slot (incl.)


def _row_offsets(grid_size, device=None):
    """27 neighbour-cube offsets grouped as 9 rows of 3 consecutive cubes
    (cf. the ``d_nhood`` construction, ref solvers.cuh:472-484), made on
    ``device``: no copy from the host, which would wait for the device's
    queue."""
    d = torch.arange(-1, 2, dtype=torch.int64, device=device)
    rows = d[:, None] * (grid_size * grid_size) + d[None, :] * grid_size
    return rows.reshape(9, 1) + d    # [9, 3]


def build_grid(X, n, cube_size, grid_size):
    """Bin points into cubes and index the sorted order (ref
    solvers.cuh:349-365).  Inactive points get the sentinel cube id
    ``grid_size ** 3``, which sorts last."""
    n_pad = X.x.shape[0]
    dev = X.x.device
    n_cubes = grid_size ** 3
    cid = cube_ids(X, n, cube_size, grid_size)
    sorted_cid, order = torch.sort(cid, stable=True)
    slot = torch.arange(n_pad, device=dev)
    cube_start = torch.full((n_cubes + 1,), n_pad, dtype=torch.int64,
                            device=dev).scatter_reduce(
        0, sorted_cid, slot, "amin")
    cube_end = torch.full((n_cubes + 1,), -1, dtype=torch.int64,
                          device=dev).scatter_reduce(
        0, sorted_cid, slot, "amax")
    return GridTables(order, cid, cube_start, cube_end)


def row_ranges(tables: GridTables, cid_blk, grid_size):
    """Sorted-order span [rs, re] (inclusive) of each of the 9 neighbour
    rows for a block of cube ids: ``([B, 9], [B, 9])``."""
    n_cubes = grid_size ** 3
    offs = _row_offsets(grid_size, cid_blk.device)
    qc = torch.clamp(cid_blk[:, None, None] + offs[None], 0, n_cubes - 1)
    rs = tables.cube_start[qc].amin(dim=2)
    re = tables.cube_end[qc].amax(dim=2)
    return rs, re


def grid_overflow(tables: GridTables, grid_size, row_cap):
    """True (0-d bool) if any 3-cube row holds more candidates than
    ``row_cap`` (the analogue of the reference's capacity D_ASSERTs)."""
    rs, re = row_ranges(tables, tables.cid, grid_size)
    return (re - rs + 1 > row_cap).any()


def grid_out_of_bounds(X, n, cube_size, grid_size):
    """True (0-d bool) if any active point's unclipped cube coordinate
    falls outside the grid (``build_grid`` clips it into an edge cube)."""
    return out_of_grid_mask(X, n, cube_size, grid_size).any()


def _candidates(order, rs, re, row_cap):
    """Candidate point ids for an i-block: ``[B, 9, row_cap]`` and their
    validity, from the row ranges."""
    pos = rs[:, :, None] + torch.arange(row_cap, device=rs.device)
    valid = pos <= re[:, :, None]
    n_pad = order.shape[0]
    return order[torch.clamp(pos, 0, n_pad - 1)], valid


def _concat(outs):
    """One ``(F, sum_f, sum_v, aux)`` from the per-block ones."""
    F = type(outs[0][0])(*(torch.cat([o[0][k] for o in outs])
                           for k in range(len(outs[0][0]))))
    sum_f = torch.cat([o[1] for o in outs])
    sum_v = tuple(torch.cat([o[2][c] for o in outs]) for c in range(3))
    aux = {k: torch.cat([o[3][k] for o in outs]) for k in outs[0][3]}
    return F, sum_f, sum_v, aux


def _window(n_pad, i_offset, i_size, device):
    """The row ids ``[i_offset, i_offset + i_size)`` (default: all)."""
    if i_size is None:
        i_size = n_pad - i_offset
    return torch.arange(i_offset, i_offset + i_size, device=device)


def grid_pairwise(pw_int, pw_friction, X, old_v, n, cube_size, *,
                  grid_size=50, row_cap=32, i_block=4096, i_offset=0,
                  i_size=None):
    """Pairwise sums over grid neighbours with the ``dist < cube_size``
    cutoff (ref ``Grid_computer::pwints`` + ``compute_cube``,
    solvers.cuh:430-499) for the rows ``[i_offset, i_offset + i_size)``
    (default: all) against the whole population; the grid is rebuilt on
    every call, as the reference rebuilds it per pass.  Returns per-row
    ``(F, sum_f, sum_v, aux)`` with the per-row ``__err_grid_overflow``
    in aux: :func:`grid_pair_sums` on :func:`build_grid`'s tables."""
    return grid_pair_sums(pw_int, pw_friction, X, old_v, n, cube_size,
                          build_grid(X, n, cube_size, grid_size),
                          grid_size=grid_size, row_cap=row_cap,
                          i_block=i_block, i_offset=i_offset, i_size=i_size)


def grid_pair_sums(pw_int, pw_friction, X, old_v, n, cube_size, tables, *,
                   grid_size, row_cap, i_block, i_offset=0, i_size=None):
    """The pass of :func:`grid_pairwise` on the grid ``tables`` built
    from ``X``: each block's row ranges, candidate gathers, force and
    sums.  ``n`` is a Python int or a 0-d int64 device tensor."""
    n_pad = X.x.shape[0]
    outs = []
    for ids in _window(n_pad, i_offset, i_size, X.x.device).split(i_block):
        rs, re = row_ranges(tables, tables.cid[ids], grid_size)
        jidx, valid = _candidates(tables.order, rs, re, row_cap)
        Xi = type(X)(*(a[ids][:, None, None] for a in X))
        Xj = type(X)(*(a[jidx] for a in X))
        ovj = tuple(a[jidx] for a in old_v)
        i_arr = ids[:, None, None]
        out = evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj, i_arr, jidx,
                             valid & (i_arr < n), sum_axes=(1, 2),
                             cutoff=cube_size)
        # a row with more candidates than row_cap silently drops pairs
        out[3]["__err_grid_overflow"] = ((re - rs + 1 > row_cap)
                                         & (ids[:, None] < n)) \
            .any(dim=1).to(torch.float32)
        outs.append(out)
    return _concat(outs)


def _gabriel_block(pw_int, pw_friction, X, old_v, n, cube_size, tables, *,
                   ids, act, grid_size, row_cap, gabriel_coefficient,
                   max_candidates):
    """Gabriel force sums for a vector of point ids (the per-point
    row-gather formulation)."""
    B = ids.shape[0]
    K = 9 * row_cap
    NC = min(max_candidates, K)
    rs, re = row_ranges(tables, tables.cid[ids], grid_size)
    jidx, valid = _candidates(tables.order, rs, re, row_cap)
    jidx = jidx.reshape(B, K)
    i_arr = ids[:, None]
    valid = valid.reshape(B, K) & act[:, None]

    xj, yj, zj = X.x[jidx], X.y[jidx], X.z[jidx]
    xi, yi, zi = X.x[ids][:, None], X.y[ids][:, None], X.z[ids][:, None]
    dx, dy, dz = xi - xj, yi - yj, zi - zj
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    cand = valid & (dist < cube_size)
    n_cand = cand.sum(dim=1)  # per point, before the NC cap

    # the NC nearest candidates, sorted by distance (the reference
    # selection-sorts a fixed 100-entry array, solvers.cuh:549-566)
    sort_key = torch.where(cand, dist, torch.inf)
    sort_ord = torch.topk(-sort_key, NC, dim=1).indices

    def take(a):
        return torch.gather(a, 1, sort_ord)
    jidx_s, cand_s, dist_s = take(jidx), take(cand), take(dist)
    xj_s, yj_s, zj_s = take(xj), take(yj), take(zj)

    # keep (i, j) unless a closer candidate k lies inside the sphere on
    # the i-j midpoint (ref solvers.cuh:572-597)
    mx, my, mz = (xi + xj_s) * 0.5, (yi + yj_s) * 0.5, (zi + zj_s) * 0.5

    def sq(a):
        return a * a
    d2 = (sq(mx[:, :, None] - xj_s[:, None, :])
          + sq(my[:, :, None] - yj_s[:, None, :])
          + sq(mz[:, :, None] - zj_s[:, None, :]))
    radius2 = sq(0.5 * dist_s * gabriel_coefficient)  # [B, NC]
    m_ids = torch.arange(NC, device=ids.device)[:, None]
    k_ids = torch.arange(NC, device=ids.device)[None, :]
    closer = (k_ids < m_ids)[None] & cand_s[:, None, :]
    blocked = (closer & (d2 < radius2[:, :, None])).any(dim=2)
    keep = cand_s & ((jidx_s == i_arr) | ~blocked)

    Xi = type(X)(*(a[ids][:, None] for a in X))
    Xj = type(X)(*(a[jidx_s] for a in X)).replace(x=xj_s, y=yj_s, z=zj_s)
    ovj = tuple(a[jidx_s] for a in old_v)
    out = evaluate_pairs(pw_int, pw_friction, Xi, Xj, ovj, i_arr, jidx_s,
                         keep, sum_axes=(1,))
    out[3]["__err_grid_overflow"] = ((re - rs + 1 > row_cap)
                                     & act[:, None]).any(dim=1) \
        .to(torch.float32)
    # pairs past the NC nearest are dropped: surface it like a D_ASSERT
    out[3]["__err_gabriel_candidates"] = ((n_cand > NC) & act) \
        .to(torch.float32)
    return out


def gabriel_pairwise(pw_int, pw_friction, X, old_v, n, cube_size, *,
                     grid_size=50, row_cap=32, gabriel_coefficient=0.8,
                     i_block=256, max_candidates=100, i_offset=0,
                     i_size=None):
    """Grid neighbours pruned to (scaled) Gabriel-graph pairs
    (``compute_cube_gabriel``, ref solvers.cuh:509-602), in blocks of
    ``i_block`` points, for the rows ``[i_offset, i_offset + i_size)``
    (default: all).  The midpoint test runs on the ``max_candidates``
    nearest candidates of each point (the point itself among them, kept
    as the diagonal); more set ``__err_gabriel_candidates``."""
    n_pad = X.x.shape[0]
    tables = build_grid(X, n, cube_size, grid_size)
    outs = [_gabriel_block(pw_int, pw_friction, X, old_v, n, cube_size,
                           tables, ids=ids, act=ids < n, grid_size=grid_size,
                           row_cap=row_cap,
                           gabriel_coefficient=gabriel_coefficient,
                           max_candidates=max_candidates)
            for ids in _window(n_pad, i_offset, i_size,
                               X.x.device).split(i_block)]
    return _concat(outs)


def _block_size(n, want):
    """The largest ``want / 2**k`` (at most ``n``) that divides ``n``."""
    b = min(want, n)
    while n % b:
        b //= 2
    return b


def window_geometry(n_pad, i_block=64, window_cap=256, subgroup=None):
    """``(B, g, Wr, We)`` of the windowed pass, as JAX derives them: the
    block ``B`` of sorted points (``i_block`` halved until it divides
    ``n_pad``), the subgroup ``g`` of consecutive sorted points sharing
    nine windows (``subgroup``, lowered until it divides ``B``; ``None``:
    the whole block), the window ``Wr`` that is centred on the median
    ranges and the fetched window ``We``: the whole 64-entry segments
    that cover ``Wr`` entries at any alignment.  ``n_pad % 64 != 0``
    raises ``ValueError``."""
    if n_pad % 64:
        raise ValueError(f"gabriel_windowed needs n_pad % 64 == 0, got "
                         f"n_pad {n_pad}")
    B = _block_size(n_pad, i_block)
    g = B if subgroup is None else max(1, min(subgroup, B))
    while B % g:
        g -= 1
    Wr = min(window_cap, n_pad)
    We = min((-(-Wr // 64) + 1) * 64, n_pad)
    return B, g, Wr, We


def _median_windows(rs_g, re_g, act_g, n_pad, Wr, We):
    """Per subgroup and row, the first sorted position of its window,
    centred on the median range over the subgroup's non-empty entries and
    rounded down to a 64-entry segment (``[G, 9]``), and which points'
    rows all fit their windows (``[G, g]``)."""
    nonempty = act_g[:, :, None] & (rs_g <= re_g)
    rs_f = torch.where(nonempty, rs_g, n_pad)      # empties sort last
    re_f = torch.where(nonempty, re_g, n_pad)
    mid = (torch.clamp(nonempty.sum(dim=1) - 1, min=0) // 2)[:, None]
    rs_med = torch.sort(rs_f, dim=1).values.gather(1, mid)[:, 0]  # [G, 9]
    re_med = torch.sort(re_f, dim=1).values.gather(1, mid)[:, 0]
    w0 = torch.clamp(torch.div(rs_med + re_med - Wr, 2,
                               rounding_mode="floor"), 0, n_pad - Wr)
    w0a = torch.clamp(torch.div(w0, 64, rounding_mode="floor") * 64, 0,
                      max(n_pad - We, 0))
    lo = w0a[:, None]
    fit = ((rs_g > re_g) | ((rs_g >= lo) & (re_g <= lo + (We - 1)))) \
        .all(dim=2) & act_g
    return w0a, fit


def gabriel_windowed(pw_int, pw_friction, X, old_v, n, cube_size, *,
                     grid_size=50, gabriel_coefficient=0.8, i_block=64,
                     window_cap=256, max_candidates=32, row_cap=32,
                     salvage_cap=256, subgroup=None):
    """Gabriel pairs through shared windows of the cube-sorted order (the
    JAX package's ``gabriel_windowed``, the same function).

    Each subgroup of ``g`` consecutive sorted points (``window_geometry``)
    takes, for each of its nine (dz, dy) rows, one window of ``We``
    sorted entries centred on the subgroup's median row range; a point's
    candidates are the window entries inside its own row ranges and
    within ``cube_size``, of which the ``max_candidates`` nearest stay
    (more raise ``__err_gabriel_candidates``).  The midpoint test runs on
    that compact set for both j and the blocker k: any blocker lies
    within ``0.9 * dist_ij < cube_size`` of i, so the complete candidate
    list holds it.  The force sees the stable ids on both sides.

    A point whose rows do not all fit its subgroup's windows is left out
    of the windowed pass and salvaged exactly by the gather form
    (``_gabriel_block``) in a pass of ``salvage_cap`` ids; more misfits
    than that lose their pairs and raise ``__err_gabriel_window``
    (on every row).  ``__err_grid_overflow`` is a salvaged point's 3-cube
    row past ``row_cap``.

    The subgroups run in chunks of about ``WINDOW_BLOCK`` candidate
    entries, with no value read back to the host.  Only the subgroups
    that hold an active point are visited (the active points sort first):
    the rest have no candidates, and their rows are zero, as in JAX's
    pass over every block."""
    n_pad = X.x.shape[0]
    dev = X.x.device
    B, g, Wr, We = window_geometry(n_pad, i_block, window_cap, subgroup)
    NC = min(max_candidates, 9 * We)
    tables = build_grid(X, n, cube_size, grid_size)
    order = tables.order
    act = order < n                               # per sorted position
    n_vis = min(n_pad, max(1, -(-n // g)) * g)    # the rows of the visited
    rs, re = row_ranges(tables, tables.cid[order[:n_vis]], grid_size)
    Xs = type(X)(*(a[order] for a in X))          # sorted channels
    ovs = tuple(a[order] for a in old_v)
    lanes = torch.arange(We, device=dev)
    per_sub = g * max(9 * We, NC * NC)
    outs, misfit = [], []
    for s in torch.arange(n_vis // g, device=dev).split(
            max(1, WINDOW_BLOCK // per_sub)):
        G = s.shape[0]
        rows = (s[:, None] * g + torch.arange(g, device=dev)).reshape(-1)
        rs_g, re_g = rs[rows].reshape(G, g, 9), re[rows].reshape(G, g, 9)
        act_g = act[rows].reshape(G, g)
        w0a, fit = _median_windows(rs_g, re_g, act_g, n_pad, Wr, We)
        misfit.append((act_g & ~fit).reshape(-1))
        wpos = w0a[:, :, None] + lanes                       # [G, 9, We]
        valid = ((wpos[:, None] >= rs_g[..., None])
                 & (wpos[:, None] <= re_g[..., None])
                 & act[wpos][:, None])                       # [G, g, 9, We]
        R = G * g
        Xi = type(X)(*(a[rows][:, None] for a in Xs))          # [R, 1]

        def gap(xi, xs):
            return (xi.reshape(G, g, 1, 1) - xs[wpos][:, None]) ** 2
        dist = torch.sqrt(gap(Xi.x, Xs.x) + gap(Xi.y, Xs.y)
                          + gap(Xi.z, Xs.z))                 # [G, g, 9, We]
        cand = valid & (dist < cube_size) & fit[..., None, None]
        n_cand = cand.sum(dim=(2, 3)).reshape(R)

        # the NC nearest candidates over the nine windows
        key = torch.where(cand, dist, torch.inf).reshape(R, 9 * We)
        sel = torch.topk(-key, NC, dim=1).indices                # [R, NC]
        jpos = wpos[:, None].expand(G, g, 9, We).reshape(R, 9 * We) \
            .gather(1, sel)                                  # sorted places
        cand_s = cand.reshape(R, -1).gather(1, sel)
        dist_s = dist.reshape(R, -1).gather(1, sel)
        Xj = type(X)(*(a[jpos] for a in Xs))

        # keep (i, j) unless a candidate k lies inside the sphere on the
        # i-j midpoint; the self pair has radius 0 and stays
        def gap2(xi, xj):
            return (((xi + xj) * 0.5)[:, :, None] - xj[:, None, :]) ** 2
        d2 = gap2(Xi.x, Xj.x) + gap2(Xi.y, Xj.y) + gap2(Xi.z, Xj.z)
        radius2 = (0.5 * dist_s * gabriel_coefficient) ** 2
        blocked = (cand_s[:, None, :] & (d2 < radius2[:, :, None])).any(dim=2)
        keep = cand_s & ~blocked
        out = evaluate_pairs(pw_int, pw_friction, Xi, Xj,
                             tuple(a[jpos] for a in ovs),
                             order[rows][:, None], order[jpos], keep,
                             sum_axes=(1,))
        # a fitting point sees its whole rows inside the windows, so only
        # the salvage pass can overflow row_cap
        out[3]["__err_grid_overflow"] = torch.zeros(R, device=dev)
        out[3]["__err_gabriel_candidates"] = \
            ((n_cand > NC) & fit.reshape(R)).to(torch.float32)
        outs.append(out)
    F, sum_f, sum_v, aux = _concat(outs)
    ids = order[:n_vis]

    def back(a):
        full = torch.zeros(n_pad, dtype=a.dtype, device=dev)
        full[ids] = a
        return full
    F = type(F)(*(back(a) for a in F))
    sum_f, sum_v = back(sum_f), tuple(back(a) for a in sum_v)
    aux = {k: back(v) for k, v in aux.items()}

    # the misfits, in stable-id order, through a fixed-size gather pass
    mis = back(torch.cat(misfit))
    slot = torch.cumsum(mis, 0) - 1
    fits = mis & (slot < salvage_cap)
    mis_idx = torch.full((salvage_cap + 1,), n_pad, dtype=torch.int64,
                         device=dev).scatter_(
        0, torch.where(fits, slot, salvage_cap),
        torch.arange(n_pad, device=dev))[:salvage_cap]
    act_s = mis_idx < n_pad
    Fs, sum_fs, sum_vs, aux_s = _gabriel_block(
        pw_int, pw_friction, X, old_v, n, cube_size, tables,
        ids=torch.clamp(mis_idx, max=n_pad - 1), act=act_s,
        grid_size=grid_size, row_cap=row_cap,
        gabriel_coefficient=gabriel_coefficient, max_candidates=NC)
    tgt = torch.where(act_s, mis_idx, n_pad)

    def put(a, v):
        return torch.cat([a, a.new_zeros(1)]).index_copy(0, tgt, v)[:n_pad]
    F = type(F)(*(put(a, v) for a, v in zip(F, Fs)))
    sum_f = put(sum_f, sum_fs)
    sum_v = tuple(put(a, v) for a, v in zip(sum_v, sum_vs))
    aux = {k: put(aux[k], aux_s[k]) for k in aux}
    # more misfits than the salvage pass holds: the rest lost their pairs
    aux["__err_gabriel_window"] = (mis.sum() > salvage_cap) \
        .to(torch.float32).expand(n_pad).clone()
    return F, sum_f, sum_v, aux
