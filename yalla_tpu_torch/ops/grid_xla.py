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

This gather form is the port's brute-force Gabriel oracle.  The JAX
package's ``gabriel_windowed`` exists only to avoid XLA:TPU gathers and is
not ported; JAX's own tests hold it equal to the gather form.  Both
passes take the ``(i_offset, i_size)`` window of the sharded cells path
(``parallel/spmd.py``): the rows ``[i_offset, i_offset + i_size)`` summed
against the whole population.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .common import cube_ids, evaluate_pairs, out_of_grid_mask

__all__ = ["GridTables", "build_grid", "row_ranges", "grid_pairwise",
           "gabriel_pairwise", "grid_overflow", "grid_out_of_bounds"]


class GridTables(NamedTuple):
    order: torch.Tensor       # int64[n_pad]: point id per sorted slot
    cid: torch.Tensor         # int64[n_pad]: cube id per point (unsorted)
    cube_start: torch.Tensor  # int64[n_cubes + 1]: first sorted slot per cube
    cube_end: torch.Tensor    # int64[n_cubes + 1]: last sorted slot (incl.)


def _row_offsets(grid_size, device=None):
    """27 neighbour-cube offsets grouped as 9 rows of 3 consecutive cubes
    (cf. the ``d_nhood`` construction, ref solvers.cuh:472-484)."""
    offs = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            row = dz * grid_size * grid_size + dy * grid_size
            offs.append([row - 1, row, row + 1])
    return torch.tensor(offs, dtype=torch.int64, device=device)  # [9, 3]


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
    in aux."""
    n_pad = X.x.shape[0]
    tables = build_grid(X, n, cube_size, grid_size)
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
                                         & (ids[:, None] < n)).any(dim=1) \
            .to(torch.float32)
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
