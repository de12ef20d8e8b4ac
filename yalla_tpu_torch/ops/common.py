"""Shared pair-evaluation machinery for the neighbour engines.

Counterpart of ``yalla_tpu/ops/common.py``.  The pairwise contract is the
same:

    pw_int(Xi, r, dist, i, j) -> dF            (a Pt)
                               | (dF, aux)      (aux: dict name -> per-pair)

with ``r = Xi - Xj``, every argument a tensor (or a Pt of tensors) of one
broadcastable pair-block shape.  ``aux`` channels are masked and summed
over neighbours into named per-cell accumulators; keys starting with
``ERR_PREFIX`` are failure flags that ``Solution`` checks after a call.
"""
from __future__ import annotations

import torch

__all__ = [
    "friction_w_neighbour",
    "friction_on_background",
    "evaluate_pairs",
    "apply_derived_aux",
    "apply_post_pair",
    "mask_tree",
    "cube_coord",
    "cube_ids",
    "grid_dims",
    "out_of_grid_mask",
    "split_force_output",
    "ERR_PREFIX",
]

ERR_PREFIX = "__err_"


def friction_w_neighbour(Xi, r, dist, i, j):
    """Default friction: points closer than 1 exert friction on each other
    (ref solvers.cuh:27-35)."""
    return ((i != j) & (dist < 1.0)).to(torch.float32)


def friction_on_background(Xi, r, dist, i, j):
    """No neighbour friction, drag against the background only
    (ref solvers.cuh:37-41)."""
    return torch.zeros_like(dist)


# the friction the device functors of csrc/forces.cuh implement
# (ops/functors.py, ``friction``)
friction_w_neighbour.cuda_friction = "friction_w_neighbour"

# central-form declarations for the all-pairs central kernel
# (ops/central_mxu.py): f(dist, Si, Sj) with invalid pairs -- padding and
# the i == j diagonal -- excluded by distance poisoning
friction_w_neighbour.central_coef = \
    lambda dist, Si, Sj: (dist < 1.0).to(torch.float32)
friction_on_background.central_coef = \
    lambda dist, Si, Sj: torch.zeros_like(dist)


def mask_tree(pt, mask):
    """Zero every field of a Pt where ``mask`` is False."""
    return type(pt)(*(torch.where(mask, a, torch.zeros_like(a)) for a in pt))


def grid_dims(grid_size):
    """``(gx, gy, gz)`` from an int (cubic grid) or a 3-tuple."""
    if isinstance(grid_size, (tuple, list)):
        gx, gy, gz = (int(g) for g in grid_size)
        return gx, gy, gz
    g = int(grid_size)
    return g, g, g


def _unclipped(v, cube_size, grid_size):
    return torch.floor(v / cube_size).to(torch.int64) + grid_size // 2


def cube_coord(v, cube_size, grid_size):
    """Grid coordinate of one axis, clipped into the grid (out-of-grid
    points are detected separately by :func:`out_of_grid_mask`)."""
    return torch.clamp(_unclipped(v, cube_size, grid_size), 0, grid_size - 1)


def cube_ids(X, n, cube_size, grid_size):
    """Cube id per point, x-minor (ref solvers.cuh:349-365); inactive
    points (index >= n) get the sentinel ``gx * gy * gz``."""
    gx, gy, gz = grid_dims(grid_size)
    active = torch.arange(X.x.shape[0], device=X.x.device) < n
    cid = (cube_coord(X.x, cube_size, gx)
           + (cube_coord(X.y, cube_size, gy)
              + cube_coord(X.z, cube_size, gz) * gy) * gx)
    return torch.where(active, cid, gx * gy * gz)


def out_of_grid_mask(X, n, cube_size, grid_size):
    """True where an active point's UNCLIPPED cube coordinate falls outside
    the grid (clipping would mis-bin it)."""
    gx, gy, gz = grid_dims(grid_size)
    active = torch.arange(X.x.shape[0], device=X.x.device) < n
    bad = torch.zeros_like(active)
    for v, g in ((X.x, gx), (X.y, gy), (X.z, gz)):
        c = _unclipped(v, cube_size, g)
        bad = bad | (c < 0) | (c >= g)
    return active & bad


def split_force_output(out):
    """(dF, aux) from a force's return value: a Pt alone, or a 2-tuple of
    (Pt, dict of per-pair accumulators)."""
    if (isinstance(out, tuple) and not hasattr(out, "_fields")
            and len(out) == 2 and isinstance(out[1], dict)):
        return out
    return out, {}


def apply_derived_aux(pw_int, aux, sum_f):
    """Aux channels recovered from other per-cell sums after the pair pass
    (``pw_int.derive_aux = {name: fn(aux, sum_f)}``)."""
    der = getattr(pw_int, "derive_aux", None)
    if not der:
        return aux
    out = dict(aux)
    for k, fn in der.items():
        out[k] = fn(aux, sum_f)
    return out


def apply_post_pair(pw_int, F, aux, X):
    """Per-cell transform after the pair reduction
    (``pw_int.post_pair = fn(F, aux, X) -> (F, aux)``)."""
    pp = getattr(pw_int, "post_pair", None)
    if pp is None:
        return F, aux
    return pp(F, aux, X)


def _reduce(a, dims):
    # torch.sum(dim=()) would reduce over every axis; () means "no axis"
    return a.sum(dim=dims) if dims else a


def evaluate_pairs(pw_int, pw_friction, Xi, Xj, old_v_j, i, j, pair_mask,
                   sum_axes, cutoff=None):
    """Evaluate forces + friction over one block of candidate pairs.

    Xi fields broadcast against Xj fields (e.g. ``[B, 1]`` vs ``[B, K]``).
    Returns per-i sums reduced over ``sum_axes``:
    (dF (Pt), sum_friction, (sum_vx, sum_vy, sum_vz), aux dict).
    With ``cutoff``, pairs with ``dist >= cutoff`` are masked out too
    (ref compute_cube, solvers.cuh:443-459)."""
    r = Xi - Xj
    dist = torch.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    if cutoff is not None:
        pair_mask = pair_mask & (dist < cutoff)
    shape = pair_mask.shape

    dF, aux = split_force_output(pw_int(Xi, r, dist, i, j))

    def msum(a):
        a = torch.as_tensor(a, dtype=torch.float32, device=pair_mask.device)
        return _reduce(torch.where(pair_mask, a.expand(shape), 0.0),
                       sum_axes)

    F = type(dF)(*(msum(a) for a in dF))
    friction = torch.where(
        pair_mask, pw_friction(Xi, r, dist, i, j).expand(shape), 0.0)
    sum_friction = _reduce(friction, sum_axes)
    sum_v = tuple(_reduce(friction * v, sum_axes) for v in old_v_j)
    aux_sums = {k: msum(v) for k, v in aux.items()}
    return F, sum_friction, sum_v, aux_sums
