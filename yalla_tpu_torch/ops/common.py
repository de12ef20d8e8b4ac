"""Shared pair-evaluation machinery for the neighbour engines.

Counterpart of ``yalla_tpu/ops/common.py``.  The pairwise contract is the
same:

    pw_int(Xi, r, dist, i, j) -> dF            (a Pt)
                               | (dF, aux)      (aux: dict name -> per-pair)

with ``r = Xi - Xj``, every argument a tensor (or a Pt of tensors) of one
broadcastable pair-block shape.  ``aux`` channels are masked and summed
over neighbours into named per-cell accumulators; keys starting with
``ERR_PREFIX`` are failure flags that ``Solution`` checks after a call.

Below the pair passes, the Heun derivative that the port's four
integrators share (``solvers.heun_step``, ``ops.lattice_xla.
lattice_heun_steps``, ``parallel.spmd.make_sharded_step`` and
``parallel.lattice_spmd.lattice_sharded_heun_steps``): a pass's sums to a
derivative (:func:`derivative`), the momentum fix (:func:`momentum_fix`),
the step's mean velocity (:func:`mean_v`) and the folds of the flags
(:func:`fold_pair`, :func:`fold_steps`).
"""
from __future__ import annotations

import torch

from ..dtypes import Float3, make_pt

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
    "augment",
    "truncate_aug",
    "nonfinite",
    "add_rhs",
    "derivative",
    "momentum_fix",
    "mean_v",
    "fold_pair",
    "fold_steps",
    "ERR_PREFIX",
]

ERR_PREFIX = "__err_"
# the lattice integrator's staleness measures, folded over steps as the
# flags are
STALE_PREFIX = "stale_"


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


def cube_ids(X, n, cube_size, grid_size, x_split=1):
    """Cube id per point, x-minor (ref solvers.cuh:349-365); inactive
    points (index >= n) get the sentinel ``gx * gy * gz``.

    ``x_split > 1`` bins x at ``cube_size / x_split`` (thin x-cubes, of
    which ``gx`` counts); y and z keep ``cube_size``."""
    gx, gy, gz = grid_dims(grid_size)
    active = torch.arange(X.x.shape[0], device=X.x.device) < n
    cid = (cube_coord(X.x, cube_size / x_split, gx)
           + (cube_coord(X.y, cube_size, gy)
              + cube_coord(X.z, cube_size, gz) * gy) * gx)
    return torch.where(active, cid, gx * gy * gz)


def out_of_grid_mask(X, n, cube_size, grid_size, x_split=1):
    """True where an active point's UNCLIPPED cube coordinate falls outside
    the grid (clipping would mis-bin it); x at ``cube_size / x_split``
    as :func:`cube_ids` bins it."""
    gx, gy, gz = grid_dims(grid_size)
    active = torch.arange(X.x.shape[0], device=X.x.device) < n
    bad = torch.zeros_like(active)
    for v, g, cs in ((X.x, gx, cube_size / x_split), (X.y, gy, cube_size),
                     (X.z, gz, cube_size)):
        c = _unclipped(v, cs, g)
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


# --------------------------------------------------------------------------
# The Heun derivative shared by the integrators (ref solvers.cuh:109-161,
# 196-208, 226-275)
# --------------------------------------------------------------------------

def augment(X, n, precompute):
    """Append derived per-point fields (e.g. polarity vectors) for the
    duration of one pairwise pass; they flow through Xi / Xj / r."""
    if precompute is None:
        return X
    aug = precompute(X, n)
    AugT = make_pt(type(X).__name__ + "Aug",
                   *(list(type(X)._fields[3:]) + list(aug.keys())))
    return AugT(*X, *aug.values())


def truncate_aug(F, orig_type):
    """``F`` with the fields :func:`augment` appended cut off."""
    if type(F).__name__ == orig_type.__name__:
        return F
    return orig_type(*tuple(F)[:len(orig_type._fields)])


def nonfinite(pt):
    """0-d bool tensor: any non-finite value in any field."""
    return torch.stack([~torch.isfinite(a).all() for a in pt]).any()


def add_rhs(F, sum_f, sum_v):
    """Add the friction-weighted mean neighbour velocity to F's x, y, z
    (ref add_rhs, solvers.cuh:146-161); no friction, no term."""
    inv = torch.where(sum_f > 0, 1.0 / torch.where(sum_f > 0, sum_f, 1.0),
                      0.0)
    return F.replace(x=F.x + sum_v[0] * inv, y=F.y + sum_v[1] * inv,
                     z=F.z + sum_v[2] * inv)


def derivative(pw_int, out, Xa, pt, live, add_gen=None):
    """``(dX, aux)`` of one pair pass, before the momentum fix.

    ``out`` is the pass's ``(F, sum_f, sum_v, aux)`` over the rows of
    ``Xa``, the state :func:`augment` gave; ``pt`` the point type of the
    derivative.  The derived aux and the post-pair transform, the
    augmented fields cut off, the generic force (``add_gen(F) -> F``,
    which adds its dX in the rows' order), the friction term, and every
    row not ``live`` zeroed."""
    F, sum_f, sum_v, aux = out
    aux = apply_derived_aux(pw_int, aux, sum_f)
    F, aux = apply_post_pair(pw_int, F, aux, Xa)
    F = truncate_aug(F, pt)
    if add_gen is not None:
        F = add_gen(F)
    return mask_tree(add_rhs(F, sum_f, sum_v), live), aux


# the components each fix mode takes from the COM drift; the others are
# the pinned point's
_COM_AXES = {"com": "xyz", "point": "", "com_z": "z"}


def momentum_fix(parts, count, fix_mode, fix_point, psum=None):
    """The derivatives of ``parts`` with the momentum fix subtracted from
    x, y, z of their live rows (ref solvers.cuh:196-208, 240-253): each
    component the COM drift, or the value at the stable id ``fix_point``
    (``fix_mode`` "com", "point", or "com_z": x and y the point's, z the
    drift).

    ``parts`` is a list of ``(dX, live, ids)`` (a lattice and its
    overflow extras): ``ids`` the stable id of each row, or an int, the
    stable id of the first of rows in stable order.  ``count``, an int or
    a 0-d device tensor, counts the live rows of every part and rank (at
    least 1 is taken); ``psum``, where given, sums a tensor over the
    ranks.  The sums are f64, so that the drift does not depend on how
    the rows are split, and the drift is their product with the f64
    reciprocal of ``count``: what the card computes for a division by a
    host number, so a count on the host and one on the device give the
    same bits."""
    com = _COM_AXES.get(fix_mode)
    if com is None:
        raise ValueError(fix_mode)
    tot = torch.stack([_sum64(parts, f, f in com, fix_point) for f in "xyz"])
    if psum is not None:
        tot = psum(tot)
    at = tot.to(torch.float32) if com != "xyz" else None
    if com:
        inv = torch.reciprocal(torch.clamp(count, min=1).to(torch.float64)) \
            if isinstance(count, torch.Tensor) else 1.0 / max(count, 1)
        drift = (tot * inv).to(torch.float32)
    fix = {f: drift[k] if f in com else at[k] for k, f in enumerate("xyz")}
    return [d.replace(**{f: torch.where(live, getattr(d, f) - v, 0.0)
                         for f, v in fix.items()})
            for d, live, _ in parts]


def _sum64(parts, f, com, fix_point):
    """The f64 sum over ``parts`` of the field ``f``: of the live rows
    (``com``), else of the row of stable id ``fix_point``."""
    total = None
    for d, live, ids in parts:
        a = getattr(d, f)
        if com:
            s = torch.where(live, a, 0.0).sum(dtype=torch.float64)
        elif isinstance(ids, torch.Tensor):
            s = torch.where(ids == fix_point, a, 0.0).sum(
                dtype=torch.float64)
        elif 0 <= fix_point - ids < a.shape[0]:
            s = a[fix_point - ids].to(torch.float64)
        else:
            s = a.new_zeros((), dtype=torch.float64)
        total = s if total is None else total + s
    return total


def mean_v(d1, d2):
    """The Heun step's old_v: the mean of its two derivatives' x, y, z."""
    return Float3(x=(d1.x + d2.x) * 0.5, y=(d1.y + d2.y) * 0.5,
                  z=(d1.z + d2.z) * 0.5)


def fold_pair(aux2, aux1):
    """A pass pair's aux: the corrector's ``aux2``, each failure flag
    max'ed with the predictor's."""
    return {k: torch.maximum(v, aux1[k]) if k.startswith(ERR_PREFIX)
            else v for k, v in aux2.items()}


def fold_steps(acc, aux):
    """Aux over steps or chunks (``acc`` None or empty before the first):
    each failure flag and staleness measure the maximum of all, every
    other channel the latest."""
    if not acc:
        return dict(aux)
    return {k: torch.maximum(acc[k], v)
            if k.startswith(ERR_PREFIX) or k.startswith(STALE_PREFIX) else v
            for k, v in aux.items()}
