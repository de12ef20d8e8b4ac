"""All-pairs pass for *central* forces (kernel K4) and its plain version.

Counterpart of ``yalla_tpu/ops/central_mxu.py``.  A central force's
positional term is a scalar radial coefficient times the pair separation,

    dF_xyz = w(dist, S_i, S_j, ch_ij) * r        (r = Xi - Xj)

so its reductions factor as ``F_i = x_i * sum_j w_ij - sum_j w_ij x_j``,
and the friction mixing the same way (ref solvers.cuh:146-161).  Scalar
per-cell ``fields`` enter as ``S_i``/``S_j``; ``bilinear`` channels
``ch_ij = sum_k a_k(X_i) b_k(X_j)`` carry type-pair tables (e.g. the
differential-adhesion strengths, ref examples/sorting.cu:16-28).

* ``central_force`` declares such a force.  The result satisfies the
  generic pairwise contract on every engine, and ``TileEngine`` routes it
  to ``central_pairwise_mxu``.
* ``central_pairwise_mxu`` is the kernel wrapper: a CUDA tensor goes to
  ``csrc/central_pair.cu``, a CPU tensor to ``central_pairwise_plain``.
  The kernel evaluates the coefficient and the aux channels as a device
  functor, so a force declares it (``force.cuda_functor``), and a force
  without one is refused on the GPU.  Like the all-pairs kernel it splits
  j across blocks (``tile_pallas.tile_plan``, :func:`central_plan`).
* ``central_pairwise_plain`` computes the same factored sums in torch.

Coefficient contract (as in the JAX package): ``coef`` returns 0 past its
interaction radius and stays finite at the sentinel distance 1e4.  Invalid
pairs -- padding and the i == j diagonal -- are excluded by poisoning
their distance; the diagonal's own terms (``diag``, a friction's
``self_friction``) are added afterwards, n-sized, on both paths.
"""
from __future__ import annotations

import ctypes

import torch

from .common import (friction_on_background, friction_w_neighbour,
                     split_force_output)
from ..utils.profiling import count
from .functors import param_array, require
from .tile_pallas import sm_count, tile_plan

__all__ = ["central_force", "central_pairwise_mxu", "central_pairwise_plain",
           "central_plan", "CENTRAL_SENTINEL"]

# poisoned-pair distance: past every physical cutoff, small enough that
# polynomial coefficients of dist stay finite in f32
CENTRAL_SENTINEL = 1e4

# coefficient functors of csrc/central_pair.cu: C entry point, the scalar
# fields and bilinear arities the force must have, the aux channels it
# sums, and the parameter values it takes
CENTRAL_FUNCTORS = {
    "sorting_adhesion_central": dict(
        entry="yalla_central_pair_sorting", fields=(), arities=(2,),
        aux=(), params=("r_max", "r_min")),
    # the same coefficient with the neighbour count dist < r_max
    "sorting_adhesion_central_nbs": dict(
        entry="yalla_central_pair_sorting_nbs", fields=(), arities=(2,),
        aux=("nbs",), params=("r_max", "r_min")),
}
# i-points per thread of csrc/central_pair.cu (its template parameter R)
CENTRAL_ROWS = 4
# the friction coefficient the kernel evaluates, by its flag
_FRICTION_FLAGS = {friction_w_neighbour: 1, friction_on_background: 0}
# rows of the plain version's pair block ([_I_BLOCK, n_pad] at a time)
_I_BLOCK = 1024


class _CentralForce:
    """Callable satisfying the generic pairwise contract; see
    ``central_force``."""

    def __init__(self, Pt, coef, fields, bilinear, aux, diag, name):
        self.Pt = Pt
        self.coef = coef
        self.fields = tuple(fields)
        self.bilinear = dict(bilinear or {})
        self.aux = dict(aux or {})
        self.diag = diag
        self.__name__ = name

    # -- generic elementwise evaluation (any engine) ------------------------
    def _channels(self, Xi, r):
        Si = {f: getattr(Xi, f) for f in self.fields}
        Sj = {f: getattr(Xi, f) - getattr(r, f) for f in self.fields}
        Xj = Xi - r
        ch = {}
        for name, (fa, fb) in self.bilinear.items():
            ch[name] = sum(ai * bi for ai, bi in zip(fa(Xi), fb(Xj)))
        return Si, Sj, ch

    def __call__(self, Xi, r, dist, i, j):
        Si, Sj, ch = self._channels(Xi, r)
        off = i != j
        # poisoned dist on the diagonal: coef sees the same inputs the
        # kernel feeds it, so its cutoff gating handles both identically
        d = torch.where(off, dist, CENTRAL_SENTINEL)
        w = self.coef(d, Si, Sj, **ch)
        zero = torch.zeros_like(dist + w)
        vals = {"x": w * r.x, "y": w * r.y, "z": w * r.z}
        if self.diag is not None:
            dPt = self.diag(Xi)
            on = 1.0 - off.to(w.dtype)
            for f in self.Pt._fields:
                dv = getattr(dPt, f)
                if f in vals:
                    vals[f] = vals[f] + on * dv
                elif dv is not None:
                    vals[f] = on * dv
        dF = self.Pt(**{f: vals.get(f, zero) for f in self.Pt._fields})
        if not self.aux:
            return dF
        return dF, {k: g(d, Si, Sj, **ch) for k, g in self.aux.items()}


def central_force(Pt, coef, *, fields=(), bilinear=None, aux=None,
                  diag=None, name="central_force"):
    """Declare a central pairwise force.

    ``coef(dist, Si, Sj, **bilinear_channels) -> w`` is the radial
    coefficient (``dF_xyz = w * r``); ``Si``/``Sj`` are dicts of the named
    per-cell scalar ``fields`` for each side.  ``bilinear`` maps a channel
    name to ``(a, b)`` with ``a(X) -> tuple`` / ``b(X) -> tuple`` of
    per-cell columns; the channel delivered to ``coef`` is
    ``sum_k a_k(Xi) * b_k(Xj)``.  ``aux`` maps names to per-pair functions
    with coef's signature, summed over neighbours.  ``diag(Xi) -> Pt``
    supplies the i == j reaction term (ref examples/turing.cu:38-46)."""
    return _CentralForce(Pt, coef, fields, bilinear, aux, diag, name)


def _columns(cf, X, n):
    """Per-cell columns of both sides: positions with padding rows at the
    sentinel (every pair against them is past any cutoff; pad-vs-pad
    pairs only touch pad outputs, which the integrator discards), the
    scalar fields, and the bilinear ``a_k`` / ``b_k`` with their
    arities."""
    n_pad = X.x.shape[0]
    active = torch.arange(n_pad, device=X.x.device) < n
    pos = [torch.where(active, a, CENTRAL_SENTINEL) for a in (X.x, X.y, X.z)]
    S = [getattr(X, f) for f in cf.fields]
    a_cols, b_cols, arities = [], [], []
    for name, (fa, fb) in cf.bilinear.items():
        a, b = fa(X), fb(X)
        if len(a) != len(b):
            raise ValueError(f"bilinear {name!r}: side arity mismatch")
        a_cols += [torch.broadcast_to(v, (n_pad,)) for v in a]
        b_cols += [torch.broadcast_to(v, (n_pad,)) for v in b]
        arities.append(len(a))
    return pos, S, a_cols, b_cols, arities


def _add_diagonal(cf, pw_friction, X, old_v, F, sum_f, sum_v, aux):
    """The i == j terms (``diag`` reaction terms and any friction
    self-term), n-sized and exact, as the JAX wrapper adds them
    (central_mxu.py:291-304): the pair passes exclude the diagonal."""
    if cf.diag is None and not getattr(pw_friction, "self_friction", False):
        return F, sum_f, sum_v, aux
    n_pad = X.x.shape[0]
    ids = torch.arange(n_pad, device=X.x.device)
    rz = type(X)(*(torch.zeros_like(a) for a in X))
    zero = torch.zeros_like(X.x)
    dF_d, aux_d = split_force_output(cf(X, rz, zero, ids, ids))
    F = F + dF_d
    fr_d = pw_friction(X, rz, zero, ids, ids)
    sum_f = sum_f + fr_d
    sum_v = tuple(s + fr_d * v for s, v in zip(sum_v, old_v))
    aux = {k: aux.get(k, 0.0) + aux_d.get(k, 0.0)
           for k in set(aux) | set(aux_d)}
    return F, sum_f, sum_v, aux


def central_pairwise_plain(cf, pw_friction, X, old_v, n):
    """Plain torch version of the central all-pairs pass: the factored
    sums over every column (padding at the sentinel), with the distance
    rounded as the kernel rounds it, ``_I_BLOCK`` rows at a time.
    ``pw_friction`` must carry ``central_coef``.  Returns ``(F, sum_f,
    sum_v, aux)``, all ``[n_pad]``."""
    fr_coef = pw_friction.central_coef
    n_pad = X.x.shape[0]
    dev = X.x.device
    (xc, yc, zc), S, a_cols, b_cols, arities = _columns(cf, X, n)
    names = list(cf.bilinear)
    sums = {k: [] for k in ("x", "y", "z", "sum_f", "vx", "vy", "vz")}
    aux_sums = {k: [] for k in cf.aux}
    jx, jy, jz = xc[None, :], yc[None, :], zc[None, :]
    jids = torch.arange(n_pad, device=dev)[None, :]
    for i0 in range(0, n_pad, _I_BLOCK):
        ib = slice(i0, min(i0 + _I_BLOCK, n_pad))
        ix, iy, iz = xc[ib, None], yc[ib, None], zc[ib, None]
        dx, dy, dz = ix - jx, iy - jy, iz - jz
        d2 = dx * dx + dy * dy + dz * dz
        dist = d2 * torch.rsqrt(torch.clamp(d2, min=1e-12))
        iids = torch.arange(i0, ib.stop, device=dev)[:, None]
        dist = torch.where(iids == jids, CENTRAL_SENTINEL, dist)
        Si = {f: s[ib, None] for f, s in zip(cf.fields, S)}
        Sj = {f: s[None, :] for f, s in zip(cf.fields, S)}
        ch, k = {}, 0
        for name, kb in zip(names, arities):
            ch[name] = sum(a_cols[k + m][ib, None] * b_cols[k + m][None, :]
                           for m in range(kb))
            k += kb
        w = torch.broadcast_to(cf.coef(dist, Si, Sj, **ch), dist.shape)
        f = torch.broadcast_to(fr_coef(dist, Si, Sj), dist.shape)
        sw = w.sum(1)
        for key, xi, xj in (("x", ix, jx), ("y", iy, jy), ("z", iz, jz)):
            sums[key].append(xi[:, 0] * sw - (w * xj).sum(1))
        sums["sum_f"].append(f.sum(1))
        for key, v in (("vx", old_v.x), ("vy", old_v.y), ("vz", old_v.z)):
            sums[key].append((f * v[None, :]).sum(1))
        for key, g in cf.aux.items():
            aux_sums[key].append(torch.broadcast_to(
                g(dist, Si, Sj, **ch), dist.shape).sum(1))
    out = {k: torch.cat(v) for k, v in sums.items()}
    zero = torch.zeros_like(X.x)
    F = cf.Pt(**{f: out[f] if f in ("x", "y", "z") else zero
                 for f in cf.Pt._fields})
    sum_v = (out["vx"], out["vy"], out["vz"])
    aux = {k: torch.cat(v) for k, v in aux_sums.items()}
    return _add_diagonal(cf, pw_friction, X, old_v, F, out["sum_f"], sum_v,
                         aux)


def _kernel_spec(cf, pw_friction, arities):
    functor = getattr(cf, "cuda_functor", None)
    if functor is None or functor[0] not in CENTRAL_FUNCTORS:
        raise ValueError(
            "central pair kernel: the force declares no CUDA functor "
            "(force.cuda_functor) for its coefficient; only coefficients "
            "in csrc/central_pair.cu run on the GPU; "
            "TileEngine(pallas=False, mxu=False), the plain all-pairs "
            "path, runs any force")
    spec, params = CENTRAL_FUNCTORS[functor[0]], functor[1]
    if cf.fields != spec["fields"] or tuple(arities) != spec["arities"]:
        raise ValueError(f"central pair kernel: functor {functor[0]!r} "
                         f"takes fields {spec['fields']} and bilinear "
                         f"arities {spec['arities']}, the force has "
                         f"{cf.fields} and {tuple(arities)}")
    if tuple(cf.aux) != spec["aux"]:
        raise ValueError(f"central pair kernel: functor {functor[0]!r} "
                         f"sums aux channels {spec['aux']}, the force has "
                         f"{tuple(cf.aux)}")
    if pw_friction not in _FRICTION_FLAGS:
        raise ValueError("central pair kernel: only friction_w_neighbour "
                         "and friction_on_background are implemented on "
                         "the GPU")
    return spec, params


def central_plan(n, n_pad, n_aux, sms):
    """Launch plan of the central kernel on a card of ``sms`` streaming
    multiprocessors: ``tile_plan`` with its ``CENTRAL_ROWS`` i-points per
    thread and its partial sums (sum_w, sum_wx y z, sum_f, sum_v x y z and
    the ``n_aux`` aux channels)."""
    return tile_plan(n, n_pad, CENTRAL_ROWS, 8 + n_aux, sms)


def central_pairwise_mxu(cf, pw_friction, X, old_v, n):
    """Central all-pairs wrapper: launches ``csrc/central_pair.cu`` for
    CUDA tensors, runs :func:`central_pairwise_plain` for CPU tensors,
    raises for anything else.  Same contract and returns as
    ``tile_pairwise``.  A launch counts in ``kernels.central_pair``
    (``utils.profiling``)."""
    dev = X.x.device
    if dev.type == "cpu":
        return central_pairwise_plain(cf, pw_friction, X, old_v, n)
    if dev.type != "cuda":
        raise ValueError(f"central pair kernel: unsupported device {dev}")
    from .. import _build
    n_pad = X.x.shape[0]
    n = int(n)
    if not 0 <= n <= n_pad:
        raise ValueError(f"central pair kernel: n {n} outside [0, {n_pad}]")
    f32 = torch.float32
    for f in X._fields:
        require(getattr(X, f), (n_pad,), f32, dev, f"central pair kernel: "
                f"X.{f}")
    for a in old_v:
        require(a, (n_pad,), f32, dev, "central pair kernel: old_v")
    pos, S, a_cols, b_cols, arities = _columns(cf, X, n)
    spec, params = _kernel_spec(cf, pw_friction, arities)
    Ri = torch.stack(pos + S + a_cols)
    Cj = torch.stack(pos + S + b_cols + list(old_v))
    plan = central_plan(n, n_pad, len(spec["aux"]), sm_count(dev))
    part = torch.empty(plan.scratch, dtype=f32, device=dev)
    out = torch.empty((7 + len(spec["aux"]), n_pad), dtype=f32, device=dev)
    ar = (ctypes.c_int * max(len(arities), 1))(*arities)
    lib = _build.library()
    count("kernels.central_pair")
    _build.check(getattr(lib, spec["entry"])(
        Ri.data_ptr(), Cj.data_ptr(), n, n_pad, len(S), len(arities), ar,
        _FRICTION_FLAGS[pw_friction], param_array(spec, params), plan.rows,
        plan.splits, plan.chunk, part.data_ptr(), out.data_ptr(),
        _build.stream_handle(dev)), "central pair kernel")
    zero = torch.zeros_like(X.x)
    vals = {"x": out[0], "y": out[1], "z": out[2]}
    F = cf.Pt(**{f: vals.get(f, zero) for f in cf.Pt._fields})
    aux = {k: out[7 + a] for a, k in enumerate(spec["aux"])}
    return _add_diagonal(cf, pw_friction, X, old_v, F, out[3],
                         (out[4], out[5], out[6]), aux)

