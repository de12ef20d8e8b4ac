"""Plain PyTorch reference of the branching flagship's frame
(yalla ``examples/branching.cu``): ``substeps`` times (a division pass,
then one Heun step of the type-dependent mechanics, Meinhardt kinetics on
the epithelium, diffusion and epithelial bending).

Written from the published model, not from the program: pairs come from
:mod:`perfbench.reference.pairs`, every pair term is evaluated on an
explicit list of ordered pairs and summed with ``index_add_``, bending in
the spherical form of yalla's ``polarity.cuh``.  ``dtype`` sets the
precision of the whole computation (the configuration states float32;
the benchmark's control runs it in bfloat16).

A state is a dict: ``X`` (field name -> tensor ``[n_pad]``, the fields
of :data:`FIELDS`), ``old_v`` (3 tensors), ``n`` (int), ``epi_nbs`` and
``mes_nbs`` (the neighbour counts of the last pass, ``[n_pad]``).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.pairs import cell_pairs

FIELDS = ("x", "y", "z", "theta", "phi", "u", "v", "ctype")
XYZ = ("x", "y", "z")


class Params:
    """``Params()`` of branching.cu."""
    r_max = 1.0
    dt = 0.2
    lam = 0.0075
    D_u = 0.001
    D_v = 0.2
    f_v = 1.0
    f_u = 80.0
    g_u = 80.0
    m_u = 0.25
    m_v = 0.75
    s_u = 0.05
    epi_proliferation_rate = 0.2
    mes_proliferation_rate = 0.1
    prolif_threshold = 1150.0
    mean_distance = 0.75


def relu(a):
    return torch.clamp(a, min=0.0)


def unit(theta, phi):
    """The polarity vector of spherical angles."""
    st = torch.sin(theta)
    return st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)


def pair_terms(X, i, j, dist, p):
    """Per ordered pair (i, j) with ``dist < r_max``: the force on i
    (x, y, z, theta, phi, u, v), the friction and the epithelial count."""
    xi = {f: X[f][i] for f in FIELDS}
    xj = {f: X[f][j] for f in FIELDS}
    r = {f: xi[f] - xj[f] for f in XYZ}
    epi_i, epi_j = xi["ctype"] == 1.0, xj["ctype"] == 1.0
    both = epi_i & epi_j
    # type-dependent ReLU band (branching.cu:82-87): one band between
    # cells of one type, another between the types
    F_same = relu(0.7 - dist) * 2 - relu(dist - 0.8)
    F_diff = relu(0.8 - dist) * 2 - relu(dist - 0.9)
    F = torch.where(xi["ctype"] == xj["ctype"], F_same, F_diff)
    w = torch.where(dist > 0, F / torch.where(dist > 0, dist, 1.0), 0.0)
    out = {f: r[f] * w for f in XYZ}
    # diffusion between epithelial cells; v leaks into the mesenchyme
    # (branching.cu:91-103)
    du = torch.where(both, -p.D_u * (xi["u"] - xj["u"]), 0.0)
    out["u"] = torch.where(-du > xi["u"], 0.0, du)
    dv = -p.D_v * (xi["v"] - xj["v"])
    out["v"] = torch.where(both & (-dv > xi["v"]), 0.0, dv)
    # epithelial bending (polarity.cuh:72-94): U = (p_i . r / d)^2 / 2 +
    # (p_j . r / d)^2 / 2, positional force and the angular force on i
    pix, piy, piz = unit(xi["theta"], xi["phi"])
    pjx, pjy, pjz = unit(xj["theta"], xj["phi"])
    d = torch.where(dist > 0, dist, 1.0)
    prodi = (pix * r["x"] + piy * r["y"] + piz * r["z"]) / d
    prodj = (pjx * r["x"] + pjy * r["y"] + pjz * r["z"]) / d
    for f, pi_, pj_ in (("x", pix, pjx), ("y", piy, pjy), ("z", piz, pjz)):
        bend = (-prodi / d * pi_ + prodi * prodi / (d * d) * r[f]
                - prodj / d * pj_ + prodj * prodj / (d * d) * r[f])
        out[f] = out[f] + torch.where(both, 0.2 * bend, 0.0)
    th_r = torch.arccos(torch.clamp(r["z"] / d, -1.0, 1.0))
    ph_r = torch.atan2(r["y"], r["x"])
    th, ph = xi["theta"], xi["phi"]
    d_theta = (torch.cos(th) * torch.sin(th_r) * torch.cos(ph - ph_r)
               - torch.sin(th) * torch.cos(th_r))
    st = torch.sin(th)
    safe = torch.abs(st) > 1e-10
    d_phi = torch.where(safe, -torch.sin(th_r) * torch.sin(ph - ph_r)
                        / torch.where(safe, st, 1.0), 0.0)
    out["theta"] = torch.where(both, 0.2 * (-prodi) * d_theta, 0.0)
    out["phi"] = torch.where(both, 0.2 * (-prodi) * d_phi, 0.0)
    friction = torch.ones_like(dist)
    epi_count = torch.where(epi_j, 1.0, 0.0).to(dist.dtype)
    return out, friction, epi_count


def derivative(X, old_v, n, p, dtype):
    """dX of one pass (every field; x, y, z with the friction-weighted mean
    neighbour velocity and the centre-of-mass drift removed), the
    neighbour counts, and the non-finite flag."""
    n_pad = X["x"].shape[0]
    dev = X["x"].device
    i, j, dist = cell_pairs(X["x"], X["y"], X["z"], n, p.r_max)
    terms, friction, epi = pair_terms(X, i, j, dist, p)

    def total(vals):
        return torch.zeros(n_pad, dtype=dtype, device=dev).index_add_(
            0, i, vals.to(dtype))
    F = {f: total(terms[f]) for f in ("x", "y", "z", "theta", "phi", "u",
                                      "v")}
    sum_f = total(friction)
    sum_v = [total(friction * old_v[c][j]) for c in range(3)]
    epi_nbs = total(epi)
    # Meinhardt kinetics on the epithelium (branching.cu:66-77)
    u, v = X["u"], X["v"]
    du = p.lam * ((p.f_u * u * u) / (1 + p.f_v * v) - p.m_u * u + p.s_u)
    dv = p.lam * (p.g_u * u * u - p.m_v * v)
    epi_cell = X["ctype"] == 1.0
    F["u"] = F["u"] + torch.where(epi_cell & ~(-du > u), du, 0.0)
    F["v"] = F["v"] + torch.where(epi_cell & ~(-dv > v), dv, 0.0)
    active = torch.arange(n_pad, device=dev) < n
    inv = torch.where(sum_f > 0, 1.0 / torch.where(sum_f > 0, sum_f, 1.0),
                      0.0)
    dX = {}
    for c, f in enumerate(XYZ):
        a = torch.where(active, F[f] + sum_v[c] * inv, 0.0)
        drift = (a.sum(dtype=torch.float64) / n).to(dtype)
        dX[f] = torch.where(active, a - drift, 0.0)
    for f in ("theta", "phi", "u", "v"):
        dX[f] = torch.where(active, F[f], 0.0)
    dX["ctype"] = torch.zeros_like(X["ctype"])
    bad = any(bool((~torch.isfinite(a)).any()) for a in dX.values())
    return dX, epi_nbs, sum_f - epi_nbs, bad


def heun_step(X, old_v, n, p, dtype):
    """One Heun step; returns (X', old_v', epi_nbs, mes_nbs, non-finite),
    the counts those of the second pass."""
    dX, _, _, bad1 = derivative(X, old_v, n, p, dtype)
    X1 = {f: X[f] + dX[f] * p.dt for f in FIELDS}
    dX1, epi, mes, bad2 = derivative(X1, old_v, n, p, dtype)
    X_new = {f: X[f] + (dX[f] + dX1[f]) * (0.5 * p.dt) for f in FIELDS}
    old_v_new = [(dX[f] + dX1[f]) * 0.5 for f in XYZ]
    return X_new, old_v_new, epi, mes, bad1 or bad2


def divide(state, rnd, direction, p):
    """One division pass (branching.cu:113-170): a cell divides where the
    gates pass, its daughter takes the next free row in the order of
    their parents' rows; u and v halve on both; the daughter sits
    ``mean_distance / 4`` from its parent along ``direction``."""
    X, n = state["X"], state["n"]
    n_pad = X["x"].shape[0]
    i = torch.arange(n_pad, device=X["x"].device)
    # the newborn guard, n * (1 - rate) as a float product
    guard = i < int(np.float32(n)
                    * np.float32(1 - p.epi_proliferation_rate))
    mes_ok = ((X["ctype"] == 0.0) & (X["v"] >= p.prolif_threshold)
              & (rnd <= p.mes_proliferation_rate))
    epi_ok = ((X["ctype"] == 1.0) & (state["epi_nbs"] <= 5)
              & (state["mes_nbs"] > 0)
              & (rnd <= p.epi_proliferation_rate))
    want = guard & (mes_ok | epi_ok) & (i < n)
    parents = torch.nonzero(want).squeeze(1)
    k = parents.numel()
    if n + k > n_pad:
        raise ValueError(f"{n + k} cells overflow {n_pad} rows")
    X = dict(X)
    for f in ("u", "v"):
        X[f] = torch.where(want, X[f] / 2, X[f])
    rows = slice(n, n + k)
    for f in FIELDS:
        a = X[f].clone()
        a[rows] = a[parents]
        X[f] = a
    off = p.mean_distance / 4
    for f, d in zip(XYZ, direction):
        X[f][rows] = X[f][rows] + off * d[parents]

    def inherit(a):
        a = a.clone()
        a[rows] = a[parents]
        return a
    return {"X": X, "old_v": [inherit(a) for a in state["old_v"]],
            "n": n + k, "epi_nbs": inherit(state["epi_nbs"]),
            "mes_nbs": inherit(state["mes_nbs"])}, parents


def substep(state, rnd, direction, dtype=torch.float32, p=Params()):
    """One substep from ``state`` (a division pass with the draws ``rnd``
    and ``direction``, then a Heun step): returns the state after it,
    with ``parents`` (the rows that divided, in the order of their
    daughters' rows) and ``non_finite``."""
    def cast(a):
        return a.to(dtype)
    st = {"X": {f: cast(state["X"][f]) for f in FIELDS},
          "old_v": [cast(a) for a in state["old_v"]], "n": int(state["n"]),
          "epi_nbs": cast(state["epi_nbs"]),
          "mes_nbs": cast(state["mes_nbs"])}
    st, parents = divide(st, cast(rnd), [cast(d) for d in direction], p)
    X, old_v, epi, mes, bad = heun_step(st["X"], st["old_v"], st["n"], p,
                                        dtype)
    return {"X": X, "old_v": old_v, "n": st["n"], "epi_nbs": epi,
            "mes_nbs": mes, "parents": parents, "non_finite": bad}
