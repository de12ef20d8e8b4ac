"""Plain PyTorch reference of yalla's tutorial model
(``examples/model_features_sequential_addition.cu``): one step of each of
its five parts and the two transitions between parts that change the
cells.

The parts (0 to 4 here): 0 relaxes a mesenchymal ball with friction on
the background only; 1 and 2 are steps with the friction of neighbours
closer than 1; 3 adds the divisions, gated by type and by the step's
neighbour counts; 4 rewires one protrusion a cell normal to the gradient
of w and pulls through them.  Every step is one Heun step of the force
(``:31-69``): three type-dependent ReLU bands (mesenchyme with
mesenchyme, epithelium with epithelium, the mixed pair), the exchange and
decay of w in the mesenchyme where w >= 0, bending between epithelial
cells weighted 0.10, and the counts of epithelial and mesenchymal
neighbours.  After part 0 the surface cells (few mesenchymal neighbours)
become epithelium with radial polarity (:func:`make_epithelium`); after
part 1 w = 1 where x > 1 (:func:`add_source`).

Written from the published model, not from the program: pairs come from
:mod:`perfbench.reference.pairs`, every pair term is evaluated on an
explicit list of ordered pairs and summed with ``index_add_``.  ``dtype``
sets the precision of the whole computation (the configuration states
float32; the benchmark's control runs it in bfloat16).

A state is a dict: ``X`` (field name -> tensor ``[n_pad]``, the fields
of :data:`FIELDS`), ``old_v`` (3 tensors), ``n`` (int), and in part 4
``a`` and ``b`` (the protrusions' ends, int64 ``[m]``, ``a == b`` an
unset protrusion) and ``links_max`` (the protrusion table's capacity).

Where this departs from the published description:

* the randoms are given, not drawn: the rewiring takes a cube (an int in
  [0, 27) a protrusion), a pick and a noise uniform, the divisions a
  uniform and a unit direction a row;
* the random cube of a protrusion is clamped into the grid, where the
  ``.cu`` would read past its ends (no cell of the published run comes
  near them);
* bending is ``bending_force_fast``'s form: the per-cell trigonometry of
  the polarity computed once a pass, zero where ``|sin theta| <=
  1e-10``; the same function as the ``.cu``'s spherical form, rounded
  differently;
* the centre-of-mass drift is summed in float64;
* the epithelium is taken from one Heun pass's mesenchymal neighbours,
  below 20 (the ``.cu`` counts both passes against twice that);
* the divisions are made in row order, the daughters in the rows after
  the last, with the newborn guard ``i < n (1 - rate)`` taken as a
  float32 product; those past the table's last row are dropped, where
  the ``.cu`` asserts ``n < n_max``.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.intercalation_w_gradient import (link_pull,
                                                          polarity_trig, relu)
from perfbench.reference.pairs import cell_pairs, cube_coords

FIELDS = ("x", "y", "z", "w", "theta", "phi", "ctype")
XYZ = ("x", "y", "z")
MESENCHYME, EPITHELIUM = 0.0, 1.0
# the parts by their index (the example's ``part_of``)
RELAX, EPITHELIUM_PART, SOURCE, GROWTH, PROTRUSIONS = range(5)


class Params:
    """The constants of model_features_sequential_addition.cu."""
    r_max = 1.0
    r_min = 0.8
    dt = 0.1
    n_0 = 200
    prots_per_cell = 1
    protrusion_strength = 0.25
    r_protrusion = 2.0
    proliferation_rate = 0.040
    # the grid the protrusions' cubes are drawn on
    protrusion_grid = 32
    # the weight of bending between epithelial cells, the decay of w in
    # the mesenchyme and its exchange with a neighbour
    bending = 0.10
    decay = 0.01
    exchange = 0.4
    # the surface: fewer mesenchymal neighbours than this
    surface_below = 20
    # the source: w = 1 where x exceeds this
    source_x = 1.0
    # the divisions' gates: an epithelial cell's most epithelial and
    # least mesenchymal neighbours
    epi_nbs_max = 14
    mes_nbs_min = 1


def pair_terms(X, P, i, j, dist, p):
    """Per ordered pair (i, j) with ``dist < r_max``: the force on i
    (x, y, z, w, theta, phi), and whether j is epithelial or
    mesenchymal."""
    xi = {f: X[f][i] for f in FIELDS}
    xj = {f: X[f][j] for f in FIELDS}
    r = {f: xi[f] - xj[f] for f in XYZ}
    mes_i = xi["ctype"] == MESENCHYME
    same = xi["ctype"] == xj["ctype"]
    # the bands (:40-48): mesenchyme with mesenchyme, epithelium with
    # epithelium, and the mixed pair
    F_mes = relu(0.7 - dist) * 3 - relu(dist - 0.8)
    F_epi = relu(0.7 - dist) * 2 - relu(dist - 0.8)
    F_mix = relu(0.8 - dist) * 2 - relu(dist - 0.9) * 1.5
    F = torch.where(same, torch.where(mes_i, F_mes, F_epi), F_mix)
    d = torch.where(dist > 0, dist, 1.0)
    out = {f: r[f] * (F / d) for f in XYZ}
    # w flows into a mesenchymal cell of w >= 0 from its neighbours
    takes = mes_i & (xi["w"] >= 0)
    out["w"] = torch.where(takes, -(xi["w"] - xj["w"]) * p.exchange, 0.0)
    # bending between epithelial cells (polarity.cuh:72-94):
    # U = (p_i . r / d)^2 / 2 + (p_j . r / d)^2 / 2
    both = (xi["ctype"] == EPITHELIUM) & (xj["ctype"] == EPITHELIUM)
    pi = {f: P["p" + f][i] for f in XYZ}
    pj = {f: P["p" + f][j] for f in XYZ}
    inv = 1.0 / d
    prodi = (pi["x"] * r["x"] + pi["y"] * r["y"] + pi["z"] * r["z"]) * inv
    prodj = (pj["x"] * r["x"] + pj["y"] * r["y"] + pj["z"] * r["z"]) * inv
    ai, aj = prodi * inv, prodj * inv
    for f in XYZ:
        bend = ai * ai * r[f] - ai * pi[f] + aj * aj * r[f] - aj * pj[f]
        out[f] = out[f] + torch.where(both, p.bending * bend, 0.0)
    # the angular force on i: -prodi times the gradient of p_i . r_hat
    cf, sf, st = P["cf"][i], P["sf"][i], P["st"][i]
    d_theta = (pi["z"] * (cf * r["x"] + sf * r["y"]) - st * r["z"]) * inv
    d_phi = (cf * r["y"] - sf * r["x"]) * inv * P["inv_st"][i]
    out["theta"] = torch.where(both, p.bending * (-prodi * d_theta), 0.0)
    out["phi"] = torch.where(both, p.bending * (-prodi * d_phi), 0.0)
    epi_j = torch.where(xj["ctype"] == EPITHELIUM, 1.0, 0.0)
    mes_j = torch.where(xj["ctype"] == MESENCHYME, 1.0, 0.0)
    return out, epi_j.to(dist.dtype), mes_j.to(dist.dtype)


def derivative(X, old_v, n, part, links, p, dtype):
    """dX of one pass (every field; x, y, z with the protrusions' pull in
    part 4, the friction-weighted mean neighbour velocity but in part 0,
    and the centre-of-mass drift removed; w decaying in the mesenchyme
    where w >= 0), the neighbour counts, and the non-finite flag.
    ``links`` is ``(a, b, n_links)`` or None."""
    n_pad = X["x"].shape[0]
    dev = X["x"].device
    i, j, dist = cell_pairs(X["x"], X["y"], X["z"], n, p.r_max)
    P = polarity_trig(X)
    terms, epi, mes = pair_terms(X, P, i, j, dist, p)

    def total(vals):
        return torch.zeros(n_pad, dtype=dtype, device=dev).index_add_(
            0, i, vals.to(dtype))
    F = {f: total(terms[f]) for f in ("x", "y", "z", "w", "theta", "phi")}
    epi_nbs, mes_nbs = total(epi), total(mes)
    # w decays in the mesenchyme where it is not negative (:33-36)
    decays = (X["ctype"] == MESENCHYME) & (X["w"] >= 0)
    F["w"] = F["w"] + torch.where(decays, -p.decay * X["w"], 0.0)
    if links is not None:
        G = link_pull(X, *links, p, dtype)
        for f in XYZ:
            F[f] = F[f] + G[f]
    if part != RELAX:
        # every pair within reach is closer than 1: a friction of 1 each
        # (friction_w_neighbour); in part 0 the background's alone, which
        # adds no velocity term
        sum_f = total(torch.ones_like(dist))
        inv = torch.where(sum_f > 0,
                          1.0 / torch.where(sum_f > 0, sum_f, 1.0), 0.0)
        for f, v in zip(XYZ, old_v):
            F[f] = F[f] + total(v[j]) * inv
    active = torch.arange(n_pad, device=dev) < n
    dX = {}
    for f in XYZ:
        d = torch.where(active, F[f], 0.0)
        drift = (d.sum(dtype=torch.float64) / n).to(dtype)
        dX[f] = torch.where(active, d - drift, 0.0)
    for f in ("w", "theta", "phi"):
        dX[f] = torch.where(active, F[f], 0.0)
    dX["ctype"] = torch.zeros_like(X["ctype"])
    bad = any(bool((~torch.isfinite(v)).any()) for v in dX.values())
    return dX, epi_nbs, mes_nbs, bad


def heun_step(X, old_v, n, part, links, p, dtype):
    """One Heun step; returns (X', old_v', epi_nbs, mes_nbs, non-finite),
    the counts those of the second pass."""
    dX, _, _, bad1 = derivative(X, old_v, n, part, links, p, dtype)
    X1 = {f: X[f] + dX[f] * p.dt for f in FIELDS}
    dX1, epi, mes, bad2 = derivative(X1, old_v, n, part, links, p, dtype)
    X_new = {f: X[f] + (dX[f] + dX1[f]) * (0.5 * p.dt) for f in FIELDS}
    old_v_new = [(dX[f] + dX1[f]) * 0.5 for f in XYZ]
    return X_new, old_v_new, epi, mes, bad1 or bad2


def rewire(X, n, a, b, n_links, draws, p):
    """The protrusions after one rewiring (``:109-155``): protrusion ``k``
    (below ``n_links``) belongs to cell ``k / prots_per_cell`` and
    proposes a random cell of a random one of the 27 cubes around its
    cell's, on a grid of ``protrusion_grid`` cubes of ``r_protrusion``
    (cubes of cell ids sorted in row order, ``floor(u * count)`` picks).
    It takes the proposal where both cells are mesenchymal, differ and lie
    within ``r_protrusion``, and the protrusion is unset or the pair lies
    more normal to w's gradient than the old one (``|dw / d|`` below the
    old's times ``1 - noise``)."""
    pick_cube, u, noise = draws
    n_pad = X["x"].shape[0]
    dev = a.device
    g = p.protrusion_grid
    cx, cy, cz = (cube_coords(X[f], p.r_protrusion, g) for f in XYZ)
    rows = torch.arange(n_pad, device=dev)
    cid = torch.where(rows < n, cx + (cy + cz * g) * g, g ** 3)
    order = torch.sort(cid, stable=True)[1]
    per_cube = torch.bincount(cid, minlength=g ** 3 + 1)
    start = torch.cumsum(per_cube, 0) - per_cube
    k = torch.arange(a.shape[0], device=dev)
    src = torch.clamp(((k + 0.5) / p.prots_per_cell).to(torch.int64),
                      max=n_pad - 1)
    off = ((pick_cube // 9 - 1) * g * g + (pick_cube // 3 % 3 - 1) * g
           + (pick_cube % 3 - 1))
    cube = torch.clamp(cid[src] + off, 0, g ** 3 - 1)
    count = per_cube[cube]
    slot = start[cube] + torch.minimum((u * count).to(torch.int64),
                                       torch.clamp(count - 1, min=0))
    cand = order[torch.clamp(slot, max=n_pad - 1)]

    def dist(s, t):
        return torch.sqrt((X["x"][s] - X["x"][t]) ** 2
                          + (X["y"][s] - X["y"][t]) ** 2
                          + (X["z"][s] - X["z"][t]) ** 2)

    def safe(d):
        return torch.where(d > 0, d, 1.0)
    w = X["w"]
    nd, od = dist(src, cand), dist(a, b)
    normal_to_w = (torch.abs((w[src] - w[cand]) / safe(nd))
                   < torch.abs((w[a] - w[b]) / safe(od)) * (1.0 - noise))
    both_mes = (X["ctype"][src] == MESENCHYME) & \
        (X["ctype"][cand] == MESENCHYME)
    take = ((k < n_links) & (count >= 1) & both_mes & (src != cand)
            & (nd <= p.r_protrusion) & (src < n) & ((a == b) | normal_to_w))
    return torch.where(take, src, a), torch.where(take, cand, b)


def divide(X, old_v, n, epi_nbs, mes_nbs, rnd, direction, p):
    """The divisions (``:71-106``): a mesenchymal cell divides where its
    uniform is at most ``proliferation_rate``, an epithelial one with at
    most 14 epithelial and at least one mesenchymal neighbour where it is
    at most twice that (rows below ``n (1 - rate)`` only, the newborn
    guard).  A dividing mesenchymal cell halves w on both sides; the
    daughter sits ``r_min / 4`` from its parent along its direction and
    takes its old_v.  The first wanted divisions in row order are made
    while rows are left; the rest are dropped.  Returns (X, old_v, n, the
    parents' rows)."""
    n_pad = X["x"].shape[0]
    rows = torch.arange(n_pad, device=X["x"].device)
    rate = p.proliferation_rate
    guard = rows < int(np.float32(n) * np.float32(1 - rate))
    mes = X["ctype"] == MESENCHYME
    epi = X["ctype"] == EPITHELIUM
    mes_ok = mes & (rnd <= rate)
    epi_ok = (epi & (epi_nbs <= p.epi_nbs_max) & (mes_nbs >= p.mes_nbs_min)
              & (rnd <= 2 * rate))
    want = guard & (mes_ok | epi_ok) & (rows < n)
    parents = torch.nonzero(want).squeeze(1)[:n_pad - n]
    k = parents.numel()
    X_out = dict(X)
    halve = torch.zeros_like(want)
    halve[parents] = True
    X_out["w"] = torch.where(halve & mes, X["w"] / 2, X["w"])
    new = slice(n, n + k)
    for f in FIELDS:
        v = X_out[f].clone()
        v[new] = v[parents]
        X_out[f] = v
    for f, d in zip(XYZ, direction):
        X_out[f][new] = X_out[f][new] + p.r_min / 4 * d[parents]
    v_out = []
    for v in old_v:
        v = v.clone()
        v[new] = v[parents]
        v_out.append(v)
    return X_out, v_out, n + k, parents


def make_epithelium(X, mes_nbs, p=Params()):
    """Part 1's start (``:201-215``): of the first ``n_0`` rows, those
    with fewer than ``surface_below`` mesenchymal neighbours become
    epithelium, their polarity pointing away from the origin."""
    n_pad = X["x"].shape[0]
    x, y, z = X["x"], X["y"], X["z"]
    surf = (mes_nbs < p.surface_below) & \
        (torch.arange(n_pad, device=x.device) < p.n_0)
    d = torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-6)
    out = dict(X)
    out["ctype"] = torch.where(surf, EPITHELIUM, X["ctype"]).to(x.dtype)
    out["theta"] = torch.where(surf, torch.arccos(torch.clamp(z / d, -1, 1)),
                               X["theta"])
    out["phi"] = torch.where(surf, torch.atan2(y, x), X["phi"])
    return out


def add_source(X, n, p=Params()):
    """Part 2's start: w = 1 in the live cells with x above
    ``source_x``."""
    rows = torch.arange(X["x"].shape[0], device=X["x"].device)
    out = dict(X)
    out["w"] = torch.where((X["x"] > p.source_x) & (rows < n), 1.0,
                           X["w"]).to(X["w"].dtype)
    return out


def step(state, part, link_draws=None, growth_draws=None,
         dtype=torch.float32, p=Params()):
    """One step of ``part`` from ``state`` with its draws: ``link_draws``
    (cube, pick, noise a protrusion; part 4) and ``growth_draws`` (``(rnd,
    (dx, dy, dz))`` a row; part 3).  Returns the state after it, with the
    step's neighbour counts (``epi_nbs``, ``mes_nbs``: the Heun step's
    second pass), ``parents`` and ``non_finite``."""
    # no matrix product runs here; TF32 stays off all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cast(v):
        return v.to(dtype)
    X = {f: cast(state["X"][f]) for f in FIELDS}
    old_v = [cast(v) for v in state["old_v"]]
    n = int(state["n"])
    out = {}
    links = None
    if part == PROTRUSIONS:
        n_links = min(n * p.prots_per_cell, int(state["links_max"]))
        pick_cube, u, noise = link_draws
        a, b = rewire(X, n, state["a"], state["b"], n_links,
                      (pick_cube, cast(u), cast(noise)), p)
        out.update(a=a, b=b)
        links = (a, b, n_links)
    X, old_v, epi, mes, bad = heun_step(X, old_v, n, part, links, p, dtype)
    parents = torch.zeros(0, dtype=torch.int64, device=epi.device)
    if part == GROWTH:
        rnd, direction = growth_draws
        X, old_v, n, parents = divide(X, old_v, n, epi, mes, cast(rnd),
                                      [cast(d) for d in direction], p)
    out.update(X=X, old_v=old_v, n=n, epi_nbs=epi, mes_nbs=mes,
               parents=parents, non_finite=bad)
    return out
