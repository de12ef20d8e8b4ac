"""Plain PyTorch reference of one step of yalla's intercalation_w_gradient
example (``examples/intercalation_w_gradient.cu``): the protrusions
rewired on the gradients of the two morphogens (``:120-173``), one Heun
step of the type-dependent ReLU band, the morphogens' diffusion and
decay, epithelial bending (``:31-68``) and the protrusions' constant pull
(``links.cuh:99-140``), with the friction of neighbours closer than 1,
then the divisions of the epithelium (``:70-118``).

Written from the published model, not from the program: pairs come from
:mod:`perfbench.reference.pairs`, every pair term is evaluated on an
explicit list of ordered pairs and summed with ``index_add_``.  ``dtype``
sets the precision of the whole computation (the configuration states
float32; the benchmark's control runs it in bfloat16).

A state is a dict: ``X`` (field name -> tensor ``[n_pad]``, the fields
of :data:`FIELDS`), ``old_v`` (3 tensors), ``n`` (int), ``a`` and ``b``
(the protrusions' ends, int64 ``[m]``, ``a == b`` an unset protrusion)
and ``links_max`` (the protrusion table's capacity).

Where this departs from the published description:

* the randoms are given, not drawn: a step takes the rewiring's cube (an
  int in [0, 27) a protrusion), its pick and its noise uniform, and the
  divisions' uniform and unit direction a row;
* the random cube of a protrusion is clamped into the grid, where the
  ``.cu`` would read past its ends (no cell of the published run comes
  near them);
* bending is ``bending_force_fast``'s form: ``p_j`` eliminated as ``p_i -
  (p_i - p_j)``, the per-cell trigonometry of ``p_i`` (the unit vector,
  cos and sin of phi, the signed sin theta and its inverse, zero where
  ``|sin theta| <= 1e-10``) computed once a pass; the same function as
  the ``.cu``'s spherical form, rounded differently;
* the centre-of-mass drift is summed in float64;
* every wanted division is made, the daughters in the rows after the
  last in the order of their parents' rows (yalla's ``atomicAdd`` hands
  rows out in any order), with the newborn guard ``i < n (1 - rate)``
  taken as a float32 product; yalla asserts ``n_max``, which raises here.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.pairs import cell_pairs, cube_coords

FIELDS = ("x", "y", "z", "w", "f", "theta", "phi", "ctype")
XYZ = ("x", "y", "z")
MESENCHYME, EPITHELIUM = 0.0, 1.0


class Params:
    """The constants of intercalation_w_gradient.cu."""
    r_max = 1.0
    r_min = 0.8
    dt = 0.1
    prots_per_cell = 1
    protrusion_strength = 0.2
    r_protrusion = 2.0
    mean_proliferation_rate = 0.015
    # the grid the protrusions' cubes are drawn on
    protrusion_grid = 32
    # the weight of bending between epithelial cells, the morphogens'
    # decay in the mesenchyme and their exchange with a neighbour
    bending = 0.15
    decay = 0.01
    exchange = 0.1


def relu(a):
    return torch.clamp(a, min=0.0)


def polarity_trig(X):
    """Per cell: the unit polarity (px, py, pz), cos and sin of phi, the
    signed sin theta and its inverse (zero where ``|sin theta| <=
    1e-10``)."""
    th, ph = X["theta"], X["phi"]
    cf, sf, st = torch.cos(ph), torch.sin(ph), torch.sin(th)
    safe = torch.abs(st) > 1e-10
    inv_st = torch.where(safe, 1.0 / torch.where(safe, st, 1.0), 0.0)
    return {"px": st * cf, "py": st * sf, "pz": torch.cos(th), "cf": cf,
            "sf": sf, "st": st, "inv_st": inv_st}


def pair_terms(X, P, i, j, dist, p):
    """Per ordered pair (i, j) with ``dist < r_max``: the force on i
    (x, y, z, w, f, theta, phi), and whether j is epithelial or
    mesenchymal."""
    xi = {f: X[f][i] for f in FIELDS}
    xj = {f: X[f][j] for f in FIELDS}
    r = {f: xi[f] - xj[f] for f in XYZ}
    mes_i = xi["ctype"] == MESENCHYME
    same = xi["ctype"] == xj["ctype"]
    # the band: mesenchyme with mesenchyme, epithelium with epithelium,
    # and the mixed pair (:42-50)
    F_mes = relu(0.8 - dist) * 2 - relu(dist - 0.8)
    F_epi = relu(0.8 - dist) * 2 - relu(dist - 0.8) * 2
    F_mix = relu(0.9 - dist) * 2 - relu(dist - 0.9) * 2
    F = torch.where(same, torch.where(mes_i, F_mes, F_epi), F_mix)
    d = torch.where(dist > 0, dist, 1.0)
    out = {f: r[f] * (F / d) for f in XYZ}
    # w and f flow into a mesenchymal cell from its neighbours (:51-55)
    for m in ("w", "f"):
        out[m] = torch.where(mes_i, -(xi[m] - xj[m]) * p.exchange, 0.0)
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


def link_pull(X, a, b, n_links, p, dtype):
    """The protrusions' constant pull (``links.cuh:99-111``): a set
    protrusion (a row below ``n_links`` with ``a != b``) pulls its ends
    together with ``protrusion_strength`` along the unit vector."""
    n_pad = X["x"].shape[0]
    dev = X["x"].device
    live = (torch.arange(a.shape[0], device=dev) < n_links) & (a != b)
    ia, ib = a[live], b[live]
    r = {f: X[f][ia] - X[f][ib] for f in XYZ}
    dist = torch.sqrt(r["x"] * r["x"] + r["y"] * r["y"] + r["z"] * r["z"])
    safe = torch.where(dist > 0, dist, 1.0)
    G = {}
    for f in XYZ:
        pull = p.protrusion_strength * r[f] / safe
        G[f] = torch.zeros(n_pad, dtype=dtype, device=dev).index_add_(
            0, ia, -pull).index_add_(0, ib, pull)
    return G


def derivative(X, old_v, n, a, b, n_links, p, dtype):
    """dX of one pass (every field; x, y, z with the protrusions' pull,
    the friction-weighted mean neighbour velocity and the centre-of-mass
    drift removed; w and f decaying in the mesenchyme), the neighbour
    counts, and the non-finite flag."""
    n_pad = X["x"].shape[0]
    dev = X["x"].device
    i, j, dist = cell_pairs(X["x"], X["y"], X["z"], n, p.r_max)
    P = polarity_trig(X)
    terms, epi, mes = pair_terms(X, P, i, j, dist, p)

    def total(vals):
        return torch.zeros(n_pad, dtype=dtype, device=dev).index_add_(
            0, i, vals.to(dtype))
    F = {f: total(terms[f]) for f in ("x", "y", "z", "w", "f", "theta",
                                      "phi")}
    # every pair within reach is closer than 1: a friction of 1 each
    # (the default friction_w_neighbour)
    friction = torch.ones_like(dist)
    sum_f = total(friction)
    sum_v = [total(friction * v[j]) for v in old_v]
    epi_nbs, mes_nbs = total(epi), total(mes)
    # the morphogens decay in the mesenchyme (:34-41)
    mes_cell = X["ctype"] == MESENCHYME
    for m in ("w", "f"):
        F[m] = F[m] + torch.where(mes_cell, -p.decay * X[m], 0.0)
    G = link_pull(X, a, b, n_links, p, dtype)
    active = torch.arange(n_pad, device=dev) < n
    inv = torch.where(sum_f > 0, 1.0 / torch.where(sum_f > 0, sum_f, 1.0),
                      0.0)
    dX = {}
    for c, f in enumerate(XYZ):
        d = torch.where(active, F[f] + G[f] + sum_v[c] * inv, 0.0)
        drift = (d.sum(dtype=torch.float64) / n).to(dtype)
        dX[f] = torch.where(active, d - drift, 0.0)
    for f in ("w", "f", "theta", "phi"):
        dX[f] = torch.where(active, F[f], 0.0)
    dX["ctype"] = torch.zeros_like(X["ctype"])
    bad = any(bool((~torch.isfinite(v)).any()) for v in dX.values())
    return dX, epi_nbs, mes_nbs, bad


def heun_step(X, old_v, n, a, b, n_links, p, dtype):
    """One Heun step; returns (X', old_v', epi_nbs, mes_nbs, non-finite),
    the counts those of the second pass."""
    dX, _, _, bad1 = derivative(X, old_v, n, a, b, n_links, p, dtype)
    X1 = {f: X[f] + dX[f] * p.dt for f in FIELDS}
    dX1, epi, mes, bad2 = derivative(X1, old_v, n, a, b, n_links, p, dtype)
    X_new = {f: X[f] + (dX[f] + dX1[f]) * (0.5 * p.dt) for f in FIELDS}
    old_v_new = [(dX[f] + dX1[f]) * 0.5 for f in XYZ]
    return X_new, old_v_new, epi, mes, bad1 or bad2


def rewire(X, n, a, b, n_links, draws, p):
    """The protrusions after one rewiring (``:120-173``): protrusion ``k``
    (below ``n_links``) belongs to cell ``k / prots_per_cell`` and
    proposes a random cell of a random one of the 27 cubes around its
    cell's, on a grid of ``protrusion_grid`` cubes of ``r_protrusion``
    (cubes of cell ids sorted in row order, ``floor(u * count)`` picks).
    It takes the proposal where both cells are mesenchymal, differ and lie
    within ``r_protrusion``, and the protrusion is unset, or the pair is
    superficial (``w_src + w_cand > 0.3``) and lies more normal to f's
    gradient than the old one (``|df / d|`` below the old's times ``1 -
    noise``), or deep and more along w's (``|dw / d|`` above)."""
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
    w, f = X["w"], X["f"]
    nd, od = dist(src, cand), dist(a, b)
    superficial = w[src] + w[cand] > 0.3
    keep = 1.0 - noise
    normal_to_f = superficial & (torch.abs((f[src] - f[cand]) / safe(nd))
                                 < torch.abs((f[a] - f[b]) / safe(od))
                                 * keep)
    along_w = ~superficial & (torch.abs((w[src] - w[cand]) / safe(nd))
                              > torch.abs((w[a] - w[b]) / safe(od)) * keep)
    both_mes = (X["ctype"][src] == MESENCHYME) & \
        (X["ctype"][cand] == MESENCHYME)
    take = ((k < n_links) & (count >= 1) & both_mes & (src != cand)
            & (nd <= p.r_protrusion) & (src < n)
            & ((a == b) | normal_to_f | along_w))
    return torch.where(take, src, a), torch.where(take, cand, b)


def divide(X, old_v, n, epi_nbs, mes_nbs, rnd, direction, p):
    """The divisions (``:70-118``): an epithelial cell with at most 7
    epithelial and at least one mesenchymal neighbour divides where its
    uniform is at most ``mean_proliferation_rate`` (rows below ``n (1 -
    rate)`` only, the newborn guard).  A dividing mesenchymal cell would
    halve w and f on both sides; the daughter sits ``r_min / 4`` from its
    parent along its direction and takes its old_v.  Returns (X, old_v,
    n, the parents' rows)."""
    n_pad = X["x"].shape[0]
    rows = torch.arange(n_pad, device=X["x"].device)
    rate = p.mean_proliferation_rate
    guard = rows < int(np.float32(n) * np.float32(1 - rate))
    want = (guard & (X["ctype"] == EPITHELIUM) & (epi_nbs <= 7)
            & (mes_nbs >= 1) & (rnd <= rate) & (rows < n))
    parents = torch.nonzero(want).squeeze(1)
    k = parents.numel()
    if n + k > n_pad:
        raise ValueError(f"{n + k} cells overflow {n_pad} rows")
    X_out = dict(X)
    mes = want & (X["ctype"] == MESENCHYME)
    for m in ("w", "f"):
        X_out[m] = torch.where(mes, X[m] / 2, X[m])
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


def step(state, link_draws, growth_draws, dtype=torch.float32,
         p=Params()):
    """One step from ``state`` with its draws: ``link_draws`` (cube,
    pick, noise a protrusion) and ``growth_draws`` (``(rnd, (dx, dy,
    dz))`` a row).  Returns the state after it, with the step's
    neighbour counts (``epi_nbs``, ``mes_nbs``: the Heun step's second
    pass), ``parents`` and ``non_finite``."""
    # no matrix product runs here; TF32 stays off all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cast(v):
        return v.to(dtype)
    X = {f: cast(state["X"][f]) for f in FIELDS}
    old_v = [cast(v) for v in state["old_v"]]
    n = int(state["n"])
    n_links = min(n * p.prots_per_cell, int(state["links_max"]))
    pick_cube, u, noise = link_draws
    a, b = rewire(X, n, state["a"], state["b"], n_links,
                  (pick_cube, cast(u), cast(noise)), p)
    X, old_v, epi, mes, bad = heun_step(X, old_v, n, a, b, n_links, p,
                                        dtype)
    rnd, direction = growth_draws
    X, old_v, n, parents = divide(X, old_v, n, epi, mes, cast(rnd),
                                  [cast(d) for d in direction], p)
    return {"X": X, "old_v": old_v, "n": n, "a": a, "b": b,
            "epi_nbs": epi, "mes_nbs": mes, "parents": parents,
            "non_finite": bad}
