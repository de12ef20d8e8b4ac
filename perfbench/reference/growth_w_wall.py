"""Plain PyTorch reference of one step of yalla's growth_w_wall example
(``examples/growth_w_wall.cu``): the protrusions rewired
(``growth_w_wall.cu:90-136``), one Heun step of the ReLU band between
cells on the Gabriel graph (``Gabriel_computer``, ``solvers.cuh:604-644``)
with the wall's friction, the wall's point-to-plane band and the
protrusions' constant pull (``links.cuh:99-228``), then the divisions
(``growth_w_wall.cu:68-88``).

Written from the published model, not from the program: pairs come from
every pair of cells, in blocks of rows; every pair term is evaluated on an
explicit list of pairs and summed with ``index_add_``.  ``dtype`` sets the
precision of the whole computation (the configuration states float32; the
benchmark's control runs it in bfloat16).

A state is a dict: ``X`` (``x``, ``y``, ``z``: tensors ``[n_pad]``),
``old_v`` (3 tensors), ``n`` (int), ``a`` and ``b`` (the protrusions'
ends, int64 ``[m]``, ``a == b`` an unset protrusion) and ``links_max``
(the protrusion table's capacity).

Where this departs from the published description:

* the randoms are given, not drawn: a step takes the rewiring's cube
  (an int in [0, 27) a protrusion), its pick and its update uniforms, and
  the divisions' uniform and unit direction a row;
* the random cube of a protrusion is clamped into the grid, where
  ``growth_w_wall.cu`` would read past its ends (no cell of the published
  run comes near them);
* the Gabriel test takes every candidate in reach, where yalla keeps the
  first 100 (it overruns its array past them); the program flags more
  than its ``max_candidates``;
* the centre-of-mass drift is summed in float64;
* every wanted division is made, the daughters in the rows after the
  last in the order of their parents' rows (yalla's ``atomicAdd`` hands
  rows out in any order); yalla asserts ``n_max``, which raises here.
"""
from __future__ import annotations

import torch

from perfbench.reference.pairs import cube_coords

XYZ = ("x", "y", "z")
# the wall node's row
WALL = 0
# rows of one block of the all-pairs search and of the Gabriel test
BLOCK = 512


class Params:
    """The constants of growth_w_wall.cu (and the Gabriel engine's)."""
    r_max = 1.0
    mean_dist = 0.75
    r_protrusion = 1.0
    protrusion_strength = 0.15
    prots_per_cell = 1
    dt = 0.1
    update_prob = 0.5
    prolif_rate = 0.005
    # the grid the protrusions' cubes are drawn on
    protrusion_grid = 50
    # the Gabriel engine's cutoff (the solution's cube size) and its
    # coefficient
    cutoff = 1.0
    gabriel_coefficient = 0.8


def relu(a):
    return torch.clamp(a, min=0.0)


def sq3(dx, dy, dz):
    """``dx^2 + dy^2 + dz^2``, each product and sum rounded in turn."""
    return dx * dx + dy * dy + dz * dz


def near_pairs(X, n, cutoff):
    """``(i, j, d2)``: every ordered pair of distinct rows ``i, j < n``
    with ``sqrt(d2) < cutoff``, ``d2 = |X_i - X_j|^2``, sorted by ``i``
    then ``j``; from all pairs, ``BLOCK`` rows ``i`` at a time."""
    x, y, z = (X[f][:n] for f in XYZ)
    rows = torch.arange(n, device=x.device)
    out_i, out_j, out_d2 = [], [], []
    for lo in range(0, n, BLOCK):
        i = rows[lo:lo + BLOCK]
        d2 = sq3(x[i, None] - x[None], y[i, None] - y[None],
                 z[i, None] - z[None])
        hit = (torch.sqrt(d2) < cutoff) & (i[:, None] != rows[None])
        bi, bj = torch.nonzero(hit, as_tuple=True)
        out_i.append(i[bi])
        out_j.append(bj)
        out_d2.append(d2[bi, bj])
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_d2)


def gabriel_pairs(X, n, p):
    """``(i, j, d2)`` of the pairs the Gabriel graph keeps
    (``solvers.cuh:572-597``): a candidate ``j`` of ``i`` (a cell within
    ``cutoff``) is kept if ``d2 < cutoff^2`` and no other candidate ``k``
    of ``i`` lies in the sphere of radius ``gabriel_coefficient * d / 2``
    about the midpoint of ``i`` and ``j``.  (Such a ``k`` is closer to
    ``i`` than ``j`` for a coefficient below 1, so this is yalla's test
    against the closer candidates.)"""
    i, j, d2 = near_pairs(X, n, p.cutoff)
    dt = d2.dtype
    cut2 = torch.tensor(p.cutoff * p.cutoff, dtype=dt, device=d2.device)
    gc2 = torch.tensor((0.5 * p.gabriel_coefficient) ** 2, dtype=dt,
                       device=d2.device)
    counts = torch.bincount(i, minlength=n)
    K = int(counts.max()) if i.numel() else 0
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(i.numel(), device=i.device) - first[i]
    cand = torch.full((n, max(K, 1)), -1, dtype=torch.int64, device=i.device)
    cand[i, slot] = j
    keep = torch.zeros_like(i, dtype=torch.bool)
    x, y, z = (X[f] for f in XYZ)
    other = ~torch.eye(max(K, 1), dtype=torch.bool, device=i.device)
    for lo in range(0, n, BLOCK):
        c = cand[lo:lo + BLOCK]
        valid = c >= 0
        cc = torch.clamp(c, min=0)
        r = torch.arange(lo, lo + c.shape[0], device=i.device)[:, None]
        xi, yi, zi = x[r], y[r], z[r]
        xc, yc, zc = x[cc], y[cc], z[cc]
        dc2 = sq3(xi - xc, yi - yc, zi - zc)
        near = valid & (dc2 < cut2)
        mx, my, mz = (xi + xc) * 0.5, (yi + yc) * 0.5, (zi + zc) * 0.5
        dk2 = sq3(mx[:, :, None] - xc[:, None, :],
                  my[:, :, None] - yc[:, None, :],
                  mz[:, :, None] - zc[:, None, :])        # [B, r, k]
        blocked = ((dk2 < (dc2 * gc2)[:, :, None]) & near[:, None, :]
                   & other).any(dim=2)
        kept = near & ~blocked
        sel = (i >= lo) & (i < lo + c.shape[0])
        keep[sel] = kept[i[sel] - lo, slot[sel]]
    return i[keep], j[keep], d2[keep]


def pair_sums(X, old_v, n, p, dtype):
    """The pair forces, the friction sum and the friction-weighted
    velocity sums of every cell (``[n_pad]`` each), over the kept Gabriel
    pairs: the ReLU band ``relu(0.7 - d) - relu(d - 0.8)`` along ``X_i -
    X_j`` up to ``r_max`` and a friction of 1 below it, neither with the
    wall node (``growth_w_wall.cu:40-71``)."""
    n_pad = X["x"].shape[0]
    dev = X["x"].device
    i, j, d2 = gabriel_pairs(X, n, p)
    dist = torch.sqrt(d2)
    cells = (i != WALL) & (j != WALL)
    F = relu(0.7 - dist) - relu(dist - 0.8)
    w = torch.where(cells & (dist <= p.r_max),
                    F / torch.where(dist > 0, dist, 1.0), 0.0)
    friction = torch.where(cells & (dist < p.r_max), 1.0, 0.0).to(dtype)

    def total(vals):
        return torch.zeros(n_pad, dtype=dtype, device=dev).index_add_(
            0, i, vals.to(dtype))
    force = {f: total((X[f][i] - X[f][j]) * w) for f in XYZ}
    sum_v = [total(friction * v[j]) for v in old_v]
    return force, total(friction), sum_v


def generic_forces(X, n, a, b, n_links, p, dtype):
    """The protrusions' pull and the wall (``links.cuh:99-228``): a set
    protrusion (a row below ``n_links`` with ``a != b``) pulls its ends
    together with ``protrusion_strength`` along the unit vector; every
    cell within 1 of the wall's plane (the wall node's z) feels the band
    ``relu(0.8 - d) - relu(d - 0.8)`` along z, the wall node the sum of
    the reactions; the wall node's whole force is divided by the number
    of cells that feel the wall."""
    n_pad = X["x"].shape[0]
    dev = X["x"].device
    live = (torch.arange(a.shape[0], device=dev) < n_links) & (a != b)
    ia, ib = a[live], b[live]
    r = {f: X[f][ia] - X[f][ib] for f in XYZ}
    dist = torch.sqrt(sq3(r["x"], r["y"], r["z"]))
    safe = torch.where(dist > 0, dist, 1.0)
    G = {}
    for f in XYZ:
        pull = p.protrusion_strength * r[f] / safe
        G[f] = torch.zeros(n_pad, dtype=dtype, device=dev).index_add_(
            0, ia, -pull).index_add_(0, ib, pull)
    rows = torch.arange(n_pad, device=dev)
    d_wall = torch.abs(X["z"] - X["z"][WALL])
    feel = (d_wall < 1.0) & (rows != WALL) & (rows < n)
    Fz = torch.where(feel, relu(0.8 - d_wall) - relu(d_wall - 0.8), 0.0)
    G["z"] = G["z"] + Fz
    n_feel = int(feel.sum())
    scale = 1.0 / n_feel if n_feel else 1.0
    for f in XYZ:
        reaction = -Fz.sum() if f == "z" else 0.0
        g = G[f].clone()
        g[WALL] = (g[WALL] + reaction) * scale
        G[f] = g
    return G


def derivative(X, old_v, n, a, b, n_links, p, dtype):
    """dX of one pass (the pair forces, the generic forces, the
    friction-weighted mean velocity of the neighbours; the centre-of-mass
    drift removed), the friction sum, and the non-finite flag."""
    n_pad = X["x"].shape[0]
    force, sum_f, sum_v = pair_sums(X, old_v, n, p, dtype)
    G = generic_forces(X, n, a, b, n_links, p, dtype)
    active = torch.arange(n_pad, device=X["x"].device) < n
    inv = torch.where(sum_f > 0, 1.0 / torch.where(sum_f > 0, sum_f, 1.0),
                      0.0)
    dX = {}
    for c, f in enumerate(XYZ):
        d = torch.where(active, force[f] + G[f] + sum_v[c] * inv, 0.0)
        drift = (d.sum(dtype=torch.float64) / n).to(dtype)
        dX[f] = torch.where(active, d - drift, 0.0)
    bad = any(bool((~torch.isfinite(v)).any()) for v in dX.values())
    return dX, sum_f, bad


def heun_step(X, old_v, n, a, b, n_links, p, dtype):
    """One Heun step; returns (X', old_v', the first pass's friction sum,
    non-finite)."""
    dX, kept, bad1 = derivative(X, old_v, n, a, b, n_links, p, dtype)
    X1 = {f: X[f] + dX[f] * p.dt for f in XYZ}
    dX1, _, bad2 = derivative(X1, old_v, n, a, b, n_links, p, dtype)
    X_new = {f: X[f] + (dX[f] + dX1[f]) * (0.5 * p.dt) for f in XYZ}
    old_v_new = [(dX[f] + dX1[f]) * 0.5 for f in XYZ]
    return X_new, old_v_new, kept, bad1 or bad2


def rewire(X, n, a, b, n_links, draws, p):
    """The protrusions after one rewiring (``growth_w_wall.cu:90-136``):
    protrusion ``k`` (below ``n_links``) belongs to cell ``k /
    prots_per_cell`` and proposes a random cell of a random one of the 27
    cubes around its cell's, on a grid of ``protrusion_grid`` cubes of
    ``r_protrusion`` (cubes of cell ids sorted in row order, ``floor(u *
    count)`` picks); it takes the proposal if neither end is the wall node,
    the two differ, they lie within ``r_protrusion``, and it is unset or
    its update uniform is below ``update_prob``."""
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
    d = torch.sqrt(sq3(X["x"][src] - X["x"][cand],
                       X["y"][src] - X["y"][cand],
                       X["z"][src] - X["z"][cand]))
    take = ((k < n_links) & (count >= 1) & (src != cand) & (src != WALL)
            & (cand != WALL) & (src < n) & (d <= p.r_protrusion)
            & ((a == b) | (noise < p.update_prob)))
    return torch.where(take, src, a), torch.where(take, cand, b)


def divide(X, old_v, n, rnd, direction, p):
    """The divisions (``growth_w_wall.cu:68-88``): every cell but the wall
    node whose uniform is at most ``prolif_rate`` divides; its daughter
    sits ``mean_dist / 4`` from it along its direction and takes its
    old_v.  Returns (X, old_v, n, the parents' rows)."""
    n_pad = X["x"].shape[0]
    rows = torch.arange(n_pad, device=X["x"].device)
    want = (rows != WALL) & (rnd <= p.prolif_rate) & (rows < n)
    parents = torch.nonzero(want).squeeze(1)
    k = parents.numel()
    if n + k > n_pad:
        raise ValueError(f"{n + k} cells overflow {n_pad} rows")
    new = slice(n, n + k)
    X_out, v_out = {}, []
    for f, d in zip(XYZ, direction):
        a = X[f].clone()
        a[new] = X[f][parents] + p.mean_dist / 4 * d[parents]
        X_out[f] = a
    for v in old_v:
        v = v.clone()
        v[new] = v[parents]
        v_out.append(v)
    return X_out, v_out, n + k, parents


def step(state, link_draws, growth_draws, dtype=torch.float32,
         p=Params()):
    """One step from ``state`` with its draws: ``link_draws`` (cube,
    pick, update uniform a protrusion) and ``growth_draws`` (``(rnd,
    (dx, dy, dz))`` a row).  Returns the state after it, with ``kept``
    (the first pass's kept Gabriel neighbours of each cell, the wall node
    left out: its friction sum), ``parents`` and ``non_finite``."""
    # no matrix product runs here; TF32 stays off all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def cast(v):
        return v.to(dtype)
    X = {f: cast(state["X"][f]) for f in XYZ}
    old_v = [cast(v) for v in state["old_v"]]
    n = int(state["n"])
    n_links = min(n * p.prots_per_cell, int(state["links_max"]))
    pick_cube, u, noise = link_draws
    a, b = rewire(X, n, state["a"], state["b"], n_links,
                  (pick_cube, cast(u), cast(noise)), p)
    X, old_v, kept, bad = heun_step(X, old_v, n, a, b, n_links, p, dtype)
    rnd, direction = growth_draws
    X, old_v, n, parents = divide(X, old_v, n, cast(rnd),
                                  [cast(d) for d in direction], p)
    return {"X": X, "old_v": old_v, "n": n, "a": a, "b": b, "kept": kept,
            "parents": parents, "non_finite": bad}
