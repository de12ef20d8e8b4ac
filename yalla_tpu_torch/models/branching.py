"""Flagship model: branching morphogenesis on a spheroid.

Counterpart of ``yalla_tpu/models/branching.py`` (ref
``examples/branching.cu``): a mesenchymal core with an epithelial surface
running Meinhardt activator-inhibitor kinetics; the inhibitor diffuses
into the mesenchyme and gates proliferation, driving branch outgrowth.
Cell lineage is traced through every division.

* Cell type lives in the point type (field ``ctype``: 0 mesenchyme,
  1 epithelium); neighbour counters are aux-channel reductions.
* Proliferation uses the prefix-sum division framework (``growth.py``).
* One frame is ``substeps`` x (proliferate; record the divisions; one
  Heun step), a Python loop (ref branching.cu:263-270).  The active count
  is an int, read back once per substep by ``proliferate``; the flags are
  reduced on the device and left for the caller to read, once per frame.
* Capacity tiers: a growing tissue runs each phase at the smallest
  sufficient padded size and is re-padded upward (``tier_caps``,
  ``next_tier``, ``repad_state``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dtypes import device_of, make_pt
from ..growth import (Lineage, lineage_init, proliferate,
                      record_divisions)
from ..polarity import (bending_force_cart, bending_post_pair,
                        polarity_precompute3)
from ..ops.common import ERR_PREFIX
from ..solvers import (GridEngine, LatticeEngine, Solution, _pad_size,
                       cube_occupancy, friction_w_neighbour, heun_step)
from ..utils.profiling import spanned

Cell = make_pt("BranchingCell", "theta", "phi", "u", "v", "ctype")

precompute = polarity_precompute3

MESENCHYME, EPITHELIUM = 0.0, 1.0


class Params(NamedTuple):
    r_max: float = 1.0
    dt: float = 0.2
    lam: float = 0.0075          # Turing time scale (branching.cu:22)
    D_u: float = 0.001
    D_v: float = 0.2
    f_v: float = 1.0
    f_u: float = 80.0
    g_u: float = 80.0
    m_u: float = 0.25
    m_v: float = 0.75
    s_u: float = 0.05
    epi_proliferation_rate: float = 0.2
    mes_proliferation_rate: float = 0.1
    prolif_threshold: float = 1150.0
    mean_distance: float = 0.75


class State(NamedTuple):
    X: Cell
    old_v: object
    n: int
    lineage: Lineage
    epi_nbs: torch.Tensor   # aux counters from the last force pass
    mes_nbs: torch.Tensor
    key: torch.Generator    # on the state's device; a frame draws from a
    #                         copy, so the state it was given keeps its own


def _relu(a):
    return torch.clamp(a, min=0.0)


def make_force(p: Params):
    """Pairwise force in single-reciprocal form (one reciprocal per pair).

    Attributes, as on the JAX force: ``offdiag`` (the same force without
    the i == j reaction terms; equal to the force wherever i != j),
    ``post_pair`` (per-cell bending conversion), ``derive_aux``
    (``mes_nbs = sum_friction - epi_nbs`` when r_max == 1), and
    ``cuda_functor``: the hand-written CUDA functor that implements this
    force in the lattice pair kernel (``csrc/lattice_pair.cu``,
    ``BranchingForce``), with the parameters passed at launch."""
    def body(Xi, r, dist, i, j, with_diag):
        both = Xi.ctype * (Xi.ctype - r.ctype)     # 1 iff both epithelial
        same = r.ctype == 0.0
        diag = i == j

        # Mechanics: type-dependent ReLU band (branching.cu:82-87)
        near = (~diag) & (dist < p.r_max)
        F_same = _relu(0.7 - dist) * 2 - _relu(dist - 0.8)
        F_diff = _relu(0.8 - dist) * 2 - _relu(dist - 0.9)
        F = torch.where(same, F_same, F_diff)
        pos = dist > 0
        inv = torch.where(pos, torch.rsqrt(torch.where(pos, dist * dist,
                                                       1.0)), 0.0)
        w = torch.where(near, F * inv, 0.0)
        fx, fy, fz = r.x * w, r.y * w, r.z * w

        # Diffusion between epithelial pairs; v also leaks into the
        # mesenchyme (branching.cu:91-103)
        epi_pair = near & (both == 1.0)
        du = torch.where(epi_pair, -p.D_u * r.u, 0.0)
        dv0 = torch.where(near, -p.D_v * r.v, 0.0)
        du = torch.where(-du > Xi.u, 0.0, du)
        dv = torch.where(epi_pair & (-dv0 > Xi.v), 0.0, dv0)

        if with_diag:
            # Meinhardt kinetics on the epithelium only (branching.cu:66-77)
            du_r = p.lam * ((p.f_u * Xi.u * Xi.u) / (1 + p.f_v * Xi.v)
                            - p.m_u * Xi.u + p.s_u)
            dv_r = p.lam * (p.g_u * Xi.u * Xi.u - p.m_v * Xi.v)
            du_r = torch.where(-du_r > Xi.u, 0.0, du_r)
            dv_r = torch.where(-dv_r > Xi.v, 0.0, dv_r)
            react = diag & (Xi.ctype == EPITHELIUM)
            du = du + torch.where(react, du_r, 0.0)
            dv = dv + torch.where(react, dv_r, 0.0)

        # Epithelial bending stiffness (branching.cu:100), Cartesian form
        bx, by, bz, gx, gy, gz = bending_force_cart(Xi, r, dist, inv=inv)
        bw = torch.where(epi_pair, 0.2, 0.0)
        fx = fx + bx * bw
        fy = fy + by * bw
        fz = fz + bz * bw

        zero = torch.zeros_like(dist)
        dF = Cell(x=fx, y=fy, z=fz, theta=zero, phi=zero, u=du, v=dv,
                  ctype=zero)
        Xj_epi = Xi.ctype - r.ctype
        aux = {
            "epi_nbs": torch.where(near & (Xj_epi == EPITHELIUM), 1.0, 0.0),
            "pg_x": gx * bw, "pg_y": gy * bw, "pg_z": gz * bw,
        }
        if p.r_max != 1.0:
            aux["mes_nbs"] = torch.where(near & (Xj_epi == MESENCHYME),
                                         1.0, 0.0)
        return dF, aux

    def force(Xi, r, dist, i, j):
        return body(Xi, r, dist, i, j, True)

    force.offdiag = lambda Xi, r, dist, i, j: body(Xi, r, dist, i, j, False)
    force.post_pair = bending_post_pair
    if p.r_max == 1.0:
        force.derive_aux = {
            "mes_nbs": lambda aux, sum_f: sum_f - aux["epi_nbs"]}
    force.cuda_functor = ("branching", p)
    return force


def make_want_fn(p: Params):
    def want(X, props, rnd, i, n):
        epi_nbs, mes_nbs = props
        # the newborn guard, with the count rounded as the JAX package
        # rounds it (an f32 product)
        guard = i < int(np.float32(n)
                        * np.float32(1 - p.epi_proliferation_rate))
        mes_ok = ((X.ctype == MESENCHYME) & (X.v >= p.prolif_threshold)
                  & (rnd <= p.mes_proliferation_rate))
        epi_ok = ((X.ctype == EPITHELIUM) & (epi_nbs <= 5) & (mes_nbs > 0)
                  & (rnd <= p.epi_proliferation_rate))
        return guard & (mes_ok | epi_ok)
    return want


def make_child_fn(p: Params):
    def child(X, props, direction, i):
        off = p.mean_distance / 4
        parent = X.replace(u=X.u / 2, v=X.v / 2)  # conserved species halve
        daughter = parent.replace(x=X.x + off * direction.x,
                                  y=X.y + off * direction.y,
                                  z=X.z + off * direction.z)
        return parent, daughter
    return child


def tier_caps(n_max):
    """Capacity tiers for a tissue growing toward ``n_max``.

    The per-pass cost of every fixed-shape engine follows its PADDED size
    (the build sorts n_pad rows; the pour covers the full grid), not the
    live count.  Growing models therefore run each growth phase at the
    smallest sufficient tier and re-pad upward (``repad_state``); the
    reference gets this for free because its kernel launches follow the
    live count (branching.cu:265 sizes <<<(n + 128 - 1)/128, 128>>>)."""
    final = _pad_size(n_max)
    tiers, t = [], 4096
    while t < final:
        tiers.append(t)
        t *= 4
    return tiers + [final]


def next_tier(n_now, n_max, headroom=0.7):
    """Smallest tier with ``n_now <= headroom * tier`` (the last tier
    regardless)."""
    tiers = tier_caps(n_max)
    for t in tiers:
        if n_now <= headroom * t:
            return t
    return tiers[-1]


def repad_state(state: State, n_pad_new: int) -> State:
    """Re-pad the per-cell tensors of ``state`` to ``n_pad_new`` rows, as
    new tensors (lineage node arrays keep their full capacity)."""
    def repad(a, fill):
        m = a.shape[0]
        if n_pad_new <= m:
            return a[:n_pad_new].clone()
        return torch.cat([a, a.new_full((n_pad_new - m,), fill)])

    lin = state.lineage._replace(
        cell_parent=repad(state.lineage.cell_parent, -1),
        cell_clone=repad(state.lineage.cell_clone, 0))
    return state._replace(
        X=type(state.X)(*(repad(a, 0) for a in state.X)),
        old_v=type(state.old_v)(*(repad(a, 0) for a in state.old_v)),
        lineage=lin,
        epi_nbs=repad(state.epi_nbs, 0),
        mes_nbs=repad(state.mes_nbs, 0),
    )


def default_engine(n_now, n_max, p: Params = Params(), extent=None,
                   max_occ=9, device="cuda"):
    """Engine for the model on ``device``: the grid engine at small n_max
    on the CPU, the dense lattice otherwise.

    Capacity-headroom scheduling: the lattice is sized for the FINAL
    population's extent (``n_max``), not the current one, so a run does
    not resize mid-way; occupancy spikes beyond ``capacity`` ride the
    overflow-extras side list.  ``engine_for_state`` remains the reactive
    fallback for states that escape the predicted envelope.

    What the JAX package decides by asking whether its backend is the TPU
    is decided here by ``device``: on the card the capacity sits two below
    the planned occupancy with a 4096-entry extras list; on the CPU the
    lattice has no extras and the full capacity (the JAX engine off the
    TPU ignores its extras), and up to 20k cells the grid engine runs."""
    return engine_on(device_of(device, "default_engine").type == "cuda",
                     n_max, p, extent, max_occ)


def engine_on(cuda, n_max, p: Params = Params(), extent=None, max_occ=9):
    """``default_engine``'s choice for the card (``cuda`` true) or the CPU,
    as a function of its arguments alone: it touches no device."""
    if n_max <= 20_000 and not cuda:
        # honour the measured occupancy: engine_for_state retries after a
        # __err_grid_overflow must return a roomier engine, not the same
        # one.  row_cap bounds a 3-cube row, so size it from 3x the worst
        # single cube plus headroom.
        return GridEngine(grid_size=100, row_cap=max(32, 3 * max_occ + 16))
    from ..ops.lattice_xla import pick_lattice_dims
    margin = 0.0
    if extent is None:
        # the equilibrium half-extent of the settled adhesive tissue is
        # about n^(1/3) * rest_spacing / 2 (the branching potential packs
        # up to 8 cells per unit cube, BASELINE.md); branch outgrowth
        # margin on top
        extent = max(n_max, 1) ** (1 / 3) * 0.8 / 2
        margin = 4.0
    # An actively DIVIDING tissue packs ~15 cells/cube around the division
    # zones (daughters placed at mean_distance/4 of the parent are nearly
    # co-located until the mechanics spread them), so plan for the
    # division regime up front, also when the caller passes less; a run
    # that stays settled should size its own engine.  The extras side
    # list still absorbs the worst division bursts past C.
    max_occ = max(max_occ, 15)
    gs, C = pick_lattice_dims(extent + margin, p.r_max,
                              max_occ - 2 if cuda else max_occ)
    return LatticeEngine(grid_size=gs, capacity=C, z_block=2,
                         extras_cap=4096 if cuda else 0,
                         extras_block_cap=32)


def engine_for_state(state, n_max, p: Params = Params()):
    """Re-derive the engine from the live state's extent AND measured cube
    occupancy (use when a frame reports ``__err_out_of_grid`` /
    ``__err_lattice_dropped``: a fixed occupancy guess would rebuild the
    identical engine and retry-fail forever).  One readback of the
    positions."""
    n = int(state.n)
    extent, max_occ = cube_occupancy(
        *(a[:max(n, 1)].cpu().numpy()
          for a in (state.X.x, state.X.y, state.X.z)), p.r_max)
    return default_engine(n, n_max, p, extent=extent + 2.0,
                          max_occ=(max_occ if n else 1) + 1,
                          device=state.X.x.device)


def init_state(n_0, n_max, p: Params = Params(), engine=None, seed=0,
               lineage_cap=None, device="cuda"):
    """Initial condition: relaxed mesenchymal ball, outer shell converted to
    epithelium with radial polarity and noisy morphogen seed
    (branching.cu:176-254).  Returns (State, Solution, engine), the state
    on ``device``."""
    from ..inits import relaxed_sphere

    device = device_of(device, "init_state")
    if engine is None:
        engine = default_engine(n_0, n_max, p, device=device)
    rng = np.random.default_rng(seed)

    cells = Solution(Cell, n_max, engine=engine, cube_size=p.r_max,
                     device=device)
    cells.h_n = n_0
    relaxed_sphere(p.mean_distance, cells, rng=rng)
    cells.copy_to_host()
    n_pad = cells.n_pad

    # Mesenchymal-neighbour counting pre-pass (take_step with dt = 0,
    # branching.cu:241-242)
    force = make_force(p)
    aux = cells.take_step(0.0, force, precompute=precompute)
    mes_nbs = aux["mes_nbs"].cpu().numpy()

    # Surface cells (few mesenchymal neighbours) become epithelium with
    # radial apical-basal polarity (branching.cu:243-254).  The reference
    # threshold is 20 but its pre-pass counters accumulate over BOTH Heun
    # passes (no reset hook is passed at branching.cu:241-242); the aux
    # channel counts one pass, so the equivalent threshold is 10.
    h = cells.h_X
    surface = (mes_nbs < 10) & (np.arange(n_pad) < n_0)
    r = np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2)
    r = np.where(r > 0, r, 1.0)
    h.ctype[surface] = EPITHELIUM
    h.theta[surface] = np.arccos(np.clip(h.z / r, -1, 1))[surface]
    h.phi[surface] = np.arctan2(h.y, h.x)[surface]
    h.u[surface] = (rng.random(n_pad)[surface] / 5) - 0.1
    h.v[surface] = (rng.random(n_pad)[surface] / 5) - 0.1
    cells.copy_to_device()

    cap = lineage_cap if lineage_cap is not None else 2 * n_pad
    key = torch.Generator(device=device)
    key.manual_seed(int(seed))
    state = State(
        X=cells.d_X, old_v=cells.d_old_v, n=cells.d_n,
        lineage=lineage_init(cap, n_pad, n_0, device=device),
        epi_nbs=torch.zeros(n_pad, device=device),
        mes_nbs=torch.zeros(n_pad, device=device),
        key=key,
    )
    return state, cells, engine


def make_frame(p: Params, engine, substeps=11):
    """One output frame: ``substeps`` x (proliferate; integrate).

    Mirrors the reference's calculation thread (branching.cu:263-270).
    Returns ``frame(state, time_progression, draws=None) -> (state,
    errs)``.  ``errs`` holds the in-loop failure flags (engine capacity /
    out-of-grid / NaN / cells lost to n_max) as 0-d tensors, reduced by
    max over the substeps and not read back: check them once per frame
    and resize the engine when the growing tissue outruns it.  ``draws``
    is one ``growth.Draws`` per substep; without it they come from a copy
    of ``state.key``, and the new state carries the advanced copy, so a
    frame redone from the same state repeats its draws."""
    force = make_force(p)
    want = make_want_fn(p)
    child = make_child_fn(p)

    @spanned("frame")
    def frame(state: State, time_progression, draws=None):
        X, old_v, n, lin = state.X, state.old_v, state.n, state.lineage
        epi_nbs, mes_nbs = state.epi_nbs, state.mes_nbs
        dev = X.x.device
        key = torch.Generator(device=state.key.device)
        key.set_state(state.key.get_state())
        errs, lost = {}, 0
        for k in range(substeps):
            X, old_v, n, (epi_nbs, mes_nbs), info = proliferate(
                want, child, X, old_v, n, key, props=(epi_nbs, mes_nbs),
                draws=None if draws is None else draws[k])
            lin = record_divisions(lin, info, X, X.ctype.to(torch.int32),
                                   time_progression)
            X, old_v, aux = heun_step(
                engine, force, friction_w_neighbour, "com", X, old_v, n,
                p.dt, p.r_max, 0, precompute)
            for name, v in aux.items():
                if name.startswith(ERR_PREFIX):
                    v = v.to(torch.float32)
                    errs[name] = torch.maximum(errs[name], v) \
                        if name in errs else v
            lost = max(lost, info.n_lost)
            epi_nbs, mes_nbs = aux["epi_nbs"], aux["mes_nbs"]
        errs["__err_cells_lost"] = torch.full((), float(lost), device=dev)
        return (State(X=X, old_v=old_v, n=n, lineage=lin, epi_nbs=epi_nbs,
                      mes_nbs=mes_nbs, key=key), errs)

    return frame
