"""Flagship model, physics subset: branching morphogenesis on a spheroid.

Counterpart of ``yalla_tpu/models/branching.py`` (``Cell``, ``Params``,
``make_force``).  Cell type lives in the point type (field ``ctype``:
0 mesenchyme, 1 epithelium); neighbour counters are aux-channel
reductions.  Growth, lineage and the frame loop are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..dtypes import make_pt
from ..polarity import (bending_force_cart, bending_post_pair,
                        polarity_precompute3)

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
