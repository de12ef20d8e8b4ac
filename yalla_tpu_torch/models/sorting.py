"""Differential-adhesion cell sorting: the 5k all-pairs configuration.

The JAX package keeps this model's physics in ``bench.py``: the hand-written
adhesion of ``build_sorting_tile`` (``bench.py:697-708``), its central form
in ``build_sorting_mxu`` (``bench.py:761-775``, the form
``tests/test_central.py:39-55`` pins to the hand-written one), and the
initial ball both builders start from (``bench.py:680-693``).  Here they
are the port's model module (ref examples/sorting.cu:16-28): two cell
types, adhesion strength 1 between type-0 cells, 9 between type-1 cells
and 3 between types, inside ``r_max``, repulsive inside ``r_min``.

Each force declares the CUDA functor that implements it:
``make_adhesion`` the tile kernel's ``sorting_adhesion``
(``csrc/forces.cuh``), ``make_adhesion_central`` the central kernel's
``sorting_adhesion_central`` or, counting neighbours,
``sorting_adhesion_central_nbs`` (``csrc/central_pair.cu``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dtypes import make_pt
from ..ops.central_mxu import central_force

Cell = make_pt("SortCell", "ctype")


class Params(NamedTuple):
    r_max: float = 1.0
    r_min: float = 0.5
    dt: float = 0.05


def make_adhesion(p: Params):
    """The hand-written pairwise force (``bench.py:697-708``)."""
    def adhesion(Xi, r, dist, i, j):
        near = (i != j) & (dist < p.r_max)
        same = r.ctype == 0.0
        strength = torch.where(same, torch.where(Xi.ctype > 0.5, 9.0, 1.0),
                               3.0)
        F = 2 * (p.r_min - dist) * (p.r_max - dist) + (p.r_max - dist) ** 2
        pos = dist > 0
        inv = torch.where(pos, torch.rsqrt(torch.where(pos, dist * dist,
                                                       1.0)), 0.0)
        w = torch.where(near, strength * F * inv, 0.0)
        zero = torch.zeros_like(dist)
        return Cell(x=r.x * w, y=r.y * w, z=r.z * w, ctype=zero)

    adhesion.cuda_functor = ("sorting_adhesion", p)
    return adhesion


def make_adhesion_central(p: Params, count_neighbours=False):
    """The same physics as a ``central_force`` (``bench.py:761-775``):
    strength{same 0: 1, same 1: 9, mixed: 3} = 1 + 2 t_i + 2 t_j
    + 4 t_i t_j is bilinear in the type bits.  With ``count_neighbours``
    the force also sums the aux channel ``nbs``, the neighbours within
    ``r_max`` (``tests/test_central.py:95-97``)."""
    def coef(dist, Si, Sj, strength):
        a = torch.clamp(p.r_max - dist, min=0.0)     # 0 past the cutoff
        b = a + 2.0 * (p.r_min - dist)
        rs = torch.rsqrt(torch.clamp(dist * dist, min=1e-12))
        return strength * (a * b) * rs

    def nbs(dist, Si, Sj, strength):
        return (dist < p.r_max).to(torch.float32)

    name = "sorting_adhesion_central" + ("_nbs" if count_neighbours else "")
    force = central_force(
        Cell, coef,
        bilinear={"strength": (
            lambda X: (torch.ones_like(X.ctype), 2.0 * X.ctype),
            lambda X: (1.0 + 2.0 * X.ctype, 1.0 + 2.0 * X.ctype))},
        aux={"nbs": nbs} if count_neighbours else None, name=name)
    force.cuda_functor = (name, p)
    return force


def initial_ball(n_cells, n_pad, seed=0):
    """The benchmark's initial state (``bench.py:680-693``) as numpy
    fields ``{x, y, z, ctype: f32[n_pad]}``: a jittered cubic lattice at
    spacing 0.75 with random types; rows past the lattice are zero."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n_cells ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_pad]
    pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
    pos = np.concatenate(
        [pos, np.zeros((max(0, n_pad - len(pos)), 3))])[:n_pad]
    ctype = (rng.random(n_pad) < 0.5).astype(np.float32)
    return {"x": pos[:, 0].astype(np.float32),
            "y": pos[:, 1].astype(np.float32),
            "z": pos[:, 2].astype(np.float32), "ctype": ctype}
