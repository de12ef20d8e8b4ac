"""A mesenchyme held by a planar wall, with protrusions: growth_w_wall.

The JAX package keeps this model in ``examples/growth_w_wall.py:25-71``
(ref examples/growth_w_wall.cu): a wall node, cell 0, tracks a plane
normal to z that cells feel through a point-to-plane ReLU band
(``links.link_wall_forces``); no pair force or friction touches the wall
node; every cell holds one protrusion to a grid-sampled neighbour, rewired
every step; the pair forces run on the Gabriel engine.  Here are its
constants, its force and friction, its protrusion rule, and the synthetic
half-space tissue ``benchmarks/bench_gabriel_lattice.py:36-66`` measures
it on at the reference's own scale (100k cells, growth_w_wall.cu:23).
The example's loop (the relaxation against the wall, proliferation and
VTK output) is ``yalla_tpu_torch/examples/growth_w_wall.py``.

``relu_force`` declares the CUDA functor ``growth_w_wall_relu``
(``csrc/forces.cuh``, the force with ``wall_friction``), which the Gabriel
lattice kernel (``ops/gabriel_pallas.py``) runs; ``wall_friction``
declares itself as that functor's friction.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dtypes import Float3
from ..links import random_cube_neighbours
from ..solvers import Solution

r_max = 1.0
mean_dist = 0.75
r_protrusion = 1.0
protrusion_strength = 0.15
prots_per_cell = 1
n_0 = 500
n_max = 100000
dt = 0.1
n_time_steps = 500
update_prob = 0.5
prolif_rate = 0.005
WALL = 0  # the wall node index
# the grid random_cube_neighbours bins the protrusion proposals on
PROTRUSION_GRID = 50


class Params(NamedTuple):
    """The values the device functor takes."""
    r_max: float = r_max
    wall: int = WALL


def wall_friction(Xi, r, dist, i, j):
    """No friction with the wall node (ref growth_w_wall.cu:40-47)."""
    ok = (i != WALL) & (j != WALL) & (i != j) & (dist < r_max)
    return torch.where(ok, 1.0, 0.0)


def relu_force(Xi, r, dist, i, j):
    """Nobody interacts with the wall node via pwints
    (ref growth_w_wall.cu:49-71)."""
    ok = (i != WALL) & (j != WALL) & (i != j) & (dist <= r_max)
    F = torch.clamp(0.7 - dist, min=0) - torch.clamp(dist - 0.8, min=0)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(ok, F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


relu_force.cuda_functor = ("growth_w_wall_relu", Params())
wall_friction.cuda_friction = "wall_friction"


def update_protrusions_wall(a, b, X, n_cells, draws):
    """The protrusion rule (``examples/growth_w_wall.py:55-71``): link row
    k belongs to cell ``k / prots_per_cell`` and moves to a random cell of
    a random neighbour cube within ``r_protrusion``; a set link moves with
    probability ``update_prob``.  ``draws`` is a ``links.Draws``."""
    m = a.shape[0]
    link_id = torch.arange(m, device=a.device)
    src = torch.clamp(((link_id + 0.5) / prots_per_cell).to(torch.int64),
                      max=X.x.shape[0] - 1)
    cand, found = random_cube_neighbours(X, n_cells, r_protrusion,
                                         PROTRUSION_GRID, src,
                                         draws.pick_cube, draws.u)
    d = torch.sqrt((X.x[src] - X.x[cand]) ** 2 + (X.y[src] - X.y[cand]) ** 2
                   + (X.z[src] - X.z[cand]) ** 2)
    not_init = a == b
    ok = (found & (src != cand) & (src != WALL) & (cand != WALL)
          & (src < n_cells) & (d <= r_protrusion)
          & (not_init | (draws.noise < update_prob)))
    return torch.where(ok, src, a), torch.where(ok, cand, b)


def half_space_solution(n_cells, engine, device="cuda", seed=0):
    """A ``Solution`` of ``n_cells`` cells (the wall node included) on
    ``device`` holding :func:`half_space_tissue`, with ``cube_size``
    ``r_max``."""
    sol = Solution(Float3, n_cells, cube_size=r_max, engine=engine,
                   device=device)
    h, sol.h_n = half_space_tissue(n_cells, sol.n_pad, seed)
    sol.h_X = Float3(**h)
    sol.copy_to_device()
    return sol


def half_space_tissue(n_cells, n_pad, seed=0):
    """The synthetic tissue of ``benchmarks/bench_gabriel_lattice.py:36-66``
    as numpy: a jittered cubic lattice at spacing 0.75 above z = 0.2 in
    rows 1.., the wall node at the origin in row 0.  Returns
    (``{x, y, z: f32[n_pad]}``, the active count ``min(n_cells, rows)``)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil((2 * n_cells) ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g - side / 2) * 0.75 + rng.uniform(-0.2, 0.2, (len(g), 3))
    pos = pos[pos[:, 2] > 0.2][:n_pad - 1]
    h = {f: np.zeros(n_pad, np.float32) for f in "xyz"}
    for c, f in enumerate("xyz"):
        h[f][1:1 + len(pos)] = pos[:, c]
    return h, min(n_cells, len(pos) + 1)
