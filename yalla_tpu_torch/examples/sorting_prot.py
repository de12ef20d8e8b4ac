"""Cell sorting driven by type-dependent protrusion turnover rates.

Counterpart of ``examples/sorting_prot.py`` (ref
``examples/sorting_prot.cu``): a clipped cubic potential between all
cells, and five protrusions a cell whose links rewire slowly between the
sticky type, quickly between the loose one.  It runs on the grid engine
(plain torch operations on either device); the rewiring draws three
uniforms a link from the links' ``torch.Generator``
(``update_protrusions.draws``).

The grid holds ``ROW_CAP`` = 64 cells in a row of three cubes, where the
JAX example takes the engine's default of 32: the 200 cells at spacing
0.5, pulled together by their links, overflow 32 within the first 7 or 8
steps of the JAX example's 300 (from the initial conditions' seeds 1, 2
and 3), which its flag check then refuses.  The capacity changes no
force: at 64 the run stays clean.

Usage: python3 -m yalla_tpu_torch.examples.sorting_prot [n_steps]
           [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import Float3, Property, Solution
from ..inits import random_sphere
from ..links import Links, link_forces, uniforms
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
r_min = 0.5
n_cells = 200
n_protrusions = n_cells * 5
n_time_steps = 300
dt = 0.05
SEED = 12
ROW_CAP = 64


def clipped_cubic(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(near, F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def update_protrusions(a, b, X, n_cells_d, draws):
    """Type-dependent turnover (ref sorting_prot.cu:33-69): links between
    the sticky type rewire slowly, the loose type quickly.  ``draws``:
    the turnover uniform and the two that pick the new ends."""
    rnd, u_j, u_k = draws
    dist = torch.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                      + (X.z[a] - X.z[b]) ** 2)
    drop = (dist < 1) | (dist > 2)
    a = torch.where(drop, 0, a)
    b = torch.where(drop, 0, b)

    half = n_cells // 2
    rate = torch.where((a < half) & (b < half), 0.05,
                       torch.where((a > half) & (b > half), 0.25, 0.125))
    turnover = rnd <= rate

    new_j = torch.clamp((u_j * n_cells_d).to(torch.int64), max=n_cells_d - 1)
    new_k = torch.clamp((u_k * n_cells_d).to(torch.int64), max=n_cells_d - 1)
    ok = turnover & (new_j != new_k)
    return torch.where(ok, new_j, a), torch.where(ok, new_k, b)


update_protrusions.draws = uniforms(3)


def setup(device="cuda"):
    """A random ball of ``n_cells``."""
    cells = Solution(Float3, n_cells, solver="grid", row_cap=ROW_CAP,
                     device=device)
    random_sphere(r_min, cells)
    return cells


def start(cells, n_steps=None):
    """A run's state: the step index and the protrusions (all unset at
    first, rewired from a generator seeded ``SEED``)."""
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps,
        links=Links(n_protrusions, seed=SEED, device=cells.device))


def draw(cells, state, generator):
    """The rewiring's uniforms, from ``generator``."""
    return state.links.draws(update_protrusions, generator)


def step(cells, state, draws=None):
    """Rewire the protrusions (with ``draws`` where given, else from the
    links' generator), then one Heun step with their forces."""
    state.links.update(update_protrusions, cells, draws=draws)
    cells.take_step(dt, clipped_cubic, gen_forces=link_forces(state.links))
    state.t += 1


def run(cells, n_steps=None):
    """The cell types (the second half type 1), then ``n_steps + 1``
    steps (``n_time_steps`` by default), a frame before each."""
    state = start(cells, n_steps)
    cell_type = Property(n_cells, "cell_type", device=cells.device)
    cell_type.h_prop[:] = (np.arange(n_cells) >= n_cells // 2).astype(
        np.int32)
    with Vtk_output("sorting_prot") as output:
        for _ in range(state.n_steps + 1):
            output.write_positions(cells)
            output.write_links(state.links)
            output.write_property(cell_type)
            step(cells, state)
    return state


def main(n_steps=None, device="cuda"):
    run(setup(device), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, None), device_arg(sys.argv))
