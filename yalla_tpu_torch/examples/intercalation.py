"""Intercalating cells: protrusions along x drive convergent extension.

Counterpart of ``examples/intercalation.py`` (ref
``examples/intercalation.cu``): a link table with random rewiring that
keeps links 1 < dist < 2 roughly aligned with x.  It runs on the grid
engine (plain torch operations on either device); the rewiring draws one
uniform a link from the links' ``torch.Generator``
(``update_protrusions.draws``).

Usage: python3 -m yalla_tpu_torch.examples.intercalation [n_steps]
           [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import torch

from .. import Float3, Solution
from ..inits import random_sphere
from ..links import Links, link_forces, uniforms
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
r_min = 0.5
n_cells = 500
prots_per_cell = 1
n_time_steps = 250
dt = 0.2
SEED = 11


def clipped_cubic(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(near, F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def update_protrusions(a, b, X, n_cells_d, draws):
    """Drop stretched/collapsed links; propose random x-aligned links
    (ref intercalation.cu:32-56).  ``draws``: the uniform that picks the
    new partner."""
    (u,) = draws
    m = a.shape[0]
    dist = torch.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                      + (X.z[a] - X.z[b]) ** 2)
    drop = (dist < 1) | (dist > 2)
    a = torch.where(drop, 0, a)
    b = torch.where(drop, 0, b)

    link_id = torch.arange(m, device=a.device)
    jj = ((link_id + 0.5) / prots_per_cell).to(torch.int64)
    kk = torch.clamp((u * n_cells_d).to(torch.int64), max=n_cells_d - 1)
    rx = X.x[jj] - X.x[kk]
    ry = X.y[jj] - X.y[kk]
    rz = X.z[jj] - X.z[kk]
    d = torch.sqrt(rx * rx + ry * ry + rz * rz)
    ok = (jj != kk) & (torch.abs(rx / torch.where(d > 0, d, 1.0)) < 0.2) \
        & (d > 1) & (d < 2)
    return torch.where(ok, jj, a), torch.where(ok, kk, b)


update_protrusions.draws = uniforms(1)


def setup(device="cuda"):
    """A random ball of ``n_cells``."""
    cells = Solution(Float3, n_cells, solver="grid", row_cap=64,
                     device=device)
    random_sphere(r_min, cells)
    return cells


def start(cells, n_steps=None):
    """A run's state: the step index and the protrusions (all unset at
    first, rewired from a generator seeded ``SEED``)."""
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps,
        links=Links(n_cells * prots_per_cell, seed=SEED, device=cells.device))


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
    """``n_steps + 1`` steps (``n_time_steps`` by default), a frame before
    each."""
    state = start(cells, n_steps)
    with Vtk_output("intercalation") as output:
        for _ in range(state.n_steps + 1):
            output.write_positions(cells)
            output.write_links(state.links)
            step(cells, state)
    return state


def main(n_steps=None, device="cuda"):
    run(setup(device), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, None), device_arg(sys.argv))
