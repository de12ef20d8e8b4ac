"""Cell sorting by differential adhesion strength.

Counterpart of ``examples/sorting.py`` (ref ``examples/sorting.cu``): two
cell types with a clipped cubic potential whose strength depends on both
types (by the cells' ids: the first half is the sticky type); the
stickier population sorts to the core.  It runs on the grid engine
(plain torch operations on either device).

Usage: python3 -m yalla_tpu_torch.examples.sorting [n_steps]
           [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import Float3, Property, Solution
from ..inits import random_sphere
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
r_min = 0.5
n_cells = 100
n_time_steps = 300
dt = 0.05


def differential_adhesion(Xi, r, dist, i, j):
    valid = (i != j) & (dist <= r_max)
    strength = (1 + 2 * (j < n_cells // 2)) * (1 + 2 * (i < n_cells // 2))
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(valid, strength * F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def cell_types(device):
    """The cells' types for the output: the second half type 1."""
    cell_type = Property(n_cells, "cell_type", device=device)
    cell_type.h_prop[:] = (np.arange(n_cells) >= n_cells // 2).astype(
        np.int32)
    return cell_type


def setup(device="cuda"):
    """A random ball of ``n_cells``."""
    cells = Solution(Float3, n_cells, solver="grid", device=device)
    random_sphere(r_min, cells)
    return cells


def start(cells, n_steps=None):
    """A run's state: no randoms, only the step index."""
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps)


def draw(cells, state, generator):
    """The step takes no randoms."""
    return None


def step(cells, state, draws=None):
    """One Heun step."""
    cells.take_step(dt, differential_adhesion)
    state.t += 1


def run(cells, n_steps=None):
    """``n_steps + 1`` steps (``n_time_steps`` by default), a frame before
    each."""
    state = start(cells, n_steps)
    cell_type = cell_types(cells.device)
    with Vtk_output("sorting") as output:
        for _ in range(state.n_steps + 1):
            output.write_positions(cells)
            output.write_property(cell_type)
            step(cells, state)
    return state


def main(n_steps=None, device="cuda"):
    run(setup(device), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, None), device_arg(sys.argv))
