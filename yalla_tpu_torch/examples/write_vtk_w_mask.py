"""Write a masked subset of a Solution to VTK.

Counterpart of ``examples/write_vtk_w_mask.py`` (ref
``examples/write_vtk_w_mask.cu``): 100 random points with a field and a
polarity, of which those with x > 0.5 are written
(``Vtk_output.write_positions(mask=)``), with their field.

Usage: python3 -m yalla_tpu_torch.examples.write_vtk_w_mask
           [--device DEVICE]
"""
import math
import sys

import numpy as np

from .. import Solution, make_pt
from ..vtkio import Vtk_output
from . import device_arg

Po_cell4 = make_pt("Po_cell4", "w", "theta", "phi")
n_cells = 100


def setup(device="cuda"):
    """Random positions, w and polarities from a seeded generator."""
    rng = np.random.default_rng(0)
    pts = Solution(Po_cell4, n_cells, solver="tile", device=device)
    pts.h_X.x[:n_cells] = rng.random(n_cells)
    pts.h_X.y[:n_cells] = rng.random(n_cells)
    pts.h_X.z[:n_cells] = rng.random(n_cells)
    pts.h_X.w[:n_cells] = rng.random(n_cells)
    pts.h_X.phi[:n_cells] = rng.random(n_cells) * 2 * math.pi - math.pi
    pts.h_X.theta[:n_cells] = np.arccos(2 * rng.random(n_cells) - 1)
    pts.copy_to_device()
    return pts


def run(pts):
    mask = pts.h_X.x[:n_cells] > 0.5
    with Vtk_output("test_vtk", verbose=False) as output:
        output.write_positions(pts, mask=mask)
        output.write_field(pts, "w")


def main(device="cuda"):
    run(setup(device))


if __name__ == "__main__":
    main(device_arg(sys.argv))
