"""Cut the Utah teapot out of a cuboid full of points (mesh exclusion).

Counterpart of ``examples/teapot.py`` (ref ``examples/teapot.cu``): a
random cuboid of points around the repository's ``examples/teapot.vtk``,
then every point outside the closed mesh dropped
(``mesh.Mesh.test_exclusion_many``, the native library's parity test).
The points live in a ``Solution`` on the all-pairs engine; no step is
taken.

Usage: python3 -m yalla_tpu_torch.examples.teapot [n_points]
           [--device DEVICE]
"""
import sys
from pathlib import Path

import numpy as np

from .. import Float3, Solution
from ..inits import random_cuboid
from ..mesh import Mesh
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

n_points = 70000
# the mesh, a data file of the repository
MESH_PATH = Path(__file__).resolve().parents[2] / "examples" / "teapot.vtk"


def setup(device="cuda", n=n_points, path=MESH_PATH):
    """The mesh of ``path`` and a ``Solution`` of up to ``n`` points
    filling its bounding box (their spacing scaled so that ``n`` points
    fill it as ``n_points`` do at 0.125)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(
            f"teapot: the mesh {path} is missing; pass the path of "
            f"teapot.vtk (the repository's examples/teapot.vtk)")
    points = Solution(Float3, n, solver="tile", device=device)
    teapot = Mesh(str(path))
    random_cuboid(0.125 * (n_points / n) ** (1 / 3),
                  teapot.get_minimum(), teapot.get_maximum(), points)
    return points, teapot


def cut(points, mesh):
    """Keep the points inside ``mesh``, in their order; returns the
    count kept."""
    h = points.h_X
    m = points.h_n
    pts = np.stack([h.x[:m], h.y[:m], h.z[:m]], 1)
    keep = pts[~mesh.test_exclusion_many(pts)]
    h.x[:len(keep)] = keep[:, 0]
    h.y[:len(keep)] = keep[:, 1]
    h.z[:len(keep)] = keep[:, 2]
    points.h_n = len(keep)
    points.copy_to_device()
    return len(keep)


def run(points, mesh):
    with Vtk_output("teapot", verbose=False) as output:
        output.write_positions(points)
        cut(points, mesh)
        output.write_positions(points)


def main(n=n_points, device="cuda", path=MESH_PATH):
    run(*setup(device, n, path))


if __name__ == "__main__":
    main(steps_arg(sys.argv, n_points), device_arg(sys.argv))
