"""Lineage tracing of a small group of dividing cells; writes the lineage
tree as a second VTK (nodes and LINES branches).

Counterpart of ``examples/lineage_tracing.py`` (ref
``examples/lineage_tracing.cu``) on the prefix-sum division framework
(``growth.proliferate``, ``growth.record_divisions``).  It runs on the
grid engine (plain torch operations on either device); the divisions draw
from a ``torch.Generator`` on the state's device (``growth.Draws`` injects
others).

Usage: python3 -m yalla_tpu_torch.examples.lineage_tracing [n_steps]
           [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import Po_cell, Property, Solution
from ..growth import draw as growth_draw
from ..growth import lineage_init, proliferate, record_divisions
from ..inits import regular_rectangle
from ..links import Links
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
mean_dist = 0.75
prolif_rate = 0.005
n_0 = 5
n_max = 5000
n_time_steps = 1000
dt = 0.1
SEED = 21


def relaxation_force(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    F = torch.clamp(0.8 - dist, min=0) * 2 - torch.clamp(dist - 0.8, min=0)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(near, F / safe, 0.0)
    zero = torch.zeros_like(dist)
    return Po_cell(x=r.x * w, y=r.y * w, z=r.z * w, theta=zero, phi=zero)


def want_fn(X, props, rnd, i, n):
    (rate,) = props
    return rnd <= rate


def child_fn(X, props, direction, i):
    off = mean_dist / 4
    daughter = X.replace(x=X.x + off * direction.x,
                         y=X.y + off * direction.y,
                         z=X.z + off * direction.z)
    return X, daughter


def setup(device="cuda"):
    """A row of ``n_0`` cells and their lineage (founders only)."""
    cells = Solution(Po_cell, n_max, solver="grid", device=device)
    cells.h_n = n_0
    regular_rectangle(mean_dist, n_0, cells)
    return cells


def start(cells, n_steps=None):
    """A run's state: the step index, the step count (the lineage's
    clock), the divisions' generator seeded ``SEED`` and the lineage of
    the ``n_0`` founders."""
    dev = cells.device
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps,
        generator=g,
        lin=lineage_init(2 * cells.n_pad, cells.n_pad, n_0, device=dev))


def draw(cells, state, generator):
    """The divisions' randoms, from ``generator``."""
    return growth_draw(generator, cells.n_pad, cells.device)


def step(cells, state, draws=None):
    """Step ``state.t`` of ``state.n_steps``: one Heun step, then
    divisions (at ``prolif_rate`` after step 100) recorded in the lineage
    ``state.lin``.  The randoms come from ``draws`` where given, else from
    the run's generator."""
    t = state.t
    cells.take_step(dt, relaxation_force)
    rate = prolif_rate * (t > 100)
    cells.d_X, cells.d_old_v, cells.d_n, _, info = proliferate(
        want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
        state.generator, props=(rate,), draws=draws)
    state.lin = record_divisions(
        state.lin, info, cells.d_X,
        torch.zeros(cells.n_pad, dtype=torch.int32, device=cells.device),
        t / state.n_steps)
    state.t += 1


def tree(cells, lin):
    """The lineage tree as a point set and its branches: the internal
    nodes, then the current cells as leaves, each linked to its parent
    node (ref lineage_tracing.cu:168-215).  Returns (points, branches,
    node_clone), host-assembled."""
    dev = cells.device
    n_tree = lin.n_nodes
    n_cells_final = cells.get_d_n()
    h = cells.copy_to_host()
    n_all = max(n_tree + n_cells_final, 1)
    points = Solution(Po_cell, n_all, solver="grid", device=dev)
    branches = Links(n_all, strength=0.0, seed=0, device=dev)
    node_clone = Property(points.n_pad, "node_clone", device=dev)
    nx, ny, nz, nparent, nclone, cparent, cclone = (
        a.cpu().numpy() for a in (lin.node_x, lin.node_y, lin.node_z,
                                  lin.node_parent, lin.node_clone,
                                  lin.cell_parent, lin.cell_clone))
    points.h_X.x[:n_tree] = nx[:n_tree]
    points.h_X.y[:n_tree] = ny[:n_tree]
    points.h_X.z[:n_tree] = nz[:n_tree]
    node_clone.h_prop[:n_tree] = nclone[:n_tree]
    node = np.arange(n_tree)
    has = nparent[:n_tree] >= 0
    branches.h_a[:n_tree][has] = node[has]
    branches.h_b[:n_tree][has] = nparent[:n_tree][has]
    m = n_cells_final
    points.h_X.x[n_tree:n_tree + m] = h.x[:m]
    points.h_X.y[n_tree:n_tree + m] = h.y[:m]
    points.h_X.z[n_tree:n_tree + m] = h.z[:m]
    node_clone.h_prop[n_tree:n_tree + m] = cclone[:m]
    leaf = np.arange(m)
    has = cparent[:m] >= 0
    branches.h_a[n_tree:n_tree + m][has] = n_tree + leaf[has]
    branches.h_b[n_tree:n_tree + m][has] = cparent[:m][has]
    points.h_n = n_tree + m
    branches.h_n = n_tree + m
    points.copy_to_device()
    branches.copy_to_device()
    return points, branches, node_clone


def run(cells, n_steps=None):
    """``n_steps + 1`` steps, a frame every 20 with each cell's parent
    node and clone; then the tree as ``lineage_tree``."""
    dev = cells.device
    state = start(cells, n_steps)
    cell_parent = Property(cells.n_pad, "cell_parent", device=dev)
    cell_clone = Property(cells.n_pad, "cell_clone", device=dev)
    with Vtk_output("lineage_tracing", verbose=False) as output:
        for t in range(state.n_steps + 1):
            step(cells, state)
            if t % 20 == 0:
                output.write_positions(cells)
                cell_parent.h_prop = state.lin.cell_parent.cpu().numpy()
                cell_clone.h_prop = state.lin.cell_clone.cpu().numpy()
                output.write_property(cell_parent)
                output.write_property(cell_clone)
    points, branches, node_clone = tree(cells, state.lin)
    with Vtk_output("lineage_tree", verbose=False) as tree_output:
        tree_output.write_positions(points)
        tree_output.write_links(branches)
        tree_output.write_property(node_clone)
    return state


def main(n_steps=None, device="cuda"):
    run(setup(device), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, n_time_steps), device_arg(sys.argv))
