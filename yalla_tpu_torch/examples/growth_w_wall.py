"""Growing mesenchyme constrained by a planar wall, with protrusions.

Counterpart of ``examples/growth_w_wall.py`` (ref
``examples/growth_w_wall.cu``) on the model of
``models/growth_w_wall.py``: a "wall node" (cell 0) tracks a plane normal
to z; cells feel it through a point-to-plane ReLU band
(``links.link_wall_forces``), proliferate, and rewire grid-sampled
protrusions, on the Gabriel engine.

The unrelaxed seed ball first relaxes against the wall on a Gabriel
engine of its own with the lattice kernel opted out (``lattice=False``,
the JAX example's choice: the windowed Gabriel pass, plain torch), which
takes ``RELAX_CANDIDATES`` = 160 candidates a cell where the JAX example
leaves the engine's 100: the ball, folded into the half-space above the
wall, holds twice the packing's density, and its most crowded cell has
95 others within reach on average (1,000 seeds: 88 to 113, above 100 for
one seed in six; yalla's 100-entry array overruns there, the port's flag
refuses it).  The count falls below 30 within the relaxation, and the
candidates the test keeps are the same whatever the cap above them.  The
growth then
runs on the JAX example's Gabriel engine (grid 64, row_cap 64), with the
lattice's capacity ``CAPACITY`` = 16 where the JAX example leaves the
engine's 8: on the card that is the Gabriel lattice kernel (K5) with the
``growth_w_wall_relu`` functor, on a lattice (grid 64, capacity 16) that
the pour kernel (K2) builds.  The relaxed tissue already holds 8 cells in
its fullest cube, and the first steps push it to 9 and 10: at capacity 8
the lattice build drops a cell at step 1 (9 cells cannot fit a cube's 8
slots, whatever the kernel), which the flags refuse (``chip_smoke.py``
phase 26 counts the cubes of the same run on the gather form, which
reads no capacity).  The
capacity changes no force, and off the card (the windowed pass) it is
not read.  The rewiring and the divisions draw from ``torch.Generator``s on
the state's device; ``step`` takes injected draws (``draw``).

Usage: python3 -m yalla_tpu_torch.examples.growth_w_wall [n_steps]
           [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import Float3, Property, Solution, friction_on_background
from ..growth import draw as growth_draw
from ..growth import proliferate
from ..inits import random_sphere
from ..links import Links, link_wall_forces, wall_forces
from ..models.growth_w_wall import (WALL, dt, mean_dist, prolif_rate,
                                    protrusion_strength, prots_per_cell,
                                    relu_force, update_protrusions_wall,
                                    wall_friction)
from ..solvers import GabrielEngine
from ..utils.profiling import spanned
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

n_0 = 500
n_max = 100000
n_time_steps = 500
relax_steps = 101
SEED = 15
CAPACITY = 16
RELAX_CANDIDATES = 160


def want_fn(X, props, rnd, i, n):
    return (i != WALL) & (rnd <= prolif_rate)


def child_fn(X, props, direction, i):
    off = mean_dist / 4
    daughter = X.replace(x=X.x + off * direction.x,
                         y=X.y + off * direction.y,
                         z=X.z + off * direction.z)
    return X, daughter


def seed_ball(device="cuda", seed=SEED):
    """The growth's ``Solution`` holding the wall node at z = -mean_dist
    and an unrelaxed ball of ``n_0 - 1`` cells above the wall, drawn from
    ``seed``."""
    rng = np.random.default_rng(seed)
    cells = Solution(Float3, n_max, device=device,
                     engine=GabrielEngine(grid_size=64, row_cap=64,
                                          capacity=CAPACITY))
    cells.h_n = n_0
    cells.h_X.x[0] = 0
    cells.h_X.y[0] = 0
    cells.h_X.z[0] = -mean_dist  # the wall node
    random_sphere(0.5, cells, n_0=1, rng=rng)
    cells.h_X.z[1:n_0] = np.abs(cells.h_X.z[1:n_0])
    cells.copy_to_device()
    return cells


def relax(cells):
    """``relax_steps`` steps of the seed ball against the wall (ref
    :172-174) on a Gabriel engine sized for its density (row_cap 128,
    ``RELAX_CANDIDATES`` candidates, the lattice kernel opted out, so it
    runs the windowed Gabriel pass, as the JAX example's relaxation does);
    the relaxed state and its old_v go back into ``cells``."""
    tmp = Solution(Float3, n_max, n_pad=cells.n_pad, device=cells.device,
                   engine=GabrielEngine(grid_size=64, row_cap=128,
                                        max_candidates=RELAX_CANDIDATES,
                                        lattice=False))
    tmp.h_X, tmp.h_n = cells.h_X, n_0
    tmp.copy_to_device()
    for _ in range(relax_steps):
        tmp.take_step(dt, relu_force, pw_friction=friction_on_background,
                      gen_forces=wall_forces(WALL))
    tmp.copy_to_host()
    cells.h_X = tmp.h_X
    cells.copy_to_device()
    cells.d_old_v = tmp.d_old_v


def setup(device="cuda", seed=SEED):
    """The seed ball drawn from ``seed``, relaxed against the wall."""
    cells = seed_ball(device, seed)
    relax(cells)
    return cells


def start(cells, n_steps=None, seed=SEED):
    """A run's state: the step index, the protrusions (their generator
    seeded ``seed``, ``n_0`` rows live) and the divisions' generator
    (seeded ``seed``)."""
    dev = cells.device
    links = Links(n_max, protrusion_strength, seed=seed, device=dev)
    links.set_d_n(n_0)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps,
        links=links, generator=g)


def draw(cells, state, generator):
    """One step's randoms from ``generator``: the rewiring's, then the
    divisions'."""
    return (state.links.draws(update_protrusions_wall, generator),
            growth_draw(generator, cells.n_pad, cells.device))


@spanned("model.step")
def step(cells, state, draws=None):
    """One step: rewire the protrusions, one Heun step with the wall and
    link forces, then divisions.  The randoms come from ``draws`` (the
    rewiring's and the divisions') where given, else from the run's
    generators.  Traced, the call is the span ``model.step``."""
    link_draws, growth_draws = (None, None) if draws is None else draws
    links = state.links
    links.set_d_n(min(cells.get_d_n() * prots_per_cell, links.n_max))
    links.update(update_protrusions_wall, cells, draws=link_draws)
    cells.take_step(dt, relu_force, pw_friction=wall_friction,
                    gen_forces=link_wall_forces(links, WALL))
    cells.d_X, cells.d_old_v, cells.d_n, _, _ = proliferate(
        want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
        state.generator, draws=growth_draws)
    state.t += 1


def cell_types(cells):
    """The frames' ``cell_type`` property: 0 for the wall node, 1 for the
    mesenchyme."""
    cell_type = Property(cells.n_pad, "cell_type", device=cells.device)
    cell_type.h_prop[0] = 0   # wall_node
    cell_type.h_prop[1:] = 1  # mesenchyme
    return cell_type


def write_frame(output, cells, state, cell_type):
    """One frame's file: the positions, the protrusions and the cell
    types."""
    output.write_positions(cells)
    output.write_links(state.links)
    output.write_property(cell_type)


def run(cells, n_steps=None):
    """``n_steps + 1`` steps, a frame every ``n_steps // 100``."""
    state = start(cells, n_steps)
    cell_type = cell_types(cells)
    skip = max(1, state.n_steps // 100)
    with Vtk_output("growth_w_wall") as output:
        for t in range(state.n_steps + 1):
            step(cells, state)
            if t % skip == 0:
                write_frame(output, cells, state, cell_type)
    return state


def main(n_steps=None, device="cuda"):
    run(setup(device), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, n_time_steps), device_arg(sys.argv))
