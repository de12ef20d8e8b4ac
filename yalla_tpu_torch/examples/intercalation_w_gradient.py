"""Mesenchymal intercalation orchestrated by epithelial signals.

Counterpart of ``examples/intercalation_w_gradient.py`` (ref
``examples/intercalation_w_gradient.cu``): an 11,557-cell embryo restarts
from the repository's ``examples/sphere_ic.vtk`` (VTK files double as
checkpoints); two morphogens (w, f) diffuse from epithelial sources and
steer grid-sampled protrusion rewiring; the epithelium proliferates,
towards 150,000 cells.

The state runs on the dense lattice engine, so on the card each Heun
pass builds the lattice with the pour kernel (K2) and runs the force in
the lattice pair kernel (K1) as its ``intercalation_w_gradient`` functor,
on the point fields and the seven channels of ``polarity_precompute``.
The JAX example takes the lattice ``Solution(solver="auto")`` sizes once
from the embryo (grid 32, capacity 8); the published run outgrows it,
so this one is sized for the whole run: ``GRID_SIZE`` = 40 and
``CAPACITY`` = 16.  The embryo's fullest cube holds 6 cells and the
growth brings 9 and 10 (at capacity 8 the build drops a cell between
steps 56 and 188), and the tissue spreads from a largest coordinate of
10.0 to 16.3-16.9 by step 500 (past the 32-cube grid's 16 between steps
472 and 486, which the flags refuse): a 40-cube grid reaches 20.  The
sizing changes no force.  The JAX package fuses a step (rewiring, Heun
step, division) into one compiled program; here a step is the same calls
made eagerly (:func:`step`), its flags checked each step.

The protrusion rewiring and the divisions draw from ``torch.Generator``s
on the state's device; ``torch`` cannot reproduce the JAX package's
stream, so a test injects the same draws into both (``links.Draws``,
``growth.Draws``).

Usage: python3 -m yalla_tpu_torch.examples.intercalation_w_gradient
           [n_steps] [--device DEVICE]
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .. import Property, Solution, make_pt
from ..growth import draw as growth_draw
from ..growth import proliferate
from ..links import Links, link_forces, random_cube_neighbours
from ..polarity import bending_force_fast, polarity_precompute
from ..solvers import LatticeEngine
from ..utils.profiling import span, spanned
from ..vtkio import Vtk_input, Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
r_min = 0.8
dt = 0.1
n_max = 150000
prots_per_cell = 1
protrusion_strength = 0.2
r_protrusion = 2.0
mean_proliferation_rate = 0.015
n_time_steps = 500
MESENCHYME, EPITHELIUM = 0.0, 1.0
SEED = 9
# the grid random_cube_neighbours bins the protrusion proposals on
PROTRUSION_GRID = 32
# the lattice, sized for the published run (module docstring)
GRID_SIZE = 40
CAPACITY = 16
# the initial condition, a data file of the repository
IC_PATH = Path(__file__).resolve().parents[2] / "examples" / "sphere_ic.vtk"

Cell = make_pt("IwgCell", "w", "f", "theta", "phi", "ctype")


def force(Xi, r, dist, i, j):
    diag = i == j
    mes_i = Xi.ctype == MESENCHYME
    # degradation on the diagonal (ref :34-41)
    dw = torch.where(diag & mes_i, -0.01 * Xi.w, 0.0)
    df = torch.where(diag & mes_i, -0.01 * Xi.f, 0.0)

    near = (~diag) & (dist <= r_max)
    same = r.ctype == 0.0
    F_mes = torch.clamp(0.8 - dist, min=0) * 2 - torch.clamp(dist - 0.8,
                                                             min=0)
    F_epi = torch.clamp(0.8 - dist, min=0) * 2 \
        - torch.clamp(dist - 0.8, min=0) * 2
    F_diff = torch.clamp(0.9 - dist, min=0) * 2 \
        - torch.clamp(dist - 0.9, min=0) * 2
    F = torch.where(same, torch.where(mes_i, F_mes, F_epi), F_diff)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(near, F / safe, 0.0)

    dw = dw + torch.where(near & mes_i, -r.w * 0.1, 0.0)
    df = df + torch.where(near & mes_i, -r.f * 0.1, 0.0)

    both_epi = near & (Xi.ctype * (Xi.ctype - r.ctype) == 1.0)
    bend = bending_force_fast(Xi, r, torch.where(near, dist, 1.0)) * 0.15
    bw = torch.where(both_epi, 1.0, 0.0)
    zero = torch.zeros_like(dist)
    dF = Cell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
              z=r.z * w + bend.z * bw, w=dw, f=df,
              theta=bend.theta * bw, phi=bend.phi * bw, ctype=zero)
    Xj_type = Xi.ctype - r.ctype
    aux = {"epi_nbs": torch.where(near & (Xj_type == EPITHELIUM), 1.0, 0.0),
           "mes_nbs": torch.where(near & (Xj_type == MESENCHYME), 1.0, 0.0)}
    return dF, aux


# K1's functor with friction_w_neighbour (r_max read from this module at
# each launch)
force.cuda_functor = ("intercalation_w_gradient", sys.modules[__name__])


def make_update_protrusions(n_pad):
    def update(a, b, X, n_cells, draws):
        """Grid-sampled candidates; superficial cells align normal to the f
        gradient, deep cells along the w gradient (ref :120-173).
        ``draws`` is a ``links.Draws``."""
        m = a.shape[0]
        link_id = torch.arange(m, device=a.device)
        src = torch.clamp(((link_id + 0.5) / prots_per_cell)
                          .to(torch.int64), max=n_pad - 1)
        cand, found = random_cube_neighbours(
            X, n_cells, r_protrusion, PROTRUSION_GRID, src,
            draws.pick_cube, draws.u)

        both_mes = (X.ctype[src] == MESENCHYME) \
            & (X.ctype[cand] == MESENCHYME)
        new_rw = X.w[src] - X.w[cand]
        new_rf = X.f[src] - X.f[cand]
        nd = torch.sqrt((X.x[src] - X.x[cand]) ** 2
                        + (X.y[src] - X.y[cand]) ** 2
                        + (X.z[src] - X.z[cand]) ** 2)
        nd_safe = torch.where(nd > 0, nd, 1.0)
        od = torch.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                        + (X.z[a] - X.z[b]) ** 2)
        od_safe = torch.where(od > 0, od, 1.0)
        old_rw = X.w[a] - X.w[b]
        old_rf = X.f[a] - X.f[b]
        superficial = X.w[src] + X.w[cand] > 0.3
        normal_to_f = superficial & (
            torch.abs(new_rf / nd_safe) < torch.abs(old_rf / od_safe)
            * (1.0 - draws.noise))
        parallel_to_w = (~superficial) & (
            torch.abs(new_rw / nd_safe) > torch.abs(old_rw / od_safe)
            * (1.0 - draws.noise))
        not_init = a == b
        ok = (found & both_mes & (src != cand) & (nd <= r_protrusion)
              & (src < n_cells) & (not_init | parallel_to_w | normal_to_f))
        return torch.where(ok, src, a), torch.where(ok, cand, b)
    return update


def want_fn(X, props, rnd, i, n):
    epi_nbs, mes_nbs = props
    # the JAX package's guard, rounded in f32
    guard = i < int(np.float32(n) * np.float32(1 - mean_proliferation_rate))
    return (guard & (X.ctype == EPITHELIUM) & (epi_nbs <= 7)
            & (mes_nbs >= 1) & (rnd <= mean_proliferation_rate))


def child_fn(X, props, direction, i):
    off = r_min / 4
    mes = X.ctype == MESENCHYME
    parent = X.replace(w=torch.where(mes, X.w / 2, X.w),
                       f=torch.where(mes, X.f / 2, X.f))
    daughter = parent.replace(x=X.x + off * direction.x,
                              y=X.y + off * direction.y,
                              z=X.z + off * direction.z)
    return parent, daughter


def setup(device="cuda", path=IC_PATH):
    """The embryo of ``path`` (the repository's ``sphere_ic.vtk`` by
    default) in a ``Solution(Cell, n_max)`` on the run's lattice
    (``GRID_SIZE``, ``CAPACITY``): positions, polarities and types from
    the file, w = 1 on the upper epithelium and f = 1 on a patch of
    it."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(
            f"intercalation_w_gradient: the initial condition {path} is "
            f"missing; pass the path of sphere_ic.vtk (the repository's "
            f"examples/sphere_ic.vtk)")
    inp = Vtk_input(str(path))
    n_0 = inp.n_points
    cells = Solution(Cell, n_max, device=device, engine=LatticeEngine(
        grid_size=GRID_SIZE, capacity=CAPACITY, z_block=2))
    cells.h_n = n_0
    inp.read_positions(cells)
    inp.read_polarity(cells)
    intype = Property(cells.n_pad, "cell_type", device=device)
    inp.read_property(intype, "cell_type")

    h = cells.h_X
    h.ctype[:n_0] = (intype.h_prop[:n_0] == 1).astype(np.float32)
    epi_top = (h.ctype == 1.0) & (h.z > 0)
    h.w[epi_top] = 1.0
    h.f[epi_top & (h.x > 0) & (np.abs(h.y) < 2.5) & (h.z < 3.0)] = 1.0
    cells.copy_to_device()
    return cells


def start(cells, n_steps=None, seed=SEED):
    """A run's state: the step index, the protrusions (one a cell, their
    generator seeded ``seed``), their rule for the state's rows and the
    divisions' generator (seeded ``seed``)."""
    dev = cells.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps,
        links=Links(n_max * prots_per_cell, protrusion_strength, seed=seed,
                    device=dev),
        update=make_update_protrusions(cells.n_pad), generator=g)


def draw(cells, state, generator):
    """One step's randoms from ``generator``: the rewiring's, then the
    divisions'."""
    return (state.links.draws(state.update, generator),
            growth_draw(generator, cells.n_pad, cells.device))


@spanned("model.step")
def step(cells, state, draws=None):
    """One step: rewire the protrusions, one Heun step with their forces
    (flags checked), then divisions on the step's neighbour counts.  The
    randoms come from ``draws`` (the rewiring's and the divisions') where
    given, else from the run's generators.  Returns the step's aux.
    Traced, the call is the span ``model.step``."""
    link_draws, growth_draws = (None, None) if draws is None else draws
    links = state.links
    links.set_d_n(min(cells.get_d_n() * prots_per_cell, links.n_max))
    links.update(state.update, cells, draws=link_draws)
    aux = cells.take_step(dt, force, gen_forces=link_forces(links),
                          precompute=polarity_precompute)
    cells.d_X, cells.d_old_v, cells.d_n, _, _ = proliferate(
        want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
        state.generator, props=(aux["epi_nbs"], aux["mes_nbs"]),
        draws=growth_draws)
    state.t += 1
    return aux


def cell_types(cells):
    """The frames' ``cell_type`` property, filled by :func:`write_frame`."""
    return Property(cells.n_pad, "cell_type", device=cells.device)


@spanned("output.frame")
def write_frame(output, cells, state, cell_type):
    """One frame's file: the positions, the protrusions, the cell types
    (read back into ``cell_type``, the span ``output.readback``) and the
    fields w and f."""
    output.write_positions(cells)
    output.write_links(state.links)
    with span("output.readback"):
        ctype = cells.d_X.ctype.cpu()
    cell_type.h_prop = ctype.numpy().astype(np.int32)
    output.write_property(cell_type)
    output.write_field(cells, "w")
    output.write_field(cells, "f")


def run(cells, n_steps=None):
    """``n_steps + 1`` steps, a VTK frame before each."""
    state = start(cells, n_steps)
    cell_type = cell_types(cells)
    with Vtk_output("intercalation_w_gradient") as output:
        for _ in range(state.n_steps + 1):
            write_frame(output, cells, state, cell_type)
            step(cells, state)
    return state


def main(n_steps=None, device="cuda", path=IC_PATH):
    run(setup(device, path), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, n_time_steps), device_arg(sys.argv))
