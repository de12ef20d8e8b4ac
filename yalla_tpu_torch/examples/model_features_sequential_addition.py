"""Tutorial model: framework features added one part at a time.

Counterpart of ``examples/model_features_sequential_addition.py`` (ref
``examples/model_features_sequential_addition.cu``): 1) relax a
mesenchymal ball against the background, 2) surround it with epithelium,
3) add a morphogen gradient, 4) add proliferation, 5) add
gradient-oriented protrusion intercalation.  The force reads the seven
channels of ``polarity_precompute``.  It runs on the grid engine (plain
torch operations on either device); the divisions and the rewiring draw
from ``torch.Generator``s on the state's device (``growth.Draws`` and
``links.Draws`` inject others).

The grid engine reads at most ``ROW_CAP`` cells of a row of three
neighbour cubes and raises on more.  The JAX example keeps the engine's
default of 32, which the published run outgrows: the growth of part 4
packs the 4,096 cells of part 5 so that the fullest row holds 27 to 30
cells on the CPU, and on the card more than 32 for one seed in 13
(the benchmark's ``mfsa.published``).  ``ROW_CAP`` = 48 holds the run;
it changes no force, only how many candidates a row may hold.

Usage: python3 -m yalla_tpu_torch.examples.model_features_sequential_addition
           [part_steps] [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import Property, Solution, friction_on_background, make_pt
from ..growth import draw as growth_draw
from ..growth import proliferate
from ..inits import random_sphere
from ..links import Links, link_forces, random_cube_neighbours
from ..polarity import bending_force_fast, polarity_precompute
from ..utils.profiling import span, spanned
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
r_min = 0.8
dt = 0.1
n_0 = 200
n_max = 4000
prots_per_cell = 1
protrusion_strength = 0.25
r_protrusion = 2.0
proliferation_rate = 0.040
part_steps = 100
MESENCHYME, EPITHELIUM = 0.0, 1.0
SEED = 16
# the grid random_cube_neighbours bins the protrusion proposals on
PROTRUSION_GRID = 32
# the grid engine's capacity of a 3-cube row, sized for the published run
# (module docstring)
ROW_CAP = 48

Cell = make_pt("MsaCell", "w", "theta", "phi", "ctype")


def force(Xi, r, dist, i, j):
    diag = i == j
    mes_i = Xi.ctype == MESENCHYME
    dw = torch.where(diag & mes_i & (Xi.w >= 0), -0.01 * Xi.w, 0.0)

    near = (~diag) & (dist <= r_max)
    same = r.ctype == 0.0
    F_mes = torch.clamp(0.7 - dist, min=0) * 3 - torch.clamp(dist - 0.8,
                                                             min=0)
    F_epi = torch.clamp(0.7 - dist, min=0) * 2 - torch.clamp(dist - 0.8,
                                                             min=0)
    F_diff = torch.clamp(0.8 - dist, min=0) * 2 \
        - torch.clamp(dist - 0.9, min=0) * 1.5
    F = torch.where(same, torch.where(mes_i, F_mes, F_epi), F_diff)
    safe = torch.where(dist > 0, dist, 1.0)
    wgt = torch.where(near, F / safe, 0.0)
    dw = dw + torch.where(near & mes_i & (Xi.w >= 0), -r.w * 0.4, 0.0)

    both_epi = near & (Xi.ctype * (Xi.ctype - r.ctype) == 1.0)
    bend = bending_force_fast(Xi, r, torch.where(near, dist, 1.0)) * 0.10
    bw = torch.where(both_epi, 1.0, 0.0)
    zero = torch.zeros_like(dist)
    dF = Cell(x=r.x * wgt + bend.x * bw, y=r.y * wgt + bend.y * bw,
              z=r.z * wgt + bend.z * bw, w=dw,
              theta=bend.theta * bw, phi=bend.phi * bw, ctype=zero)
    Xj_type = Xi.ctype - r.ctype
    aux = {"epi_nbs": torch.where(near & (Xj_type == EPITHELIUM), 1.0, 0.0),
           "mes_nbs": torch.where(near & (Xj_type == MESENCHYME), 1.0, 0.0)}
    return dF, aux


def update_protrusions(a, b, X, n_cells, draws):
    """Protrusions orient normal to the w gradient (ref :110-155).
    ``draws`` is a ``links.Draws``."""
    m = a.shape[0]
    link_id = torch.arange(m, device=a.device)
    src = torch.clamp(((link_id + 0.5) / prots_per_cell).to(torch.int64),
                      max=X.x.shape[0] - 1)
    cand, found = random_cube_neighbours(X, n_cells, r_protrusion,
                                         PROTRUSION_GRID, src,
                                         draws.pick_cube, draws.u)
    both_mes = (X.ctype[src] == MESENCHYME) & (X.ctype[cand] == MESENCHYME)
    nd = torch.sqrt((X.x[src] - X.x[cand]) ** 2 + (X.y[src] - X.y[cand]) ** 2
                    + (X.z[src] - X.z[cand]) ** 2)
    od = torch.sqrt((X.x[a] - X.x[b]) ** 2 + (X.y[a] - X.y[b]) ** 2
                    + (X.z[a] - X.z[b]) ** 2)
    normal_to_w = (torch.abs((X.w[src] - X.w[cand])
                             / torch.where(nd > 0, nd, 1.0))
                   < torch.abs((X.w[a] - X.w[b])
                               / torch.where(od > 0, od, 1.0))
                   * (1.0 - draws.noise))
    ok = (found & both_mes & (src != cand) & (nd <= r_protrusion)
          & (src < n_cells) & ((a == b) | normal_to_w))
    return torch.where(ok, src, a), torch.where(ok, cand, b)


def want_fn(X, props, rnd, i, n):
    epi_nbs, mes_nbs = props
    # the JAX package's guard, rounded in f32
    guard = i < int(np.float32(n) * np.float32(1 - proliferation_rate))
    mes_ok = (X.ctype == MESENCHYME) & (rnd <= proliferation_rate)
    epi_ok = ((X.ctype == EPITHELIUM) & (epi_nbs <= 14) & (mes_nbs >= 1)
              & (rnd <= 2 * proliferation_rate))
    return guard & (mes_ok | epi_ok)


def child_fn(X, props, direction, i):
    off = r_min / 4
    mes = X.ctype == MESENCHYME
    parent = X.replace(w=torch.where(mes, X.w / 2, X.w))
    daughter = parent.replace(x=X.x + off * direction.x,
                              y=X.y + off * direction.y,
                              z=X.z + off * direction.z)
    return parent, daughter


def setup(device="cuda", seed=SEED):
    """A random mesenchymal ball of ``n_0`` cells (grid of 50 cubes), its
    positions drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    cells = Solution(Cell, n_max, solver="grid", grid_size=50,
                     row_cap=ROW_CAP, device=device)
    cells.h_n = n_0
    random_sphere(0.55, cells, rng=rng)
    return cells


def make_epithelium(cells, mes_nbs):
    """Part 2's transition: cells with fewer than 20 mesenchymal
    neighbours become epithelium with radial polarity (ref :204-215,
    counter threshold halved: these count one Heun pass).  Its two
    readbacks are the span ``model.readback``."""
    with span("model.readback"):
        mes = mes_nbs.cpu().numpy()
    with span("model.readback"):
        h = cells.copy_to_host()
    surf = (mes < 20) & (np.arange(cells.n_pad) < n_0)
    d = np.maximum(np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2), 1e-6)
    h.ctype[surf] = EPITHELIUM
    h.theta[surf] = np.arccos(np.clip(h.z / d, -1, 1))[surf]
    h.phi[surf] = np.arctan2(h.y, h.x)[surf]
    cells.copy_to_device()


def add_source(cells):
    """Part 3's morphogen source: w = 1 for x > 1 (its readback the span
    ``model.readback``)."""
    with span("model.readback"):
        h = cells.copy_to_host()
    h.w[(h.x > 1.0) & (np.arange(cells.n_pad) < cells.h_n)] = 1.0
    cells.copy_to_device()


def proliferation_step(cells, generator=None, draws=None):
    """A step of part 4: one Heun step, then divisions on its neighbour
    counts.  The randoms come from ``draws`` where given, else from
    ``generator``."""
    aux = cells.take_step(dt, force, precompute=polarity_precompute)
    cells.d_X, cells.d_old_v, cells.d_n, _, _ = proliferate(
        want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n, generator,
        props=(aux["epi_nbs"], aux["mes_nbs"]), draws=draws)


def intercalation_step(cells, protrusions, draws=None):
    """A step of part 5: rewire the protrusions (one a cell), then one
    Heun step with their forces."""
    protrusions.set_d_n(min(cells.get_d_n() * prots_per_cell,
                            protrusions.n_max))
    protrusions.update(update_protrusions, cells, draws=draws)
    cells.take_step(dt, force, gen_forces=link_forces(protrusions),
                    precompute=polarity_precompute)


def start(cells, n_steps=None, seed=SEED):
    """A run's state: the step index, the steps of each part less one
    (``part_steps`` by default), the last step's aux, the divisions'
    generator and the protrusions (both seeded ``seed``)."""
    dev = cells.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return SimpleNamespace(
        t=0, n_steps=part_steps if n_steps is None else n_steps,
        aux=None, generator=g,
        links=Links(n_max * prots_per_cell, protrusion_strength, seed=seed,
                    device=dev))


def part_of(state):
    """The part (0 to 4) that step ``state.t`` belongs to; steps past the
    fifth part's are more of it."""
    return min(4, state.t // (state.n_steps + 1))


def draw(cells, state, generator):
    """The randoms of step ``state.t`` from ``generator``: the divisions'
    in part 4, the rewiring's in part 5, none before."""
    part = part_of(state)
    if part == 3:
        return growth_draw(generator, cells.n_pad, cells.device)
    if part == 4:
        return state.links.draws(update_protrusions, generator)
    return None


@spanned("model.step")
def step(cells, state, draws=None):
    """Step ``state.t``: a step of its part, and after the last step of a
    part the change that opens the next (the epithelium, the source, the
    protrusions' count).  The randoms come from ``draws`` where given,
    else from the run's generators.  Traced, the call is the span
    ``model.step``."""
    pre = polarity_precompute
    part = part_of(state)
    if part == 0:
        state.aux = cells.take_step(dt, force,
                                    pw_friction=friction_on_background,
                                    precompute=pre)
    elif part in (1, 2):
        state.aux = cells.take_step(dt, force, precompute=pre)
    elif part == 3:
        proliferation_step(cells, state.generator, draws=draws)
    else:
        intercalation_step(cells, state.links, draws=draws)
    state.t += 1
    if state.t % (state.n_steps + 1) == 0:
        if part == 0:       # part 2: surface cells become epithelium
            make_epithelium(cells, state.aux["mes_nbs"])
        elif part == 1:     # part 3: morphogen source on one side
            add_source(cells)
        elif part == 3:     # part 5: gradient-oriented intercalation
            state.links.set_d_n(n_0 * prots_per_cell)


def cell_types(cells):
    """The frames' ``cell_type`` property, filled by :func:`write_frame`."""
    return Property(cells.n_pad, "cell_type", device=cells.device)


@spanned("output.frame")
def write_frame(output, cells, state, cell_type):
    """One frame's file: the positions, the protrusions (in the fifth
    part), the polarity, the cell types (read back into ``cell_type``,
    the span ``output.readback``) and the field w."""
    output.write_positions(cells)
    if part_of(state) == 4:
        output.write_links(state.links)
    output.write_polarity(cells)
    with span("output.readback"):
        ctype = cells.d_X.ctype.cpu()
    cell_type.h_prop = ctype.numpy().astype(np.int32)
    output.write_property(cell_type)
    output.write_field(cells, "w")


def run(cells, n_steps=None):
    """The five parts of ``n_steps + 1`` steps each (``part_steps`` by
    default), a frame before each step."""
    state = start(cells, n_steps)
    cell_type = cell_types(cells)
    with Vtk_output("model_features_sequential_addition") as output:
        for _ in range(5 * (state.n_steps + 1)):
            write_frame(output, cells, state, cell_type)
            step(cells, state)
    return state


def main(part_steps=part_steps, device="cuda"):
    run(setup(device), part_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, part_steps), device_arg(sys.argv))
