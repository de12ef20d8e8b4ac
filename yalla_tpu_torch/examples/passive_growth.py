"""Growing mesenchyme enveloped by an epithelium.

Counterpart of ``examples/passive_growth.py`` (ref
``examples/passive_growth.cu``): type-dependent mechanics, the counts of
mesenchymal and epithelial neighbours as aux channels, the
mesenchyme-to-epithelium transition of the surface cells, and
proliferation gated by type and neighbourhood.  It runs on the grid
engine (plain torch operations on either device); the divisions draw from
a ``torch.Generator`` on the state's device (``growth.Draws`` injects
others).

Usage: python3 -m yalla_tpu_torch.examples.passive_growth [n_steps]
           [--device DEVICE]
"""
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import Solution, make_pt
from ..growth import draw as growth_draw
from ..growth import proliferate
from ..inits import relaxed_sphere
from ..polarity import bending_force
from ..vtkio import Vtk_output
from . import device_arg, steps_arg

r_max = 1.0
mean_dist = 0.75
prolif_rate = 0.006
n_0 = 200
n_max = 5000
n_time_steps = 500
dt = 0.2
SEED = 13

MESENCHYME, EPITHELIUM = 0.0, 1.0
# Cell type rides in the point type with zero dynamics so the force can
# branch on it (replaces the reference's d_type device global).
PgCell = make_pt("PgCell", "theta", "phi", "ctype")


def relu_w_epithelium(Xi, r, dist, i, j):
    near = (i != j) & (dist <= r_max)
    same = r.ctype == 0.0
    F_same = torch.clamp(0.7 - dist, min=0) * 2 - torch.clamp(dist - 0.8,
                                                              min=0)
    F_diff = torch.clamp(0.8 - dist, min=0) * 2 - torch.clamp(dist - 0.9,
                                                              min=0)
    F = torch.where(same, F_same, F_diff)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(near, F / safe, 0.0)

    both_epi = near & (Xi.ctype * (Xi.ctype - r.ctype) == 1.0)
    bend = bending_force(Xi, r, torch.where(near, dist, 1.0)) * 0.15
    bw = torch.where(both_epi, 1.0, 0.0)
    zero = torch.zeros_like(dist)
    dF = PgCell(x=r.x * w + bend.x * bw, y=r.y * w + bend.y * bw,
                z=r.z * w + bend.z * bw,
                theta=bend.theta * bw, phi=bend.phi * bw, ctype=zero)
    Xj_type = Xi.ctype - r.ctype
    aux = {"mes_nbs": torch.where(near & (Xj_type == MESENCHYME), 1.0, 0.0),
           "epi_nbs": torch.where(near & (Xj_type == EPITHELIUM), 1.0, 0.0)}
    return dF, aux


def want_fn(X, props, rnd, i, n):
    rate, mes_nbs, epi_nbs = props
    mes_ok = (X.ctype == MESENCHYME) & (rnd <= rate)
    epi_ok = (X.ctype == EPITHELIUM) & (epi_nbs <= mes_nbs)
    return mes_ok | epi_ok


def child_fn(X, props, direction, i):
    off = mean_dist / 4
    daughter = X.replace(x=X.x + off * direction.x,
                         y=X.y + off * direction.y,
                         z=X.z + off * direction.z)
    return X, daughter


def setup(device="cuda"):
    """A relaxed ball of ``n_0`` cells, one step taken, and the cells with
    few mesenchymal neighbours turned into epithelium with radial
    polarity (ref passive_growth.cu:120-139; < 12*2 there because its
    counters accumulate over both Heun passes -- these count one pass)."""
    rng = np.random.default_rng(SEED)
    cells = Solution(PgCell, n_max, solver="grid", device=device)
    cells.h_n = n_0
    relaxed_sphere(mean_dist, cells, rng=rng)
    aux = cells.take_step(dt, relu_w_epithelium)
    mes_nbs = aux["mes_nbs"].cpu().numpy()
    h = cells.copy_to_host()
    surface = (mes_nbs < 12) & (np.arange(cells.n_pad) < n_0)
    d = np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2)
    d = np.where(d > 0, d, 1.0)
    h.ctype[surface] = EPITHELIUM
    h.theta[surface] = np.arccos(np.clip(h.z / d, -1, 1))[surface]
    h.phi[surface] = np.arctan2(h.y, h.x)[surface]
    cells.copy_to_device()
    return cells


def start(cells, n_steps=None):
    """A run's state: the step index and the divisions' generator, seeded
    ``SEED``."""
    g = torch.Generator(device=cells.device)
    g.manual_seed(SEED)
    return SimpleNamespace(
        t=0, n_steps=n_time_steps if n_steps is None else n_steps,
        generator=g)


def draw(cells, state, generator):
    """The divisions' randoms, from ``generator``."""
    return growth_draw(generator, cells.n_pad, cells.device)


def step(cells, state, draws=None):
    """Step ``state.t``: one Heun step, then divisions on its neighbour
    counts (mesenchyme at ``prolif_rate`` after step 100).  The randoms
    come from ``draws`` where given, else from the run's generator."""
    aux = cells.take_step(dt, relu_w_epithelium)
    rate = prolif_rate * (state.t > 100)
    cells.d_X, cells.d_old_v, cells.d_n, _, _ = proliferate(
        want_fn, child_fn, cells.d_X, cells.d_old_v, cells.d_n,
        state.generator, props=(rate, aux["mes_nbs"], aux["epi_nbs"]),
        draws=draws)
    state.t += 1


def run(cells, n_steps=None):
    """``n_steps + 1`` steps, a frame before each."""
    state = start(cells, n_steps)
    with Vtk_output("passive_growth") as output:
        for _ in range(state.n_steps + 1):
            output.write_positions(cells)
            output.write_field(cells, "ctype", field="ctype")
            output.write_polarity(cells)
            step(cells, state)
    return state


def main(n_steps=None, device="cuda"):
    run(setup(device), n_steps)


if __name__ == "__main__":
    main(steps_arg(sys.argv, n_time_steps), device_arg(sys.argv))
