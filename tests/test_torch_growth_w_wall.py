"""The growth_w_wall slice as a whole against the JAX package.

A 1,000-cell half-space tissue (``models/growth_w_wall.half_space_tissue``,
the construction of ``benchmarks/bench_gabriel_lattice.py``), two steps of
the example's loop (``examples/growth_w_wall.py:134-139``): rewire the
protrusions (``Links.update``), then one Heun step with the ReLU force,
the wall friction and the link and wall forces.  The JAX side runs
``GabrielEngine(lattice=False, windowed=False)`` (the gather form), the
port ``GabrielEngine(lattice=True)`` (the plain version of kernel K5 on the
CPU).  The port's ``Links.update`` gets the JAX draws.

Tolerances: links equal; every field within atol 1e-6 + rtol 1e-2 (the
reference's ``isclose``); the flags both packages name equal (0).
"""
import numpy as np
import pytest
import torch

from helpers import isclose
from test_torch_links import jax_example, next_draws
from yalla_tpu import Float3 as JFloat3
from yalla_tpu import Solution as JSolution
from yalla_tpu.links import Links as JLinks
from yalla_tpu.links import link_wall_forces as j_link_wall_forces
from yalla_tpu.solvers import GabrielEngine as JGabrielEngine
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.links import Links, link_wall_forces
from yalla_tpu_torch.models import growth_w_wall as W
from yalla_tpu_torch.solvers import GabrielEngine, Solution

torch.set_num_threads(2)

N_CELLS, GS, C, NC = 1000, 16, 8, 20


@pytest.fixture(scope="module")
def runs():
    """Both packages' states after each of two steps: a list of
    ``(JAX (X, links, aux), port (X, links, aux))``."""
    G = jax_example()
    h, n = W.half_space_tissue(N_CELLS, 1024)
    jc = JSolution(JFloat3, N_CELLS, cube_size=G.r_max,
                   engine=JGabrielEngine(lattice=False, windowed=False,
                                         grid_size=GS, max_candidates=NC))
    tc = Solution(Float3, N_CELLS, cube_size=W.r_max,
                  engine=GabrielEngine(lattice=True, grid_size=GS,
                                       capacity=C, max_candidates=NC),
                  device="cpu")
    for sol in (jc, tc):
        assert sol.n_pad == 1024
        for f in "xyz":
            getattr(sol.h_X, f)[:] = h[f]
        sol.h_n = n
        sol.copy_to_device()
    jl = JLinks(N_CELLS, G.protrusion_strength, seed=15)
    tl = Links(N_CELLS, W.protrusion_strength, seed=15, device="cpu")
    jl.set_d_n(n)
    tl.set_d_n(n)
    out = []
    for _ in range(2):
        draws = next_draws(jl)
        jl.update(G.update_protrusions_wall, jc)
        tl.update(W.update_protrusions_wall, tc, draws=draws)
        jaux = jc.take_step(G.dt, G.relu_force, pw_friction=G.wall_friction,
                            gen_forces=j_link_wall_forces(jl, G.WALL))
        taux = tc.take_step(W.dt, W.relu_force, pw_friction=W.wall_friction,
                            gen_forces=link_wall_forces(tl, W.WALL))
        out.append(((jc.copy_to_host(), (np.asarray(jl.d_a),
                                          np.asarray(jl.d_b)), jaux),
                    (tc.copy_to_host(), (tl.d_a.numpy(), tl.d_b.numpy()),
                     taux)))
    return n, out


@pytest.mark.parametrize("step", [0, 1])
def test_links_and_fields_match_jax(runs, step):
    n, out = runs
    (jX, jlinks, _), (tX, tlinks, _) = out[step]
    for a, b in zip(tlinks, jlinks):
        np.testing.assert_array_equal(a, b)
    assert (tlinks[0] != tlinks[1])[:n].mean() > 0.1   # links are live
    for f in "xyz":
        assert isclose(getattr(tX, f)[:n], np.asarray(getattr(jX, f))[:n]), f


def test_flags_match_jax(runs):
    _, out = runs
    for (_, _, jaux), (_, _, taux) in out:
        common = {k for k in jaux if k.startswith("__err_")} & set(taux)
        assert common == {"__err_gabriel_candidates", "__err_non_finite"}
        for k in common:
            assert float(taux[k]) == float(jaux[k]) == 0.0, k
        for k in ("__err_lattice_dropped", "__err_out_of_grid"):
            assert float(taux[k]) == 0.0, k


def test_the_wall_holds_the_tissue(runs):
    """The physics the slice is for: the wall node stays below the
    tissue, and the bottom cells are pushed towards the band's 0.8."""
    n, out = runs
    X0, X1 = out[0][1][0], out[1][1][0]
    assert X1.z[0] < X1.z[1:n].min()
    bottom = X0.z[1:n] < 0.5
    assert (X1.z[1:n][bottom] - X1.z[0] > X0.z[1:n][bottom] - X0.z[0]).all()
