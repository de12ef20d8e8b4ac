"""yalla_tpu_torch against yalla_tpu: the resident cadence of
``lattice_heun_steps`` (``rebuild_every > 1``) with its staleness
certificate, generic forces inside the slot loop, and mover routing.

The same numpy inputs (made from a seed) go to both packages.
Tolerances: trajectories within atol 1e-5 (as tests/test_fastpath.py
holds its cadences against each other), ``stale_max_disp`` and
``stale_shear_closure`` within 1e-5, every ``__err_*`` flag exact
(``__err_stale`` included), and the gap deficit of given per-cube
extrema bit for bit (only max, min and subtraction).  The JAX side runs
its XLA pass (``pallas=False``) where there are no overflow extras, its
Pallas kernel in interpret mode where there are.

Mirrors tests/test_fastpath.py's resident tests (``test_lattice_resident
_mode``, ``test_lattice_gen_forces_match_tile``, the staleness metric and
flag and the four staleness geometries) and tests/test_extras.py
``test_mover_routing_certifies_resident_cadence``, at grids of 8 to 16
cubes.  The four geometries share one static configuration (the COM fix,
4 steps, grid 8, C 16) so that the JAX package compiles it once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_rebin import (RELU, assert_clean, assert_same_run,
                              both_states, flags, run_both)
from yalla_tpu import Float3 as JFloat3
from yalla_tpu import Solution as JSolution
from yalla_tpu.links import Links as JLinks
from yalla_tpu.links import link_forces as j_link_forces
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.solvers import LatticeEngine as JLatticeEngine
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.links import Links, link_forces
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.common import friction_w_neighbour as t_friction
from yalla_tpu_torch.inits import relu_force as t_relu
from yalla_tpu_torch.solvers import LatticeEngine, Solution

torch.set_num_threads(2)


def j_no_force(Xi, r, dist, i, j):
    return jax.tree.map(lambda a: jnp.zeros_like(dist), Xi)


def t_no_force(Xi, r, dist, i, j):
    return type(Xi)(*(torch.zeros_like(dist) for _ in Xi))


NO_FORCE = (j_no_force, t_no_force)


def ball(n, n_pad, dist_to_nb, seed):
    """``inits.random_sphere``'s uniform ball (radius from 0.64 random
    sphere packing) in the first ``n`` of ``n_pad`` rows, numpy f32."""
    rng = np.random.default_rng(seed)
    r = (n / 0.64) ** (1 / 3) * dist_to_nb / 2 * rng.random(n) ** (1 / 3)
    theta = np.arccos(2 * rng.random(n) - 1)
    phi = rng.random(n) * 2 * np.pi
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:n] = np.stack([r * np.sin(theta) * np.cos(phi),
                        r * np.sin(theta) * np.sin(phi), r * np.cos(theta)],
                       1)
    return pos


def tile_oracle(pos, n, steps, dt, gen=None):
    """The port's all-pairs engine: ``steps`` steps of relu_force."""
    sol = Solution(Float3, n, solver="tile", device="cpu",
                   n_pad=pos.shape[0])
    sol.h_X = Float3(*(np.array(pos[:, k]) for k in range(3)))
    sol.copy_to_device()
    for _ in range(steps):
        sol.take_step(dt, t_relu, gen_forces=gen)
    return np.stack([a.numpy()[:n] for a in sol.d_X])


def test_torch_resident_mode_matches_jax():
    """``rebuild_every`` 4 (tests/test_fastpath.py
    ``test_lattice_resident_mode`` and ``test_resident_staleness_metric``):
    the JAX trajectory and ``stale_max_disp``, finite, within 0.05 of the
    all-pairs trajectory, the displacement in (0, 0.5)."""
    n = 100
    pos = ball(n, 128, 0.8, seed=79)
    jout, tout = run_both(8, 4, RELU, both_states(pos), n, 0.1, 1.0,
                          grid=8, capacity=8, z_block=4)
    f = assert_same_run(jout, tout, n)
    assert_clean(f)
    assert 0 < f["stale_max_disp"] < 0.5
    got = np.stack([a.numpy()[:n] for a in tout[0]])
    assert np.isfinite(got).all()
    assert np.abs(got - tile_oracle(pos, n, 8, 0.1)).max() < 0.05


@pytest.mark.parametrize("dt,stale", [(0.002, 0.0), (0.8, 1.0)])
def test_torch_staleness_flag_matches_jax(dt, stale):
    """``force_r_max`` 1.0 at cube 1.3 (margin 0.3): a slow run is
    certified, a fast one raises ``__err_stale`` (tests/test_fastpath.py
    ``test_resident_staleness_flag``), as in the JAX package.  At dt 0.8
    pairs cross relu_force's jump at dist 1 (0.2) every step, and the
    rounding of two summation orders decides on which side, so the two
    trajectories part (by 0.24 in 8 steps); there the flags and the
    staleness measures are compared, not the positions."""
    n = 80
    pos = ball(n, 128, 0.8, seed=12)
    jout, tout = run_both(8, 4, RELU, both_states(pos), n, dt, 1.3,
                          grid=8, capacity=8, z_block=4, force_r_max=1.0)
    f = assert_same_run(jout, tout, n, trajectories=not stale)
    assert f["__err_stale"] == stale


def _rotation():
    """A ball turning rigidly about z, carried by the friction velocity
    mixing: large displacement, no pair gap closed.  (state, n, dt, cube,
    r_max)"""
    n = 500
    pos = ball(n, 512, 0.8, seed=5) * 1.4
    w = 0.12
    vel = np.stack([-w * pos[:, 1], w * pos[:, 0], 0 * pos[:, 0]], 1)
    return both_states(pos, vel), n, 0.1, 1.3, 1.0


def _radial():
    """A ball expanding radially: the rim moves several margins per
    chunk but only opens gaps."""
    n = 500
    pos = ball(n, 512, 0.8, seed=9)
    return both_states(pos, 0.15 * pos), n, 0.1, 1.1, 1.0


def _lateral_slip():
    """Two plates two z-cubes apart (z-gap 1.54 > r_max: they never
    interact) sliding past each other in x by 0.5 a chunk."""
    rng = np.random.default_rng(11)
    n, n_pad = 400, 512
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:n, :2] = rng.uniform(-2.5, 2.5, (n, 2))
    pos[:n, 2] = np.where(np.arange(n) < n // 2, 0.44, 1.98)
    vel = np.zeros_like(pos)
    vel[n // 2:n, 0] = 0.25
    return both_states(pos, vel), n, 0.5, 0.8, 0.55


def _diagonal_escape():
    """Two cell pairs binned (2, 0, 2) cubes apart at cube 1.1 closing
    both axis gaps below r_max: only the two-axis term of the certificate
    catches it."""
    pos = np.zeros((512, 3), np.float32)
    pos[:4] = [[1.05, 0.0, 1.05], [1.05, 0.5, 1.05],
               [2.25, 0.0, 2.25], [2.25, 0.5, 2.25]]
    vel = np.zeros_like(pos)
    vel[:2] = [0.0625, 0.0, 0.0625]
    vel[2:4] = [-0.0625, 0.0, -0.0625]
    return both_states(pos, vel), 4, 1.0, 1.1, 1.0


# geometry: (state maker, expected __err_stale)
GEOMETRIES = {"collective_rotation": (_rotation, 0.0),
              "radial_flow": (_radial, 0.0),
              "lateral_slip": (_lateral_slip, 0.0),
              "diagonal_escape": (_diagonal_escape, 1.0)}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_torch_staleness_geometries_match_jax(geometry):
    """tests/test_fastpath.py's four staleness geometries: the same
    flags, closure and displacement as the JAX package, and its verdicts:
    collective rotation, radial flow and lateral slip certified though
    each moves cells past the margin; the diagonal escape flagged though
    its cells stay below the >= 3-cube displacement fallback."""
    make, stale = GEOMETRIES[geometry]
    state, n, dt, cube, r_max = make()
    jout, tout = run_both(4, 4, NO_FORCE, state, n, dt, cube, grid=8,
                          capacity=16, z_block=4, force_r_max=r_max)
    f = assert_same_run(jout, tout, n)
    d = f["stale_max_disp"]
    assert 2 * d > cube - r_max, f"motion too slow to discriminate ({d})"
    assert 2 * d < 2 * cube - r_max, "the displacement fallback fired"
    assert f["__err_out_of_grid"] == 0 and f["__err_lattice_dropped"] == 0
    assert f["__err_stale"] == stale, f


@pytest.mark.parametrize("grid", [(6, 5, 4), 8])
def test_torch_gap_deficit_is_jax_bit_for_bit(grid):
    """``_gap_deficit`` of the same per-cube extrema, empty cubes at
    -/+3e38 among them: the same f32 bits as the JAX function."""
    gx, gy, gz = (grid,) * 3 if isinstance(grid, int) else grid
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1, 1, (3, gx * gy * gz)).astype(np.float32)
    P = lo + rng.uniform(0, 0.5, lo.shape).astype(np.float32)
    empty = rng.random(gx * gy * gz) < 0.3
    P[:, empty], lo[:, empty] = -3e38, 3e38
    got = TL._gap_deficit(torch.tensor(P), torch.tensor(lo), grid)
    want = JL._gap_deficit(jnp.asarray(P), jnp.asarray(lo), grid)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_torch_cube_extrema_with_extras():
    """The per-state extrema the certificate reads: per axis and cube the
    max and min of its lattice cells' positions, the live extras entered
    at their current cube (the JAX integrator's ``cube_red`` and
    ``state_deficit``), against numpy."""
    rng = np.random.default_rng(4)
    n, n_pad, grid, C = 300, 384, 8, 2
    (_, _), (tX, tov) = both_states(rng.uniform(-3.9, 3.9, (n_pad, 3)))
    lay = TL.lattice_build(tX, tov, n, 1.0, grid, C, 128)
    assert int(lay.n_extras) > 0
    P, Q = TL.cube_extrema(lay, lay.T, lay.E, 1.0, grid)
    want_P = np.full((3, grid ** 3), -3e38, np.float32)
    want_Q = np.full((3, grid ** 3), 3e38, np.float32)
    pid, epid = lay.pid.numpy(), lay.epid.numpy()
    cells = [(s // C, [a.numpy()[s] for a in lay.T])
             for s in np.nonzero(pid < n_pad)[0]]
    for e in np.nonzero(epid < n_pad)[0]:
        v = [a.numpy()[e] for a in lay.E]
        c = [int(np.clip(np.floor(x) + grid // 2, 0, grid - 1)) for x in v]
        cells.append(((c[2] * grid + c[1]) * grid + c[0], v))
    for cube, v in cells:
        for u in range(3):
            want_P[u, cube] = max(want_P[u, cube], v[u])
            want_Q[u, cube] = min(want_Q[u, cube], v[u])
    np.testing.assert_array_equal(P.numpy(), want_P)
    np.testing.assert_array_equal(Q.numpy(), want_Q)


def test_torch_gen_in_slot_loop_matches_jax():
    """Generic forces (links) inside the resident slot loop
    (tests/test_fastpath.py ``test_lattice_gen_forces_match_tile``):
    ``Solution.take_steps`` on ``LatticeEngine(rebuild_every=4)`` follows
    the JAX package's trajectory; at ``rebuild_every`` 1 (``heun_steps``
    on the engine's ``pairwise``) it is the all-pairs trajectory, and the
    resident one stays within 0.05 of it."""
    n, n_pad = 96, 128
    pos = ball(n, n_pad, 0.6, seed=7)
    gen = np.random.default_rng(8)
    la, lb = gen.integers(0, n, n // 2), gen.integers(0, n, n // 2)

    def port_links():
        links = Links(n // 2, strength=0.25, seed=5, device="cpu")
        links.h_a[:n // 2], links.h_b[:n // 2] = la, lb
        links.copy_to_device()
        return link_forces(links)

    jl = JLinks(n // 2, strength=0.25, seed=5)
    jl.h_a[:n // 2], jl.h_b[:n // 2] = la, lb
    jl.copy_to_device()
    js = JSolution(JFloat3, n, cube_size=1.0, engine=JLatticeEngine(
        grid_size=8, capacity=16, z_block=2, rebuild_every=4))
    js.h_X.x[:], js.h_X.y[:], js.h_X.z[:] = pos.T
    js.copy_to_device()
    js.take_steps(4, 0.1, RELU[0], gen_forces=j_link_forces(jl))
    want = np.stack([np.asarray(a)[:n] for a in js.d_X])

    def port(rebuild_every):
        s = Solution(Float3, n, cube_size=1.0, device="cpu", n_pad=n_pad,
                     engine=LatticeEngine(grid_size=8, capacity=16,
                                          z_block=2,
                                          rebuild_every=rebuild_every))
        s.h_X = Float3(*(np.array(pos[:, k]) for k in range(3)))
        s.copy_to_device()
        aux = s.take_steps(4, 0.1, t_relu, gen_forces=port_links())
        assert_clean(flags(aux))
        return np.stack([a.numpy()[:n] for a in s.d_X])

    resident = port(4)
    np.testing.assert_allclose(resident, want, rtol=0, atol=1e-5)
    ref = tile_oracle(pos, n, 4, 0.1, gen=port_links())
    np.testing.assert_allclose(port(1), ref, rtol=0, atol=2e-5)
    assert np.abs(resident - ref).max() < 0.05


def test_torch_mover_routing_certifies_like_jax():
    """tests/test_extras.py ``test_mover_routing_certifies_resident
    _cadence``: the diagonal escape flags the resident cadence, but with
    ``route_movers`` 2.0 the fast cells ride the extras list, re-tabled
    every pass, and the certificate is clean -- the JAX kernel's
    (interpret mode) trajectory and flags."""
    state, n, dt, cube, r_max = _diagonal_escape()
    state = tuple((type(X)(*(a[:64] for a in X)), type(v)(*(a[:64]
                                                             for a in v)))
                  for X, v in state)
    kw = dict(fix_mode="point", grid=16, capacity=8, z_block=4,
              force_r_max=r_max, extras_cap=64, extras_block_cap=16)
    jout, tout = run_both(4, 4, NO_FORCE, state, n, dt, cube,
                          route_movers=2.0, **kw)
    f = assert_same_run(jout, tout, n)
    assert_clean(f)
    unrouted = TL.lattice_heun_steps(
        4, 4, t_no_force, t_friction, "point", 16, 8, 4, *state[1], n, dt,
        cube, 0, None, True, None, None, r_max, 64, 16)
    assert float(unrouted[2]["__err_stale"]) == 1.0


def test_torch_take_steps_cadence_divides_n_steps_like_jax():
    """``take_steps(6)`` on ``rebuild_every=4`` rebuilds every 3 steps
    (the largest divisor of 6 not above 4) with a warning, as the JAX
    ``Solution`` does: the same trajectory and staleness measures."""
    n = 80
    pos = ball(n, 128, 0.8, seed=12)
    j = JSolution(JFloat3, n, cube_size=1.3, engine=JLatticeEngine(
        grid_size=8, capacity=8, z_block=4, rebuild_every=4,
        force_r_max=1.0))
    t = Solution(Float3, n, cube_size=1.3, device="cpu", n_pad=128,
                 engine=LatticeEngine(grid_size=8, capacity=8, z_block=4,
                                      rebuild_every=4, force_r_max=1.0))
    j.h_X.x[:n], j.h_X.y[:n], j.h_X.z[:n] = pos[:n].T
    j.copy_to_device()
    t.h_X = Float3(*(np.array(pos[:, k]) for k in range(3)))
    t.copy_to_device()
    with pytest.warns(UserWarning, match="rebuilding every 3 steps"):
        jaux = j.take_steps(6, 0.05, RELU[0])
    with pytest.warns(UserWarning, match="rebuilding every 3 steps"):
        taux = t.take_steps(6, 0.05, RELU[1])
    for a, b in zip(t.d_X, j.d_X):
        np.testing.assert_allclose(a.numpy()[:n], np.asarray(b)[:n],
                                   rtol=0, atol=1e-5)
    for k in ("stale_max_disp", "stale_shear_closure"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-5
    assert float(taux["__err_stale"]) == float(jaux["__err_stale"])
