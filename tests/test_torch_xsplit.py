"""yalla_tpu_torch against yalla_tpu: thin x-cubes (``x_split > 1``).

``x_split = k`` bins x at ``cube_size / k`` (the grid's x counts the thin
cubes) and every pass reaches +-k of them in x, +-1 cube in y and z, with
the cutoff still ``cube_size``.  Mirrors tests/test_xsplit.py's five
tests: the per-pass rebuild on the plain pass, with overflow extras, at
capacity 2, with per-pass slot-space rebinning, and through
``Solution.take_step`` on ``LatticeEngine(x_split=2)``.

The same numpy inputs (made from a seed) go to both packages.
Tolerances: trajectories within atol 1e-5 of the JAX package's, every
``__err_*`` flag exact; against the port's all-pairs oracle within atol
2e-5, as tests/test_xsplit.py holds the JAX lattice to its tile engine.
The JAX side runs its XLA pass (``pallas=False``) where there are no
overflow extras, its Pallas kernel in interpret mode where there are.
"""
import jax.numpy as jnp
import numpy as np

from test_torch_rebin import (RELU, assert_clean, assert_same_run,
                              both_states, run_both)
from test_torch_resident import tile_oracle
from yalla_tpu import Float3 as JFloat3
from yalla_tpu import Solution as JSolution
from yalla_tpu.solvers import LatticeEngine as JLatticeEngine
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.solvers import LatticeEngine, Solution

ORACLE_ATOL = 2e-5


def cube_of(n_pad, seed, scale=(3.0, 3.0, 3.0)):
    """tests/test_xsplit.py ``_ball``: uniform in ``[-1, 1]^3 * scale``,
    numpy f32."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n_pad, 3)) * scale).astype(np.float32)


def positions(out, n):
    return np.stack([a.numpy()[:n] for a in out[0]])


def test_torch_xsplit_matches_jax_and_tile():
    """x_split 2 at the per-pass rebuild: grid (16, 8, 8), the 16 x-cubes
    half-width, capacity 8 (the half-cube occupancy is at most 5 here)."""
    n = 400
    pos = cube_of(512, 3)
    jout, tout = run_both(8, 1, RELU, both_states(pos), n, 0.1, 1.0,
                          grid=(16, 8, 8), capacity=8, x_split=2)
    assert_clean(assert_same_run(jout, tout, n))
    np.testing.assert_allclose(positions(tout, n),
                               tile_oracle(pos, n, 8, 0.1), rtol=0,
                               atol=ORACLE_ATOL)


def test_torch_xsplit_extras_matches_jax_and_tile():
    """Six cells in one half-cube (x width 0.5) against capacity 4 spill
    into the extras list; the JAX kernel in interpret mode."""
    n, n_pad = 96, 128
    rng = np.random.default_rng(7)
    pos = (rng.uniform(-1, 1, (n_pad, 3)) * [4.0, 2.0, 1.5]).astype(
        np.float32)
    pos[:6] = [0.2, 0.2, 0.2] + rng.uniform(0, 0.24, (6, 3))
    jout, tout = run_both(4, 1, RELU, both_states(pos), n, 0.05, 1.0,
                          grid=(32, 8, 8), capacity=4, force_r_max=1.0,
                          extras_cap=256, extras_block_cap=8, x_split=2)
    assert_clean(assert_same_run(jout, tout, n))
    np.testing.assert_allclose(positions(tout, n),
                               tile_oracle(pos, n, 4, 0.05), rtol=0,
                               atol=ORACLE_ATOL)


def test_torch_xsplit_capacity2_matches_jax_and_tile():
    """Capacity 2 half-cubes, the smallest the JAX bench planner admits
    for thin cubes (a slot's lane wraps every 2): a random box whose
    over-full half-cubes spill into the extras (the JAX kernel in
    interpret mode), and a jittered grid (spacing 0.9 x 1.1 x 1.1) with
    at most one cell a half-cube on the plain pass, whose x-neighbours
    still interact inside the cutoff."""
    n = 400
    pos = cube_of(512, 13, (6.0, 3.0, 3.0))
    jout, tout = run_both(4, 1, RELU, both_states(pos), n, 0.05, 1.0,
                          grid=(64, 8, 8), capacity=2, force_r_max=1.0,
                          extras_cap=1024, extras_block_cap=32, x_split=2)
    assert_clean(assert_same_run(jout, tout, n))
    np.testing.assert_allclose(positions(tout, n),
                               tile_oracle(pos, n, 4, 0.05), rtol=0,
                               atol=ORACLE_ATOL)

    rng = np.random.default_rng(17)
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(8),
                             indexing="ij"), -1).reshape(-1, 3)[:512]
    posg = ((g - 4) * [0.9, 1.1, 1.1]
            + rng.uniform(-0.04, 0.04, (512, 3))).astype(np.float32)
    jout, tout = run_both(4, 1, RELU, both_states(posg), n, 0.05, 1.0,
                          grid=(64, 16, 16), capacity=2, force_r_max=1.0,
                          x_split=2)
    assert_clean(assert_same_run(jout, tout, n))
    np.testing.assert_allclose(positions(tout, n),
                               tile_oracle(posg, n, 4, 0.05), rtol=0,
                               atol=ORACLE_ATOL)


def test_torch_xsplit_rebin_per_pass_matches_jax_and_tile():
    """Per-pass slot-space rebinning on thin cubes (capacity 4, extras
    absorbing the occupancy spikes): the JAX kernel in interpret mode."""
    n = 400
    pos = cube_of(512, 11)
    jout, tout = run_both(4, 1, RELU, both_states(pos), n, 0.05, 1.0,
                          grid=(32, 8, 8), capacity=4, extras_cap=256,
                          extras_block_cap=8, rebin_m_cap=2048,
                          rebin_per_pass=True, x_split=2)
    assert_clean(assert_same_run(jout, tout, n))
    np.testing.assert_allclose(positions(tout, n),
                               tile_oracle(pos, n, 4, 0.05), rtol=0,
                               atol=ORACLE_ATOL)


def test_torch_xsplit_engine_take_step_matches_jax():
    """``LatticeEngine(x_split=2)`` through ``Solution.take_step`` (the
    JAX engine's ``pairwise`` in ``heun_step``; the port's lattice
    integrator): the same two steps, and the all-pairs oracle's."""
    n, n_pad = 200, 256
    pos = cube_of(n_pad, 5)
    j = JSolution(JFloat3, n, engine=JLatticeEngine(
        grid_size=(32, 8, 8), capacity=8, z_block=2, x_split=2))
    t = Solution(Float3, n, device="cpu", engine=LatticeEngine(
        grid_size=(32, 8, 8), capacity=8, z_block=2, x_split=2))
    j.h_X.x[:], j.h_X.y[:], j.h_X.z[:] = pos.T
    j.copy_to_device()
    t.h_X = Float3(*(np.array(pos[:, k]) for k in range(3)))
    t.copy_to_device()
    for _ in range(2):
        j.take_step(0.1, RELU[0])
        t.take_step(0.1, RELU[1])
    want = np.stack([np.asarray(a)[:n] for a in j.d_X])
    got = np.stack([a.numpy()[:n] for a in t.d_X])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, tile_oracle(pos, n, 2, 0.1), rtol=0,
                               atol=ORACLE_ATOL)
    assert not t.validate() and t.engine.x_split == 2
    assert jnp.all(jnp.isfinite(j.d_X.x))


def test_torch_xsplit_plan_of_the_thin_500k_lattice():
    """K1's plan on the thin 500k lattice (grid 128 x 64 x 64, C 5, x reach
    2): the branching brick 2 x 4 x 8 with a halo of 12 x-cubes, 88,164
    bytes (the sum ``csrc/lattice_pair.cu`` lays out), 8,192 blocks; the
    isotropic plan of the main path unchanged; an x reach whose halo
    cannot fit the kernel's 5-bit x place refused."""
    from yalla_tpu_torch.ops.lattice_pallas import (lattice_plan,
                                                    lattice_smem_bytes)
    thin = lattice_plan((128, 64, 64), 5, 12, 2)
    assert thin.brick == (2, 4, 8) and thin.smem == 88_164
    assert thin.blocks == 8192
    assert lattice_smem_bytes((2, 4, 8), 5, 12, 2) == 88_164
    assert tuple(lattice_plan(64, 8, 12)) == ((2, 4, 8), 113_316, 4096)
    # x_split 13: a halo of bx + 26 x-cubes fits 5 bits only at bx <= 6,
    # so the bricks 8 wide are passed over
    assert lattice_plan(64, 2, 12, 13).brick == (1, 1, 4)
    import pytest
    with pytest.raises(ValueError):
        lattice_plan(64, 8, 12, 0)
    with pytest.raises(ValueError, match="limits"):
        lattice_plan(64, 2, 12, 16)


def test_torch_xsplit_engine_settings_carry_across():
    """``interop.engine_from`` carries a JAX lattice engine's thin cubes,
    mover routing and staleness radius; ``bench_engine`` a config's
    ``x_split``; ``Solution.validate`` builds with the engine's thin
    cubes (a state that fits C 2 thin cubes, not C 2 full ones)."""
    from yalla_tpu_torch.interop import bench_engine, engine_from
    j = JLatticeEngine(grid_size=(32, 8, 8), capacity=4, z_block=2,
                       rebuild_every=4, pallas=True, force_r_max=1.0,
                       extras_cap=64, route_movers=2.0)
    t = engine_from(j)
    assert (t.force_r_max, t.route_movers, t.rebuild_every,
            t.extras_cap) == (1.0, 2.0, 4, 64)
    assert engine_from(JLatticeEngine(x_split=2)).x_split == 2
    cfg = dict(gs=[128, 64, 64], C=5, rebuild_every=1, extras_block_cap=24,
               x_split=2, cube=1.0)
    e = bench_engine(cfg)
    assert (e.grid_size, e.capacity, e.x_split) == ((128, 64, 64), 5, 2)
    import pytest
    with pytest.raises(ValueError):
        bench_engine(dict(cfg, rebin=True))
    pos = np.zeros((128, 3), np.float32)
    pos[:2] = [[0.1, 0.1, 0.1], [0.6, 0.1, 0.1]]   # two half-cubes
    pos[2:4] = [[0.2, 0.2, 0.2], [0.7, 0.2, 0.2]]
    for xs, dropped in ((2, False), (1, True)):
        s = Solution(Float3, 4, device="cpu", engine=LatticeEngine(
            grid_size=(8 * xs, 8, 8), capacity=2, z_block=2, x_split=xs))
        s.h_X = Float3(*(np.array(pos[:, k]) for k in range(3)))
        s.copy_to_device()
        assert ("lattice_capacity_dropped" in s.validate()) == dropped
