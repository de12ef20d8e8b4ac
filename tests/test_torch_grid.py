"""The port's spatial-hash grid, gather-form Gabriel engine, solver
selection and generic forces against the JAX package.

The same numpy inputs (made from a seed) go to both packages.  Tolerances:
grid tables, friction sums (counts) and ``__err_*`` flags exact; forces
and ``sum_v`` within atol 1e-5 (as ``tests/test_solvers.py`` holds its
Gabriel forms against each other: f32 rounding and summation order);
trajectories within the reference's ``isclose`` (atol 1e-6 + rtol 1e-2).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu import Float3 as JFloat3
from yalla_tpu import Solution as JSolution
from yalla_tpu.inits import regular_hexagon
from yalla_tpu.ops import grid_xla as JG
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.solvers import GabrielEngine as JGabrielEngine
from yalla_tpu.solvers import GridEngine as JGridEngine
from yalla_tpu.solvers import LatticeEngine as JLatticeEngine
from yalla_tpu_torch.dtypes import Float3, pt_zeros_like
from yalla_tpu_torch.interop import engine_from
from yalla_tpu_torch.ops import grid_xla as TG
from yalla_tpu_torch.ops.common import (friction_on_background,
                                        friction_w_neighbour)
from yalla_tpu_torch.solvers import (GabrielEngine, GenericForce, GridEngine,
                                     LatticeEngine, Solution, TileEngine)

torch.set_num_threads(2)

L_0 = 0.5


def j_spring(Xi, r, dist, i, j):
    """``tests/test_solvers.py::clipped_spring``."""
    valid = (i != j) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, (L_0 - dist) / safe, 0.0)
    return JFloat3(x=r.x * w, y=r.y * w, z=r.z * w)


def spring(Xi, r, dist, i, j):
    valid = (i != j) & (dist < 1.0)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(valid, (L_0 - dist) / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def random_tissue(seed=17, n=700, n_pad=768, half=4.0):
    """``test_solvers.py:320-327``'s state: positions uniform in a cube,
    old_v uniform in [0, 1); numpy f32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (n_pad, 3)).astype(np.float32)
    ov = np.stack([rng.random(n_pad) for _ in range(3)]).astype(np.float32)
    return n, pos, ov


def both(pos, ov):
    """(JAX X, JAX old_v, port X, port old_v) of numpy arrays."""
    jX = JFloat3(*(jnp.asarray(pos[:, k]) for k in range(3)))
    jov = JFloat3(*(jnp.asarray(ov[k]) for k in range(3)))
    tX = Float3(*(torch.as_tensor(pos[:, k].copy()) for k in range(3)))
    tov = Float3(*(torch.as_tensor(ov[k].copy()) for k in range(3)))
    return jX, jov, tX, tov


def assert_sums_match(t, j, n, what):
    """Port pass ``t`` against JAX pass ``j`` on the first ``n`` rows."""
    for f, a, b in zip("xyz", t[0], j[0]):
        np.testing.assert_allclose(a.numpy()[:n], np.asarray(b)[:n],
                                   atol=1e-5, err_msg=f"{what} F.{f}")
    np.testing.assert_array_equal(t[1].numpy()[:n], np.asarray(j[1])[:n])
    for c in range(3):
        np.testing.assert_allclose(t[2][c].numpy()[:n],
                                   np.asarray(j[2][c])[:n], atol=1e-5,
                                   err_msg=f"{what} sum_v[{c}]")
    for k in j[3]:    # per-point flags, or scalar ones
        a, b = t[3][k].numpy(), np.asarray(j[3][k])
        np.testing.assert_array_equal(a[:n] if a.ndim else a,
                                      b[:n] if b.ndim else b, err_msg=k)


@pytest.mark.parametrize("grid_size", [1, 16, 50])
def test_row_offsets_match_jax(grid_size):
    """The nine rows of three neighbour cubes, made on the device, are
    JAX's list."""
    got = TG._row_offsets(grid_size)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JG._row_offsets(grid_size)))


@pytest.mark.parametrize("cube_size", [1.0, 0.7])
def test_build_grid_tables_match_jax(cube_size):
    n, pos, _ = random_tissue(seed=3, n=900, n_pad=1024, half=5.0)
    jt = JG.build_grid(JFloat3(*(jnp.asarray(pos[:, k]) for k in range(3))),
                       jnp.int32(n), jnp.float32(cube_size), 20)
    tt = TG.build_grid(Float3(*(torch.as_tensor(pos[:, k].copy())
                                for k in range(3))), n, cube_size, 20)
    for name in TG.GridTables._fields:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    rs, re = TG.row_ranges(tt, tt.cid[:50], 20)
    jrs, jre = JG.row_ranges(jt, jt.cid[:50], 20)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(jrs))
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))


@pytest.mark.parametrize("row_cap", [48, 4])
def test_grid_pairwise_matches_jax(row_cap):
    """Cutoff pair sums on the 700-point tissue; at ``row_cap`` 4 rows
    overflow, and the per-point ``__err_grid_overflow`` must agree."""
    n, pos, ov = random_tissue()
    jX, jov, tX, tov = both(pos, ov)
    j = JG.grid_pairwise(j_spring, j_friction, jX, jov, jnp.int32(n),
                         jnp.float32(1.0), grid_size=16, row_cap=row_cap)
    t = TG.grid_pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0,
                         grid_size=16, row_cap=row_cap)
    assert float(t[3]["__err_grid_overflow"].max()) == (row_cap == 4)
    assert_sums_match(t, j, n, f"grid row_cap {row_cap}")


@pytest.mark.parametrize("max_candidates", [64, 8])
def test_gabriel_pairwise_matches_jax(max_candidates):
    """The gather-form Gabriel pass on ``test_solvers.py:311-344``'s
    700-point case; at ``max_candidates`` 8 lists overflow and the
    per-point ``__err_gabriel_candidates`` must agree."""
    n, pos, ov = random_tissue()
    jX, jov, tX, tov = both(pos, ov)
    j = JG.gabriel_pairwise(j_spring, j_friction, jX, jov, jnp.int32(n),
                            jnp.float32(1.0), grid_size=16, row_cap=48,
                            max_candidates=max_candidates)
    t = TG.gabriel_pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0,
                            grid_size=16, row_cap=48,
                            max_candidates=max_candidates)
    over = float(t[3]["__err_gabriel_candidates"].max())
    assert over == (max_candidates == 8)
    assert_sums_match(t, j, n, f"gabriel NC {max_candidates}")


def count_neighbours(Xi, r, dist, i, j):
    dF = type(Xi)(*(torch.zeros_like(dist) for _ in Xi))
    return dF, {"n_nbs": torch.where((i != j) & (dist <= 1.0), 1.0, 0.0)}


def test_gabriel_hexagon_has_6_4_3_neighbours():
    """``test_solvers.py::test_gabriel_solver`` on the port: interior
    points of the hexagonal lattice have 6 Gabriel neighbours, the
    boundary alternates 3 and 4 (ref test_solvers.cu:354-381).  The
    positions are the JAX package's ``regular_hexagon``."""
    jpts = JSolution(JFloat3, 19, solver="tile")
    regular_hexagon(0.5, jpts)
    pts = Solution(Float3, 19, solver="gabriel", grid_size=5, cube_size=1.0,
                   gabriel_coefficient=0.8, row_cap=32, device="cpu")
    assert pts.engine == GabrielEngine(grid_size=5, row_cap=32)
    pts.h_X = Float3(*(np.array(a) for a in jpts.d_X))
    aux = pts.take_step(0.1, count_neighbours)
    n_nbs = aux["n_nbs"].numpy().astype(int)
    assert list(n_nbs[:7]) == [6] * 7
    assert list(n_nbs[7:19]) == [3 if i % 2 else 4 for i in range(7, 19)]


def test_solver_selection_matches_jax():
    for solver in ("grid", "gabriel"):
        kw = dict(solver=solver, grid_size=24, row_cap=40,
                  gabriel_coefficient=0.7)
        j = JSolution(JFloat3, 300, **kw).engine
        assert Solution(Float3, 300, **kw,
                        device="cpu").engine == engine_from(j)
        port = dataclasses.asdict(engine_from(j))
        assert port == {k: v for k, v in dataclasses.asdict(j).items()
                        if k in port}
    assert Solution(Float3, 300, solver="grid", grid_size=24,
                    row_cap=40, device="cpu").engine == \
        GridEngine(grid_size=24, row_cap=40)
    assert Solution(Float3, 300, solver="tile",
                    device="cpu").engine == TileEngine()
    assert Solution(Float3, 300, solver="lattice",
                    grid_size=32, device="cpu").engine == \
        LatticeEngine(grid_size=32)
    # picked from the state at first use, as in the JAX package
    # (tests/test_torch_solver_select.py holds the picks against JAX's)
    for kw in (dict(n_max=300, solver="auto"),
               dict(n_max=30_000, solver="grid")):
        assert Solution(Float3, device="cpu", **kw).engine is None
        assert JSolution(JFloat3, **kw).engine is None
    with pytest.raises(ValueError, match="unknown solver"):
        Solution(Float3, 300, solver="mesh", device="cpu")
    # the all-pairs engine carries across with its settings; the sharded
    # lattice engine (multi-device) has no port yet
    from yalla_tpu.parallel.lattice_spmd import ShardedLatticeEngine
    from yalla_tpu.solvers import TileEngine as JTileEngine
    assert engine_from(JTileEngine(pallas=True, j_block=256)) == \
        TileEngine(pallas=True, j_block=256)
    with pytest.raises(ValueError, match="no port"):
        engine_from(object.__new__(ShardedLatticeEngine))
    # the TPU kernel's shape rules, as JAX's test_gabriel_lattice_autoselect
    # _rules pins them (the port's routing does not consult them)
    assert GabrielEngine().lattice is None
    assert GabrielEngine(grid_size=64)._lattice_fits()
    assert GabrielEngine(grid_size=(64, 48, 48))._lattice_fits()
    assert not GabrielEngine(grid_size=50)._lattice_fits()
    assert not GabrielEngine(grid_size=64, capacity=7)._lattice_fits()
    for g in (JGabrielEngine(grid_size=64), JGabrielEngine(grid_size=50),
              JGridEngine(grid_size=30)):
        assert getattr(engine_from(g), "_lattice_fits", lambda: None)() == \
            getattr(g, "_lattice_fits", lambda: None)()


def test_gabriel_engine_routes_by_device_on_the_cpu():
    """On CPU tensors ``GabrielEngine()`` runs the windowed form (as JAX off
    the TPU), ``windowed=False`` the gather form; ``lattice=True`` runs
    the lattice pass's plain version."""
    from yalla_tpu_torch.ops.gabriel_pallas import gabriel_lattice_plain
    n, pos, ov = random_tissue()
    _, _, tX, tov = both(pos, ov)
    e = GabrielEngine(grid_size=16, row_cap=48, max_candidates=64)
    got = e.pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0)
    want = TG.gabriel_windowed(spring, friction_w_neighbour, tX, tov, n, 1.0,
                               grid_size=16, i_block=256, window_cap=64,
                               max_candidates=64, row_cap=48, subgroup=16)
    assert set(got[3]) == set(want[3]) == {"__err_grid_overflow",
                                           "__err_gabriel_candidates",
                                           "__err_gabriel_window"}
    assert torch.equal(got[1], want[1])
    e = dataclasses.replace(e, windowed=False)
    got = e.pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0)
    want = TG.gabriel_pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0,
                               grid_size=16, row_cap=48, max_candidates=64)
    assert set(got[3]) == set(want[3]) == {"__err_grid_overflow",
                                           "__err_gabriel_candidates"}
    assert torch.equal(got[1], want[1])
    e = dataclasses.replace(e, lattice=True, max_candidates=20)
    got = e.pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0)
    want = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n,
                                 1.0, grid_size=16, capacity=8,
                                 max_candidates=20)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])


def _push(X, n):
    """dX[1] = (1, 0, 0) (ref test_solvers.cu:133-144)."""
    dX = pt_zeros_like(X)
    return dX.replace(x=dX.x.index_fill(0, torch.tensor([1]), 1.0))


def no_pw_int(Xi, r, dist, i, j):
    return type(Xi)(*(torch.zeros_like(dist) for _ in Xi))


@pytest.mark.parametrize("solver", ["tile", "grid", "gabriel"])
def test_generic_forces_and_friction(solver):
    """``test_solvers.py::test_generic_forces`` and ``test_friction`` on
    the port's engines: a generic push moves a lone point 0.5 in one unit
    step with the COM fixed; against the background two points separate
    by 1.0, with neighbour friction by 0.75."""
    pw = no_pw_int if solver == "tile" else spring
    pts = Solution(Float3, 2, solver=solver, device="cpu")
    pts.h_X.z[:2] = [10, 0]
    pts.take_step(1.0, pw, gen_forces=_push)
    h = pts.copy_to_host()
    assert isclose(h.x[1], 0.5) and isclose(h.x[0], -0.5)
    assert isclose(h.y[1], 0.0) and isclose(h.z[1], 0.0)

    pts = Solution(Float3, 2, solver=solver, device="cpu")
    pts.h_X.x[:2] = [0.0, 0.5]
    for _ in range(10):
        pts.take_step(0.05, no_pw_int, pw_friction=friction_on_background,
                      gen_forces=GenericForce(lambda X, n, a: _push(X, n)))
    h = pts.copy_to_host()
    assert isclose(h.x[1] - h.x[0], 1.0)
    pts.h_X.x[:2] = [0.0, 0.5]
    pts.copy_to_device()   # old_v carries over, as in the reference
    for _ in range(10):
        pts.take_step(0.05, no_pw_int, gen_forces=_push)
    h = pts.copy_to_host()
    assert isclose(h.x[1] - h.x[0], 0.75)


def _j_push(X, n):
    """``_push`` in the JAX package."""
    dX = jax.tree.map(jnp.zeros_like, X)
    return dX.replace(x=dX.x.at[1].set(1.0))


def test_lattice_integrator_refuses_generic_forces():
    """Generic forces on the lattice: at the per-pass rebuild
    ``take_steps`` runs them through ``heun_steps`` on the lattice
    engine's ``pairwise`` (the push moves the lone point as on every
    engine); at ``rebuild_every=4`` inside the slot-order integrator, as
    the JAX package does, on the JAX package's trajectory (atol 1e-5)."""
    pts = Solution(Float3, 2, engine=LatticeEngine(grid_size=16),
                   device="cpu")
    pts.h_X.z[:2] = [5, 0]
    pts.take_steps(1, 1.0, spring, gen_forces=_push)
    h = pts.copy_to_host()
    assert isclose(h.x[1], 0.5) and isclose(h.x[0], -0.5)
    n, pos, _ = random_tissue(seed=3, n=60, n_pad=128, half=2.0)
    j = JSolution(JFloat3, n, engine=JLatticeEngine(grid_size=16,
                                                    rebuild_every=4))
    t = Solution(Float3, n, engine=LatticeEngine(grid_size=16,
                                                 rebuild_every=4),
                 device="cpu")
    for k, f in enumerate("xyz"):
        getattr(j.h_X, f)[:n] = pos[:n, k]
        getattr(t.h_X, f)[:n] = pos[:n, k]
    j.copy_to_device()
    t.copy_to_device()
    j.take_steps(4, 0.1, j_spring, gen_forces=_j_push)
    aux = t.take_steps(4, 0.1, spring, gen_forces=_push)
    assert "stale_max_disp" in aux
    for a, b in zip(t.d_X, j.d_X):
        np.testing.assert_allclose(a.numpy()[:n], np.asarray(b)[:n],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("extras_cap", [0, 64])
def test_take_step_on_a_resident_lattice_engine(extras_cap):
    """``Solution.take_step`` on a ``LatticeEngine(rebuild_every=4)`` runs
    one ``heun_steps`` step on the engine's ``pairwise`` (a build per
    pass), as the JAX package's does: on the 60-cell tissue with
    ``spring`` and the generic push, without extras and with 64 of them
    (JAX's ``pallas=True`` engine), the positions within atol 1e-5 of
    JAX's and the flags equal, and no warning; at ``rebuild_every`` 1
    the slot-order integrator of ``take_steps`` gives the same step
    within rtol 1e-5."""
    n, pos, _ = random_tissue(seed=3, n=60, n_pad=128, half=2.0)
    j = JSolution(JFloat3, n, engine=JLatticeEngine(
        grid_size=16, rebuild_every=4, extras_cap=extras_cap,
        pallas=bool(extras_cap)))
    t = Solution(Float3, n, engine=LatticeEngine(
        grid_size=16, rebuild_every=4, extras_cap=extras_cap), device="cpu")
    for k, f in enumerate("xyz"):
        getattr(j.h_X, f)[:n] = pos[:n, k]
        getattr(t.h_X, f)[:n] = pos[:n, k]
    j.copy_to_device()
    t.copy_to_device()
    j.take_step(0.1, j_spring, gen_forces=_j_push)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t.take_step(0.1, spring, gen_forces=_push)
    for a, b in zip(t.d_X, j.d_X):
        np.testing.assert_allclose(a.numpy()[:n], np.asarray(b)[:n],
                                   rtol=0, atol=1e-5)
    flags = {k for k in j.aux if k.startswith("__err_")}
    assert flags and flags <= set(t.aux)
    for k in flags:
        assert float(t.aux[k].max()) == float(np.max(np.asarray(j.aux[k]))), k

    slot = Solution(Float3, n, engine=LatticeEngine(
        grid_size=16, extras_cap=extras_cap), device="cpu")
    for k, f in enumerate("xyz"):
        getattr(slot.h_X, f)[:n] = pos[:n, k]
    one = Solution(Float3, n, engine=slot.engine, device="cpu")
    one.h_X = slot.h_X
    slot.take_steps(1, 0.1, spring)
    one.take_step(0.1, spring)
    for a, b in zip(one.d_X, slot.d_X):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_check_grid_capacity_matches_jax():
    n, pos, _ = random_tissue(seed=5, n=600, n_pad=640, half=2.5)
    for row_cap in (8, 64):
        j = JSolution(JFloat3, n, solver="grid", grid_size=16,
                      row_cap=row_cap)
        t = Solution(Float3, n, solver="grid", grid_size=16,
                     row_cap=row_cap, device="cpu")
        for k, f in enumerate("xyz"):
            getattr(j.h_X, f)[:n] = pos[:n, k]
            getattr(t.h_X, f)[:n] = pos[:n, k]
        j.copy_to_device()
        assert t.check_grid_capacity() == j.check_grid_capacity() \
            == (row_cap == 8)
    assert not Solution(Float3, n, device="cpu").check_grid_capacity()
