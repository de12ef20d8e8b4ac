"""The windowed Gabriel pass (``ops/grid_xla.gabriel_windowed``) against
the JAX package's on the CPU, and the ``GabrielEngine`` routing that
reaches it.

The counterparts of ``tests/test_solvers.py``'s windowed tests (windowed
against gather, the windowed, lattice and gather forms agreeing on the
stable ids, misfits salvaged exactly and the salvage capacity's flag),
each held against JAX's own ``gabriel_windowed`` on the same numpy
inputs; the relaxation engine of the growth_w_wall example on both sides.

Tolerances: counters (the friction sums) and every ``__err_*`` flag
exact; forces and ``sum_v`` within atol 1e-5 (f32 rounding and summation
order, as ``tests/test_solvers.py`` holds the forms against each other);
trajectories within the reference's ``isclose`` (atol 1e-6 + rtol 1e-2,
``tests/helpers.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from test_torch_grid import (assert_sums_match, both, j_spring,
                             random_tissue, spring)
from yalla_tpu import Float3 as JFloat3
from yalla_tpu import Solution as JSolution
from yalla_tpu.ops.common import friction_on_background as j_background
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.grid_xla import gabriel_pairwise as j_gather
from yalla_tpu.ops.grid_xla import gabriel_windowed as j_windowed
from yalla_tpu.solvers import GabrielEngine as JGabrielEngine
from yalla_tpu_torch import solvers
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.interop import engine_from
from yalla_tpu_torch.ops import grid_xla as TG
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops.gabriel_pallas import gabriel_lattice_plain
from yalla_tpu_torch.solvers import GabrielEngine, Solution

torch.set_num_threads(2)

FLAGS = ("__err_gabriel_window", "__err_grid_overflow",
         "__err_gabriel_candidates")


def windowed_both(pos, ov, n, forces=(j_spring, spring), **kw):
    """(JAX pass, port pass) of ``gabriel_windowed`` with ``kw``."""
    jX, jov, tX, tov = both(pos, ov)
    j = j_windowed(forces[0], j_friction, jX, jov, jnp.int32(n),
                   jnp.float32(1.0), **kw)
    t = TG.gabriel_windowed(forces[1], friction_w_neighbour, tX, tov, n,
                            1.0, **kw)
    return j, t


def flag(aux, k):
    return float(np.max(np.asarray(aux[k])))


@pytest.mark.parametrize("subgroup,window_flag", [(16, 0.0), (None, 1.0)])
def test_windowed_matches_jax(subgroup, window_flag):
    """A seeded 1,900-point tissue in 2,048 rows at the JAX engine's
    window settings (block 256, window 64) by subgroups of 16 and by
    whole blocks: every output equal to JAX's, per-point flags included.
    A window of 64 entries is too narrow for a whole block of 256 points:
    more than 256 misfit, both packages raise ``__err_gabriel_window``
    and both lose the pairs of the same misfits (those past the first 256
    stable ids)."""
    n, pos, ov = random_tissue(seed=29, n=1900, n_pad=2048, half=5.5)
    j, t = windowed_both(pos, ov, n, grid_size=16, i_block=256,
                         window_cap=64, max_candidates=64, row_cap=48,
                         subgroup=subgroup)
    assert set(t[3]) == set(j[3]) == set(FLAGS)
    assert_sums_match(t, j, n, f"windowed subgroup {subgroup}")
    assert flag(t[3], "__err_gabriel_window") == \
        flag(j[3], "__err_gabriel_window") == window_flag
    for k in FLAGS[1:]:
        assert flag(t[3], k) == flag(j[3], k) == 0.0, k
    kept = int((t[1][:n] > 0).sum())
    assert kept > 0.9 * n if not window_flag else kept < 0.9 * n


def test_windowed_matches_gather():
    """``test_solvers.py::test_gabriel_windowed_matches_gather`` on the
    port: the 700-point tissue, windowed (block 64, window 256) against
    the port's and JAX's gather forms, and against JAX's windowed form."""
    n, pos, ov = random_tissue()
    kw = dict(grid_size=16, i_block=64, window_cap=256, max_candidates=64)
    j, t = windowed_both(pos, ov, n, **kw)
    jX, jov, tX, tov = both(pos, ov)
    jg = j_gather(j_spring, j_friction, jX, jov, jnp.int32(n),
                  jnp.float32(1.0), grid_size=16, row_cap=48,
                  max_candidates=64)
    tg = TG.gabriel_pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0,
                             grid_size=16, row_cap=48, max_candidates=64)
    for k in FLAGS:
        assert flag(t[3], k) == flag(j[3], k) == 0.0, k
    assert_sums_match(t, j, n, "windowed vs JAX windowed")
    assert_sums_match(t, jg, n, "windowed vs JAX gather")
    np.testing.assert_array_equal(t[1].numpy(), tg[1].numpy())


def test_windowed_lattice_and_gather_agree_on_stable_ids():
    """``test_solvers.py::test_gabriel_stable_id_semantics`` on the port:
    the force leaves point 0 (mid-tissue) out by its id, so a sorted-slot
    id handed to the force would move its force to another cell.  The
    port's windowed pass equals JAX's, and the port's three forms agree."""
    def j_wall_spring(Xi, r, dist, i, j):
        near = (i != j) & (i != 0) & (j != 0) & (dist < 1.0)
        w = jnp.where(near, (0.8 - dist), 0.0)
        safe = jnp.where(dist > 0, dist, 1.0)
        return JFloat3(x=r.x * w / safe, y=r.y * w / safe, z=r.z * w / safe)

    def wall_spring(Xi, r, dist, i, j):
        near = (i != j) & (i != 0) & (j != 0) & (dist < 1.0)
        w = torch.where(near, (0.8 - dist), 0.0)
        safe = torch.where(dist > 0, dist, 1.0)
        return Float3(x=r.x * w / safe, y=r.y * w / safe, z=r.z * w / safe)

    rng = np.random.default_rng(23)
    n, n_pad = 500, 512
    pos = rng.uniform(-3.5, 3.5, (n_pad, 3)).astype(np.float32)
    pos[0] = [0.3, 0.2, 0.1]
    ov = np.zeros((3, n_pad), np.float32)
    j, t = windowed_both(pos, ov, n, forces=(j_wall_spring, wall_spring),
                         grid_size=16, i_block=64, window_cap=256,
                         max_candidates=64)
    assert float(t[0].x[0]) == float(np.asarray(j[0].x)[0]) == 0.0
    for k in FLAGS:
        assert flag(t[3], k) == flag(j[3], k) == 0.0, k
    assert_sums_match(t, j, n, "windowed stable ids vs JAX")
    _, _, tX, tov = both(pos, ov)
    args = (wall_spring, friction_w_neighbour, tX, tov, n, 1.0)
    gather = TG.gabriel_pairwise(*args, grid_size=16, row_cap=48,
                                 max_candidates=64)
    lattice = gabriel_lattice_plain(*args, grid_size=16, capacity=8,
                                    max_candidates=20)
    for other in (gather, lattice):
        for a, b in zip(t[0], other[0]):
            np.testing.assert_allclose(a.numpy()[:n], b.numpy()[:n],
                                       atol=1e-5)
        np.testing.assert_array_equal(t[1].numpy()[:n], other[1].numpy()[:n])


def probe_strip():
    """``test_solvers.py::test_gabriel_windowed_misfit_salvage``'s state:
    a sparse 28-cube probe strip under a 250-point filler row one z-plane
    up, so that the strip's subgroup cannot fit one window per row and
    its ends misfit.  (n, positions, zero old_v)"""
    rng = np.random.default_rng(3)
    n, n_pad = 2000, 2048
    pos = rng.uniform(2, 14, (n_pad, 3)).astype(np.float32)
    pos[0:28, 0] = -13.5 + np.arange(28)
    pos[0:28, 1] = -14.0
    pos[0:28, 2] = -14.0
    pos[28:30] = [[-13.6, -14.0, -12.5], [-13.4, -14.0, -12.5]]
    pos[30:280, 0] = np.linspace(-8.4, 8.4, 250)
    pos[30:280, 1] = -14.0
    pos[30:280, 2] = -12.5
    pos[280:282] = [[13.4, -14.0, -12.5], [13.6, -14.0, -12.5]]
    return n, pos, np.zeros((3, n_pad), np.float32)


PROBE = dict(grid_size=32, i_block=64, window_cap=128, max_candidates=64,
             row_cap=48)


def misfit_count(pos, n, **kw):
    """How many active points misfit their subgroup's windows in the
    port's geometry (``window_geometry`` and the median windows)."""
    X = Float3(*(torch.as_tensor(pos[:, k].copy()) for k in range(3)))
    n_pad = pos.shape[0]
    _, g, Wr, We = TG.window_geometry(n_pad, kw["i_block"],
                                      kw["window_cap"], kw.get("subgroup"))
    tables = TG.build_grid(X, n, 1.0, kw["grid_size"])
    rs, re = TG.row_ranges(tables, tables.cid[tables.order],
                           kw["grid_size"])
    G = n_pad // g
    act = (tables.order < n).reshape(G, g)
    _, fit = TG._median_windows(rs.reshape(G, g, 9), re.reshape(G, g, 9),
                                act, n_pad, Wr, We)
    return int((act & ~fit).sum())


def test_misfits_salvaged_exactly_and_the_capacity_flagged():
    """``test_solvers.py::test_gabriel_windowed_misfit_salvage`` on the
    port: the misfits are salvaged exactly (equal to JAX's windowed pass
    and to the gather form, no flag); with one salvage place too few,
    both packages raise ``__err_gabriel_window``, so the two count the
    same misfits; with ``salvage_cap`` 1 both raise it."""
    n, pos, ov = probe_strip()
    m = misfit_count(pos, n, **PROBE)
    assert 2 <= m < 64
    j, t = windowed_both(pos, ov, n, salvage_cap=64, **PROBE)
    for k in FLAGS:
        assert flag(t[3], k) == flag(j[3], k) == 0.0, k
    assert_sums_match(t, j, n, "salvaged windowed vs JAX")
    _, _, tX, tov = both(pos, ov)
    tg = TG.gabriel_pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0,
                             grid_size=32, row_cap=48, max_candidates=64)
    for a, b in zip(t[0], tg[0]):
        np.testing.assert_allclose(a.numpy()[:n], b.numpy()[:n], atol=1e-5)
    for cap, raised in ((m, 0.0), (m - 1, 1.0), (1, 1.0)):
        j, t = windowed_both(pos, ov, n, salvage_cap=cap, **PROBE)
        assert flag(t[3], "__err_gabriel_window") == \
            flag(j[3], "__err_gabriel_window") == raised, cap
        assert t[3]["__err_gabriel_window"].shape == (pos.shape[0],)


def test_n_pad_off_the_segments_raises():
    """``n_pad % 64 != 0`` is refused with ``ValueError`` (JAX asserts)."""
    n, pos, ov = random_tissue(n=90, n_pad=96)
    _, _, tX, tov = both(pos, ov)
    with pytest.raises(ValueError, match="n_pad % 64"):
        TG.gabriel_windowed(spring, friction_w_neighbour, tX, tov, n, 1.0,
                            grid_size=16)


def test_engine_reaches_the_windowed_pass(monkeypatch):
    """``GabrielEngine(windowed=True, lattice=False)`` runs
    ``gabriel_windowed`` with the engine's window settings; a window
    ``(i_offset, i_size)`` and ``windowed=False`` run the gather form, as
    in JAX; ``engine_from`` carries the window settings of a JAX engine."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return TG.gabriel_windowed(*args, **kw)
    monkeypatch.setattr(solvers, "gabriel_windowed", spy)
    n, pos, ov = random_tissue()
    _, _, tX, tov = both(pos, ov)
    e = GabrielEngine(grid_size=16, row_cap=48, max_candidates=64,
                      windowed=True, lattice=False, window_cap=128,
                      salvage_cap=32, subgroup=8)
    e.pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0)
    assert len(calls) == 1
    assert {k: calls[0][k] for k in ("window_cap", "salvage_cap",
                                     "subgroup", "i_block")} == \
        dict(window_cap=128, salvage_cap=32, subgroup=8, i_block=256)
    e.pairwise(spring, friction_w_neighbour, tX, tov, n, 1.0, i_offset=128,
               i_size=128)
    GabrielEngine(grid_size=16, windowed=False, lattice=False).pairwise(
        spring, friction_w_neighbour, tX, tov, n, 1.0)
    assert len(calls) == 1
    j = JGabrielEngine(grid_size=64, row_cap=128, lattice=False,
                       window_cap=96, salvage_cap=16, subgroup=None)
    assert engine_from(j) == GabrielEngine(
        grid_size=64, row_cap=128, lattice=False, window_cap=96,
        salvage_cap=16, subgroup=None)
    d = engine_from(JGabrielEngine())
    assert (d.windowed, d.window_cap, d.salvage_cap, d.subgroup) == \
        (True, 64, 256, 16)


def test_growth_w_wall_relaxation_matches_jax():
    """The relaxation of ``examples/growth_w_wall.py:116``, its engine
    (``GabrielEngine(grid_size=64, row_cap=128, lattice=False)``,
    ``windowed`` left at its default) on both sides: 3 steps of the
    ReLU force with the background friction and the wall force, from a
    seed ball of 300 cells in 1,024 rows.  Every flag equal (0), positions
    within ``isclose``."""
    from test_torch_links import jax_example
    from yalla_tpu.links import wall_forces as j_wall_forces
    from yalla_tpu_torch.inits import random_sphere
    from yalla_tpu_torch.links import wall_forces
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.common import friction_on_background
    G = jax_example()
    n0, n_max = 300, 1000
    seed = Solution(Float3, n_max, device="cpu")
    seed.h_n = n0
    seed.h_X.z[0] = -W.mean_dist
    random_sphere(0.5, seed, n_0=1, rng=np.random.default_rng(7))
    seed.h_X.z[1:n0] = np.abs(seed.h_X.z[1:n0])
    engine = JGabrielEngine(grid_size=64, row_cap=128, lattice=False)
    js = JSolution(JFloat3, n_max, n_pad=seed.n_pad, engine=engine)
    ts = Solution(Float3, n_max, n_pad=seed.n_pad, device="cpu",
                  engine=engine_from(engine))
    assert ts.engine.windowed and not ts.engine.lattice
    for sol in (js, ts):
        for f in "xyz":
            getattr(sol.h_X, f)[:] = getattr(seed.h_X, f)
        sol.h_n = n0
        sol.copy_to_device()
    for _ in range(3):
        jaux = js.take_step(G.dt, G.relu_force, pw_friction=j_background,
                            gen_forces=j_wall_forces(G.WALL))
        taux = ts.take_step(W.dt, W.relu_force,
                            pw_friction=friction_on_background,
                            gen_forces=wall_forces(W.WALL))
        jf = {k: float(v) for k, v in jaux.items() if k.startswith("__err_")}
        tf = {k: float(v) for k, v in taux.items() if k.startswith("__err_")}
        assert jf == tf and not any(tf.values()), (jf, tf)
        assert "__err_gabriel_window" in tf
    jh, th = js.copy_to_host(), ts.copy_to_host()
    for f in "xyz":
        assert isclose(getattr(th, f)[:n0], getattr(jh, f)[:n0]), f
    assert np.abs(th.z[1:n0] - seed.h_X.z[1:n0]).max() > 1e-3   # it moved
