"""The lattice path's edges, on the CPU: the extras block-table overflow
flag on grids the JAX kernel refuses; JAX's XLA route (``pallas=False``:
no overflow extras, the port's pass still through its kernel wrappers)
in ``lattice_heun_steps`` and ``LatticeEngine`` against the JAX
package's own ``pallas=False``; and the integrator's refusals of the
combinations the JAX integrator asserts against.

``extras_block_overflow`` is counting, so it is exact: against a numpy
count of the same tables on every grid, and against the JAX kernel's own
tables (plain jnp) wherever that kernel accepts the grid.  The
``pallas=False`` runs: trajectories within atol 1e-5 (as
``tests/test_torch_rebin.py`` holds the cadences), every ``__err_*``
flag exact.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_pt
from test_torch_grid import assert_sums_match
from test_torch_rebin import (_uniform_state, assert_clean, assert_same_run,
                              spilling_state)
from yalla_tpu import Solution as JSolution
from yalla_tpu import dtypes as jdt
from yalla_tpu.inits import relu_force as j_relu
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.lattice_pallas import _extras_tables
from yalla_tpu.solvers import GenericForce as JGenericForce
from yalla_tpu.solvers import LatticeEngine as JLatticeEngine
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.inits import relu_force as t_relu
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.ops import lattice_pallas, lattice_pour
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.solvers import GenericForce, LatticeEngine, Solution
from yalla_tpu_torch.ops.lattice_pallas import (_y_block,
                                                extras_block_overflow)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N, N_PAD, E_CAP = 1500, 1536, 2048


def _points(grid, seed):
    """``N`` points in ``N_PAD`` rows, uniform over the cubes of ``grid``
    (cube size 1) within 4 cubes of its centre, so that cubes of capacity
    1 overflow into hundreds of extras."""
    rng = np.random.default_rng(seed)
    h = {}
    for f, g in zip("xyz", grid):
        lo, hi = max(-(g // 2), -4), min(g - g // 2, 4)
        h[f] = np.zeros(N_PAD, np.float32)
        h[f][:N] = rng.uniform(lo, hi, N)
    return h


def _table_overflow(lay, grid, zb, yb, cap):
    """Entries past ``cap`` in the per-(z, y)-block tables of the live
    extras, each tabled in every block its +-1-cube reach meets; the last
    block of an axis is ragged where the block does not divide it."""
    _, gy, gz = grid
    nz, ny = -(-gz // zb), -(-gy // yb)
    live = (lay.epid < lay.slot_of.shape[0]).numpy()
    cz = np.clip(np.floor(lay.E.z.numpy()).astype(int) + gz // 2, 0, gz - 1)
    cy = np.clip(np.floor(lay.E.y.numpy()).astype(int) + gy // 2, 0, gy - 1)
    counts = np.zeros((nz, ny), int)
    for z, y in zip(cz[live], cy[live]):
        for bz in {min(max((z + d) // zb, 0), nz - 1) for d in (-1, 1)}:
            for by in {min(max((y + d) // yb, 0), ny - 1) for d in (-1, 1)}:
                counts[bz, by] += 1
    return int(np.maximum(counts - cap, 0).sum())


# (grid, z_block, the y block the flag must take, whether JAX accepts it)
FLAG_GRIDS = [((11, 11, 11), 2, 16, False),     # nothing divides 11
              ((16, 24, 8), 2, 8, True),        # gy % 8 == 0: JAX's 8 rows
              ((12, 32, 6), 3, 16, True),       # JAX's default 16 rows
              ((8, 20, 8), 2, 16, False)]       # gy % 8 != 0, z divides


@pytest.mark.parametrize("grid,zb,yb,jax_accepts", FLAG_GRIDS)
@pytest.mark.parametrize("block_cap", [8, 24, 2048])
def test_extras_block_overflow_on_any_grid(grid, zb, yb, jax_accepts,
                                           block_cap):
    h = _points(grid, seed=4)
    tX = pt_from_numpy(tdt.Float3, h, device="cpu")
    lay = TL.lattice_build(tX, tX, N, 1.0, grid, 1, E_CAP)
    assert int(lay.n_extras) > 300 and int(lay.n_dropped) == 0
    assert _y_block(grid[1]) == yb
    cap = max(block_cap // 8 * 8, 8)
    got = float(extras_block_overflow(lay, 1.0, grid, zb, block_cap))
    assert got == _table_overflow(lay, grid, zb, yb, cap)
    if block_cap != 24:      # 8 entries overflow, 2048 hold every extra
        assert (got > 0) == (block_cap == 8)
    if jax_accepts:
        jX = jax_pt(jdt.Float3, h)
        ref = JL.lattice_build(jX, jX, jnp.int32(N), jnp.float32(1.0), grid,
                               1, E_CAP)
        _, _, j_over = _extras_tables(ref, [0, 1, 2], False, grid[2] // zb,
                                      grid[1] // yb, zb, yb,
                                      jnp.float32(1.0), grid, cap)
        assert got == float(j_over)


# the cadences of lattice_heun_steps on JAX's XLA route (pallas=False),
# at tests/test_torch_rebin.py's uniform state and settings: (n_steps,
# rebuild_every, options); ``gen`` is a pull towards the origin
PLAIN_CADENCES = {
    "rebuild_1": (2, 1, {}),
    "resident_certified": (4, 4, dict(force_r_max=1.0)),
    "rebin_per_chunk": (4, 2, dict(force_r_max=1.0, rebin_m_cap=2048)),
    "rebin_per_pass": (2, 1, dict(rebin_m_cap=2048, rebin_per_pass=True)),
    "gen_in_the_slot_loop": (2, 2, dict(gen=True)),
    "x_split": (2, 1, dict(x_split=2, grid=(16, 8, 8))),
}


def _j_pull(X, n, k):
    return jdt.Float3(x=-k * X.x, y=-k * X.y, z=-k * X.z)


def _t_pull(X, n, k):
    return tdt.Float3(x=-k * X.x, y=-k * X.y, z=-k * X.z)


def plain_both(n_steps, rebuild_every, state, n, *, grid=8, gen=False,
               **kw):
    """``lattice_heun_steps(pallas=False)`` of both packages on ``state``
    (relu_force, friction_w_neighbour, the COM fix, C 16, z_block 2, dt
    0.01, cube 1.2).  Returns (JAX output, port output)."""
    (jX, jov), (tX, tov) = state
    jgen = dict(gen=JGenericForce(_j_pull, None, ("x", "y", "z")),
                gen_args=jnp.float32(0.05)) if gen else {}
    tgen = dict(gen=GenericForce(_t_pull, None, ("x", "y", "z")),
                gen_args=0.05) if gen else {}
    fr = kw.pop("force_r_max", None)
    jout = JL.lattice_heun_steps(
        n_steps, rebuild_every, j_relu, j_friction, "com", grid, 16, 2, jX,
        jov, jnp.int32(n), jnp.float32(0.01), jnp.float32(1.2),
        jnp.int32(0), pallas=False,
        force_r_max=None if fr is None else jnp.float32(fr), **jgen, **kw)
    tout = TL.lattice_heun_steps(
        n_steps, rebuild_every, t_relu, friction_w_neighbour, "com", grid,
        16, 2, tX, tov, n, 0.01, 1.2, 0, pallas=False, force_r_max=fr,
        **tgen, **kw)
    return jout, tout


@pytest.mark.parametrize("case", list(PLAIN_CADENCES))
def test_plain_route_matches_jax(case):
    """Each cadence on JAX's XLA route, the port's against JAX's: the same
    trajectory, aux keys and flags (every flag 0: the resident cadence
    certified, no mover-list overflow)."""
    n_steps, every, kw = PLAIN_CADENCES[case]
    n, state = _uniform_state()
    jout, tout = plain_both(n_steps, every, state, n, **kw)
    f = assert_same_run(jout, tout, n)
    assert_clean(f)
    if "force_r_max" in kw:
        assert f["__err_stale"] == 0.0 and f["stale_max_disp"] > 0
    if "rebin_m_cap" in kw:
        assert "__err_rebin_overflow" in f


def test_plain_route_runs_through_the_kernel_wrappers(monkeypatch):
    """``pallas=False`` changes only whether extras are allowed: the pour
    and the pair pass still go through their kernel wrappers (the CUDA
    kernels on GPU tensors), once each per pass, on the integrator and on
    the engine, with a layout that holds no extras."""
    calls = {"pour": 0, "pass": 0}
    pour = lattice_pour.pour_pallas
    pass_ = lattice_pallas.lattice_pairwise_pallas

    def spy_pour(*a, **k):
        calls["pour"] += 1
        return pour(*a, **k)

    def spy_pass(pw_int, pw_friction, layout, *a, **k):
        assert layout.E is None
        calls["pass"] += 1
        return pass_(pw_int, pw_friction, layout, *a, **k)
    monkeypatch.setattr(lattice_pour, "pour_pallas", spy_pour)
    monkeypatch.setattr(lattice_pallas, "lattice_pairwise_pallas", spy_pass)
    X = pt_from_numpy(tdt.Float3, _points((8, 8, 8), seed=0), device="cpu")
    out = TL.lattice_heun_steps(2, 1, t_relu, friction_w_neighbour, "com",
                                8, 8, 2, X, X, N, 0.01, 1.0, 0, pallas=False)
    assert np.isfinite(out[0].x.numpy()).all()
    assert calls == {"pour": 4, "pass": 4}
    LatticeEngine(grid_size=8, capacity=8, pallas=False,
                  extras_cap=64).pairwise(t_relu, friction_w_neighbour, X,
                                          X, N, 1.0)
    assert calls == {"pour": 5, "pass": 5}


def test_plain_engine_drops_the_extras_as_jax_does():
    """``LatticeEngine(pallas=False, extras_cap=256)`` ignores its extras,
    as the JAX engine does: on a state whose clump spills 7 cells past
    capacity 4, both packages' passes drop them (``__err_lattice_dropped``
    7, no ``__err_extras_block``) and equal the port's ``extras_cap=0``
    engine, where the kernel route holds them in its extras."""
    n, ((jX, jov), (tX, tov)) = spilling_state()
    kw = dict(grid_size=(32, 8, 8), capacity=4, z_block=2, extras_cap=256)
    j = JLatticeEngine(pallas=False, **kw).pairwise(
        j_relu, j_friction, jX, jov, jnp.int32(n), jnp.float32(1.2))
    t = LatticeEngine(pallas=False, **kw).pairwise(
        t_relu, friction_w_neighbour, tX, tov, n, 1.2)
    assert set(t[3]) == set(j[3])
    assert "__err_extras_block" not in t[3]
    assert float(t[3]["__err_lattice_dropped"]) == \
        float(j[3]["__err_lattice_dropped"]) == 7.0
    assert_sums_match(t, j, n, "plain engine vs JAX's")
    none = LatticeEngine(pallas=False, **dict(kw, extras_cap=0)).pairwise(
        t_relu, friction_w_neighbour, tX, tov, n, 1.2)
    for a, b in zip(list(t[0]) + [t[1]], list(none[0]) + [none[1]]):
        assert torch.equal(a, b)
    kernel = LatticeEngine(**kw).pairwise(t_relu, friction_w_neighbour, tX,
                                          tov, n, 1.2)
    assert float(kernel[3]["__err_lattice_dropped"]) == 0.0


def test_plain_engine_take_steps_matches_jax():
    """``Solution.take_steps`` on ``LatticeEngine(pallas=False)`` (the JAX
    engine's default) on both sides: 2 steps at rebuild 1, positions
    within atol 1e-5, every flag equal (0)."""
    n, ((jX, _), (tX, _)) = _uniform_state()
    kw = dict(grid_size=8, capacity=16, z_block=2)
    js = JSolution(jdt.Float3, n, n_pad=1280, cube_size=1.2,
                   engine=JLatticeEngine(**kw))
    ts = Solution(tdt.Float3, n, n_pad=1280, cube_size=1.2, device="cpu",
                  engine=LatticeEngine(pallas=False, **kw))
    assert js.engine.pallas is False
    for sol, X in ((js, jX), (ts, tX)):
        for f in "xyz":
            getattr(sol.h_X, f)[:] = np.asarray(getattr(X, f))
        sol.h_n = n
        sol.copy_to_device()
    jaux = js.take_steps(2, 0.01, j_relu)
    taux = ts.take_steps(2, 0.01, t_relu)
    for k in jaux:
        if k.startswith("__err_"):
            assert float(np.max(np.asarray(jaux[k]))) == \
                float(taux[k].max()) == 0.0, k
    jh, th = js.copy_to_host(), ts.copy_to_host()
    for f in "xyz":
        np.testing.assert_allclose(getattr(th, f)[:n], getattr(jh, f)[:n],
                                   rtol=0, atol=1e-5)


def _heun(**options):
    X = pt_from_numpy(tdt.Float3, _points((8, 8, 8), seed=0), device="cpu")
    kw = dict(rebuild_every=1, n_steps=1)
    kw.update(options)
    rebuild_every, n_steps = kw.pop("rebuild_every"), kw.pop("n_steps")

    def force(Xi, r, dist, i, j):
        return r
    return TL.lattice_heun_steps(n_steps, rebuild_every, force,
                                 friction_w_neighbour, "com", 8, 8, 2, X, X,
                                 N, 0.1, 1.0, 0, **kw)


def _j_gen(X, n, args):
    return X


# the combinations the JAX integrator asserts against
# (yalla_tpu/ops/lattice_xla.py:745, :757-760, :762, :763-764, :1142),
# with words of the port's message
JAX_ASSERTS = {
    "extras_without_kernel": (dict(pallas=False, extras_cap=64),
                              "pallas=True"),
    "n_steps_not_a_multiple": (dict(n_steps=3, rebuild_every=2),
                               "multiple of rebuild_every"),
    "x_split_resident": (dict(n_steps=2, rebuild_every=2, x_split=2),
                         "x_split"),
    "x_split_rebin_per_step": (dict(x_split=2, rebin_m_cap=64), "x_split"),
    "extras_with_generic_forces": (dict(extras_cap=64, gen=_j_gen),
                                   "generic forces"),
    "rebin_per_pass_resident": (dict(n_steps=2, rebuild_every=2,
                                     rebin_m_cap=64, rebin_per_pass=True),
                                "rebin_per_pass"),
}


@pytest.mark.parametrize("case", list(JAX_ASSERTS))
def test_lattice_heun_steps_raises_where_jax_asserts(case):
    """The port raises ``ValueError`` on exactly the combinations the JAX
    integrator asserts against (it asserts while tracing, so the JAX call
    stops before any work)."""
    options, words = JAX_ASSERTS[case]
    with pytest.raises(ValueError, match=words):
        _heun(**options)
    kw = dict(options)
    rebuild_every, n_steps = kw.pop("rebuild_every", 1), kw.pop("n_steps", 1)
    if "gen" in kw:
        from yalla_tpu.solvers import GenericForce
        kw["gen"] = GenericForce(kw["gen"])
    jX = jdt.Float3(*(jnp.zeros(128) for _ in range(3)))
    with pytest.raises(AssertionError):
        JL.lattice_heun_steps(n_steps, rebuild_every, lambda *a: a[1],
                              None, "com", 8, 8, 2, jX, jX, jnp.int32(1),
                              jnp.float32(0.1), jnp.float32(1.0),
                              jnp.int32(0), **{"pallas": True, **kw})


def test_lattice_heun_steps_refuses_without_asserts():
    """The refusals are raised, not asserted: they hold under ``python -O``,
    which strips asserts."""
    code = (
        "import torch\n"
        "from yalla_tpu_torch.ops.lattice_xla import lattice_heun_steps\n"
        "assert False, 'asserts are stripped'\n"
        "cases = [(1, 4, {}), (2, 2, dict(x_split=2)),\n"
        "         (1, 1, dict(x_split=2, rebin_m_cap=64)),\n"
        "         (1, 1, dict(extras_cap=64, gen=print)),\n"
        "         (2, 2, dict(rebin_m_cap=64, rebin_per_pass=True)),\n"
        "         (1, 1, dict(pallas=False, extras_cap=64))]\n"
        "for steps, every, kw in cases:\n"
        "    try:\n"
        "        lattice_heun_steps(steps, every, None, None, 'com', 8, 8,\n"
        "                           2, None, None, 0, 0.1, 1.0, 0, **kw)\n"
        "    except ValueError as e:\n"
        "        print('refused:', type(e).__name__, e)\n")
    run = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("refused:")]
    assert len(lines) == 6 and "rebuild_every" in lines[0]
    assert "extras require pallas=True" in lines[-1]
