"""yalla_tpu_torch against yalla_tpu: point types, binning, the branching
force and the polarity subset, and the port's import and device rules.

The same numpy inputs (made from a seed) go to both packages.  Tolerances:
per-pair force values rtol 1e-5 / atol 1e-6 (f32 rounding: XLA and torch
differ in the last ulp of sqrt, rsqrt and sin/cos); cube ids, masks and
neighbour counters exact.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yalla_tpu import dtypes as jdt
from yalla_tpu.models import branching as JB
from yalla_tpu.ops import common as jcommon
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.polarity import (bending_post_pair as j_post_pair,
                                polarity_precompute3 as j_pre3)
from yalla_tpu.solvers import augment as j_augment
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.interop import (BENCH_EXTRAS_CAP, bench_config,
                                     bench_engine, params_from,
                                     pt_from_numpy, pt_to_numpy)
from yalla_tpu_torch.models import branching as TB
from yalla_tpu_torch.ops import common as tcommon
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.lattice_pallas import _force_spec
from yalla_tpu_torch.ops.lattice_pour import pour_pallas
from yalla_tpu_torch.polarity import (bending_post_pair as t_post_pair,
                                      polarity_precompute3 as t_pre3)
from yalla_tpu_torch.solvers import Solution, augment as t_augment

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SETTLED_600 = REPO / ".bench_cache" / "settled_branching_600_s0_v1.npz"
RTOL, ATOL = 1e-5, 1e-6


# ---- helpers shared by the test_torch_* files ----------------------------

def jax_pt(pt_type, arrays):
    """A JAX Pt from a mapping of numpy arrays."""
    return pt_type(**{f: jnp.asarray(arrays[f]) for f in pt_type._fields})


def settled_600():
    """Numpy fields of the committed settled 600-cell branching state:
    ({Cell field: f32[640]}, {x, y, z: f32[640]} old_v)."""
    with np.load(SETTLED_600) as d:
        X = {f: d["X_" + f] for f in JB.Cell._fields}
        ov = {f: d["V_" + f] for f in "xyz"}
    return X, ov


def assert_close(port, ref, what, rtol=RTOL, atol=ATOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def random_cells(rng, shape):
    """Branching-cell fields with both cell types and polar angles."""
    return {
        "x": rng.uniform(-1, 1, shape), "y": rng.uniform(-1, 1, shape),
        "z": rng.uniform(-1, 1, shape),
        "theta": rng.uniform(0, np.pi, shape),
        "phi": rng.uniform(-np.pi, np.pi, shape),
        "u": rng.uniform(-0.1, 1, shape), "v": rng.uniform(-0.1, 1, shape),
        "ctype": (rng.random(shape) < 0.5).astype(np.float64),
    }


def _f32(d):
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


# ---- the port's own rules ------------------------------------------------

def test_import_pulls_in_no_jax():
    code = ("import sys; import yalla_tpu_torch, yalla_tpu_torch.interop, "
            "yalla_tpu_torch.models.branching, "
            "yalla_tpu_torch.ops.lattice_pallas; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'yalla_tpu.')) or "
            "m == 'yalla_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Solution(TB.Cell, 100, device="cuda")


def _entry_points():
    """Each of the port's entry points that places state on a device,
    called without ``device``; each returns the device its state went to."""
    from types import SimpleNamespace

    from yalla_tpu_torch.interop import links_from, load_settled
    from yalla_tpu_torch.links import Links
    from yalla_tpu_torch.models.growth_w_wall import half_space_solution
    from yalla_tpu_torch.solvers import TileEngine
    jlinks = SimpleNamespace(n_max=4, strength=0.5, d_n=0,
                             d_a=np.zeros(128, np.int32),
                             d_b=np.zeros(128, np.int32))
    return {
        "Solution": lambda: Solution(TB.Cell, 10).d_old_v.x.device,
        "Links": lambda: Links(4).d_a.device,
        "half_space_solution":
            lambda: half_space_solution(20, TileEngine()).d_X.x.device,
        "pt_from_numpy": lambda: pt_from_numpy(
            tdt.Float3, {f: np.zeros(4, np.float32) for f in "xyz"}).x.device,
        "load_settled": lambda: load_settled(SETTLED_600, TB.Cell)[0].x.device,
        "links_from": lambda: links_from(jlinks).d_a.device,
    }


@pytest.mark.parametrize("name", ["Solution", "Links", "half_space_solution",
                                  "pt_from_numpy", "load_settled",
                                  "links_from"])
def test_entry_points_default_to_the_card(name):
    """Without ``device`` every entry point goes to CUDA: on a machine with
    a GPU its state lies there, without one it raises."""
    call = _entry_points()[name]
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_kernel_wrappers_refuse_other_devices_and_forces():
    S = torch.zeros((3, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pour_pallas(S, torch.zeros(5, dtype=torch.int32), 4, 1)

    def plain_force(Xi, r, dist, i, j):
        return Xi
    with pytest.raises(ValueError, match="no CUDA functor"):
        _force_spec(plain_force, tcommon.friction_w_neighbour)
    with pytest.raises(ValueError, match="r_max"):
        _force_spec(TB.make_force(TB.Params(r_max=1.2)),
                    tcommon.friction_w_neighbour)
    assert _force_spec(TB.make_force(TB.Params()),
                       tcommon.friction_w_neighbour)[0]["dF"]


# ---- dtypes / common -------------------------------------------------------

def test_pt_arithmetic_matches_jax():
    rng = np.random.default_rng(0)
    a = _f32({f: rng.normal(size=7) for f in "xyz"})
    b = _f32({f: rng.normal(size=7) for f in "xyz"})
    ja, jb = jax_pt(jdt.Float3, a), jax_pt(jdt.Float3, b)
    ta = pt_from_numpy(tdt.Float3, a, device="cpu")
    tb = pt_from_numpy(tdt.Float3, b, device="cpu")
    for j, t in ((ja + jb, ta + tb), (ja - jb, ta - tb), (-ja, -ta),
                 (ja * 0.3, ta * 0.3), (0.3 * ja, 0.3 * ta),
                 (ja / 7.0, ta / 7.0),
                 (ja.replace(y=jb.x), ta.replace(y=tb.x))):
        assert type(t) is tdt.Float3
        for f in "xyz":
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    Cell = tdt.make_pt("TestCell", "w")
    assert Cell is tdt.make_pt("TestCell", "w")
    assert Cell._fields == ("x", "y", "z", "w")


@pytest.mark.parametrize("grid_size", [16, (32, 16, 8)])
def test_cube_ids_and_out_of_grid_exact(grid_size):
    rng = np.random.default_rng(1)
    n_pad, n = 512, 480
    # a quarter of the points lie outside the grid (clipped + flagged)
    pos = _f32({f: rng.uniform(-10, 10, n_pad) for f in "xyz"})
    jX = jax_pt(jdt.Float3, pos)
    tX = pt_from_numpy(tdt.Float3, pos, device="cpu")
    for cube in (1.0, 0.7):
        np.testing.assert_array_equal(
            tcommon.cube_ids(tX, n, cube, grid_size).numpy(),
            np.asarray(jcommon.cube_ids(jX, jnp.int32(n), jnp.float32(cube),
                                        grid_size)))
        np.testing.assert_array_equal(
            tcommon.out_of_grid_mask(tX, n, cube, grid_size).numpy(),
            np.asarray(jcommon.out_of_grid_mask(
                jX, jnp.int32(n), jnp.float32(cube), grid_size)))
    assert tcommon.grid_dims(grid_size) == jcommon.grid_dims(grid_size)


def test_lattice_planner_matches_jax():
    for pos_max, occ in ((10.0, 3), (24.6, 9), (40.0, 14)):
        assert TL.lattice_grid_for(pos_max, 1.0, 8) == \
            JL.lattice_grid_for(pos_max, 1.0, 8)
        assert TL.pick_lattice_dims(pos_max, 1.0, occ) == \
            JL.pick_lattice_dims(pos_max, 1.0, occ)


# ---- the branching force and the polarity subset -------------------------

def _pair_block(seed, B=64, K=48):
    rng = np.random.default_rng(seed)
    ci = _f32(random_cells(rng, (B, 1)))
    cj = _f32(random_cells(rng, (1, K)))
    # ids drawn from a small range so i == j (the diagonal) occurs
    ii, jj = rng.integers(0, 40, (B, 1)), rng.integers(0, 40, (1, K))
    return ci, cj, ii, jj


@pytest.mark.parametrize("which", ["full", "offdiag"])
def test_branching_force_matches_jax(which):
    ci, cj, ii, jj = _pair_block(2)
    jXi = j_augment(jax_pt(JB.Cell, ci), 0, j_pre3)
    jXj = j_augment(jax_pt(JB.Cell, cj), 0, j_pre3)
    tXi = t_augment(pt_from_numpy(TB.Cell, ci, device="cpu"), 0, t_pre3)
    tXj = t_augment(pt_from_numpy(TB.Cell, cj, device="cpu"), 0, t_pre3)
    jr, tr = jXi - jXj, tXi - tXj
    # the same distances go in, so gates and counters see one input
    dist = np.sqrt(np.asarray(jr.x * jr.x + jr.y * jr.y + jr.z * jr.z))
    assert (dist < 1).sum() > 100
    jf, tf = JB.make_force(JB.Params()), TB.make_force(TB.Params())
    if which == "offdiag":
        jf, tf = jf.offdiag, tf.offdiag
    jF, jaux = jf(jXi, jr, jnp.asarray(dist), jnp.asarray(ii),
                  jnp.asarray(jj))
    tF, taux = tf(tXi, tr, torch.as_tensor(dist), torch.as_tensor(ii),
                  torch.as_tensor(jj))
    assert type(tF) is TB.Cell and set(taux) == set(jaux)
    shape = dist.shape
    for f in TB.Cell._fields:
        assert_close(np.broadcast_to(getattr(tF, f).numpy(), shape),
                     np.broadcast_to(getattr(jF, f), shape), f)
    np.testing.assert_array_equal(taux["epi_nbs"].numpy(),
                                  np.asarray(jaux["epi_nbs"]))
    for k in ("pg_x", "pg_y", "pg_z"):
        assert_close(taux[k], jaux[k], k)


def test_polarity_precompute_and_post_pair_match_jax():
    rng = np.random.default_rng(3)
    n = 256
    cells = _f32(random_cells(rng, n))
    cells["theta"][:4] = [0.0, np.pi, 1e-12, np.pi / 2]   # pole guard
    jX = jax_pt(JB.Cell, cells)
    tX = pt_from_numpy(TB.Cell, cells, device="cpu")
    jp, tp = j_pre3(jX, n), t_pre3(tX, n)
    assert list(jp) == list(tp)
    for k in jp:
        assert_close(tp[k], jp[k], k)
    G = _f32({k: rng.normal(size=n) for k in ("pg_x", "pg_y", "pg_z")})
    F = _f32({f: rng.normal(size=n) for f in JB.Cell._fields})
    jF, jaux = j_post_pair(jax_pt(JB.Cell, F),
                           {k: jnp.asarray(v) for k, v in G.items()}, jX)
    tF, taux = t_post_pair(pt_from_numpy(TB.Cell, F, device="cpu"),
                           {k: torch.as_tensor(v) for k, v in G.items()}, tX)
    assert jaux == {} and taux == {}
    for f in JB.Cell._fields:
        assert_close(getattr(tF, f), getattr(jF, f), f)


def test_tile_pairwise_matches_jax():
    from yalla_tpu.ops.pairwise_xla import tile_pairwise as j_tile
    from yalla_tpu_torch.ops.pairwise_xla import tile_pairwise as t_tile
    X, ov = settled_600()
    n = 600
    jXa = j_augment(jax_pt(JB.Cell, X), n, j_pre3)
    tXa = t_augment(pt_from_numpy(TB.Cell, X, device="cpu"), n, t_pre3)
    jout = j_tile(JB.make_force(JB.Params()), jcommon.friction_w_neighbour,
                  jXa, jax_pt(jdt.Float3, ov), jnp.int32(n), j_block=128)
    tout = t_tile(TB.make_force(TB.Params()), tcommon.friction_w_neighbour,
                  tXa, pt_from_numpy(tdt.Float3, ov, device="cpu"), n,
                  j_block=128)
    for f in JB.Cell._fields:
        assert_close(getattr(tout[0], f), getattr(jout[0], f), f,
                     atol=1e-5)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    for c in range(3):
        assert_close(tout[2][c], jout[2][c], f"sum_v{c}", atol=1e-5)
    np.testing.assert_array_equal(tout[3]["epi_nbs"].numpy(),
                                  np.asarray(jout[3]["epi_nbs"]))


# ---- interop ----------------------------------------------------------------

def test_interop_carries_params_state_and_bench_config():
    p = params_from(TB.Params, JB.Params(D_v=0.3))
    assert p == TB.Params(D_v=0.3)
    cfg = bench_config(REPO / "bench_state.json", "branching_500000")
    e = bench_engine(cfg)
    assert (e.grid_size, e.capacity, e.rebuild_every) == ((64, 64, 64), 8, 1)
    assert (e.extras_cap, e.extras_block_cap, e.z_block, e.pallas) == \
        (BENCH_EXTRAS_CAP, 24, 2, True)
    X, ov = settled_600()
    jX = jax_pt(JB.Cell, X)
    back = pt_to_numpy(pt_from_numpy(TB.Cell, jX, device="cpu"))
    for f in JB.Cell._fields:
        np.testing.assert_array_equal(back[f], X[f])
