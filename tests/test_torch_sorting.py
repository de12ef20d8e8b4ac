"""The 5k sorting slice as a whole: ``models/sorting.py`` through
``Solution`` on both all-pairs engines (the central kernel's and the tile
kernel's plain versions on the CPU), against the JAX package.

The JAX forces are bench.py's (``build_sorting_tile``, ``bench.py:697-708``;
``build_sorting_mxu``, ``bench.py:761-775``), copied here because bench.py
defines them inside its builders.  Tolerance: every field within the
reference's ``isclose`` (atol 1e-6 + rtol 1e-2, tests/helpers.py);
friction sums (counts) and every ``__err_*`` flag exact.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu.dtypes import Float3 as JFloat3, make_pt as j_make_pt
from yalla_tpu.ops.central_mxu import central_force as j_central_force
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.pairwise_xla import tile_pairwise as j_tile
from yalla_tpu.solvers import Solution as JSolution, \
    TileEngine as JTileEngine, heun_steps as j_heun_steps
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.interop import (bench_config, bench_engine,
                                     load_settled, pt_from_numpy)
from yalla_tpu_torch.models import sorting as S
from yalla_tpu_torch.ops.central_mxu import central_pairwise_plain
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops.tile_pallas import tile_pairwise_plain
from yalla_tpu_torch.solvers import Solution, TileEngine, heun_step

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SETTLED_5K = REPO / ".bench_cache" / "settled_sorting_p5120_5000_s0_v1.npz"
JCell = j_make_pt("SortCell", "ctype")
P = S.Params()


def j_adhesion(Xi, r, dist, i, j):
    """bench.py:697-708."""
    near = (i != j) & (dist < P.r_max)
    same = r.ctype == 0.0
    strength = jnp.where(same, jnp.where(Xi.ctype > 0.5, 9.0, 1.0), 3.0)
    F = 2 * (P.r_min - dist) * (P.r_max - dist) + (P.r_max - dist) ** 2
    pos_ = dist > 0
    inv = jnp.where(pos_, jax.lax.rsqrt(jnp.where(pos_, dist * dist, 1.0)),
                    0.0)
    w = jnp.where(near, strength * F * inv, 0.0)
    zero = jnp.zeros_like(dist)
    return JCell(x=r.x * w, y=r.y * w, z=r.z * w, ctype=zero)


def _j_coef(dist, Si, Sj, strength):
    """bench.py:764-768."""
    a = jnp.maximum(P.r_max - dist, 0.0)
    b = a + 2.0 * (P.r_min - dist)
    rs = jax.lax.rsqrt(jnp.maximum(dist * dist, 1e-12))
    return strength * (a * b) * rs


j_adhesion_central = j_central_force(
    JCell, _j_coef,
    bilinear={"strength": (
        lambda X: (jnp.ones_like(X.ctype), 2.0 * X.ctype),
        lambda X: (1.0 + 2.0 * X.ctype, 1.0 + 2.0 * X.ctype))},
    name="sorting_adhesion_central")

ENGINES = {
    # bench engine name: (port engine, port force, JAX engine, JAX force)
    "tile_central_mxu": (TileEngine(mxu=True), S.make_adhesion_central(P),
                         JTileEngine(mxu=True), j_adhesion_central),
    "tile_pallas": (TileEngine(pallas=True), S.make_adhesion(P),
                    JTileEngine(pallas=True), j_adhesion),
}


def _flags(aux):
    return {k: float(v) for k, v in aux.items() if k.startswith("__err_")}


@pytest.mark.parametrize("name", list(ENGINES))
def test_slice_take_steps_match_jax(name):
    """``Solution.take_steps(3)`` on a small ball (bench.py's initial
    state recipe) against JAX ``heun_steps`` on the same engine."""
    n, n_pad = 300, 384
    engine, force, j_engine, j_force = ENGINES[name]
    h = S.initial_ball(n, n_pad, seed=4)
    jX, _, jaux = j_heun_steps(
        3, j_engine, j_force, j_friction, None, "com",
        JCell(**{f: jnp.asarray(h[f]) for f in JCell._fields}),
        JFloat3.zeros(n_pad), jnp.int32(n), jnp.float32(P.dt),
        jnp.float32(P.r_max), jnp.int32(0), None)
    sol = Solution(S.Cell, n, engine=engine, cube_size=P.r_max, n_pad=n_pad,
                   device="cpu")
    sol.h_X = S.Cell(**h)
    aux = sol.take_steps(3, P.dt, force)
    out = sol.copy_to_host()
    for f in S.Cell._fields:
        assert isclose(getattr(out, f)[:n], np.asarray(getattr(jX, f))[:n]), f
    assert _flags(aux) == _flags(jaux) == {"__err_non_finite": 0.0}


@pytest.fixture(scope="module")
def settled_5k():
    with np.load(SETTLED_5K) as d:
        return ({f: d["X_" + f] for f in S.Cell._fields},
                {f: d["V_" + f] for f in "xyz"})


@pytest.mark.parametrize("name", list(ENGINES))
def test_plain_pass_matches_jax_on_settled_state(settled_5k, name):
    """One pass of each kernel's plain version on the settled 5000-cell
    state (5120 rows) against JAX's XLA ``tile_pairwise`` with the same
    physics (the oracle its kernels are held against)."""
    n = 5000
    X_np, ov_np = settled_5k
    _, force, _, j_force = ENGINES[name]
    plain = {"tile_central_mxu": central_pairwise_plain,
             "tile_pallas": tile_pairwise_plain}[name]
    X = pt_from_numpy(S.Cell, X_np, device="cpu")
    ov = pt_from_numpy(Float3, ov_np, device="cpu")
    t = plain(force, friction_w_neighbour, X, ov, n)
    j = j_tile(j_force, j_friction,
               JCell(**{f: jnp.asarray(a) for f, a in X_np.items()}),
               JFloat3(**{f: jnp.asarray(a) for f, a in ov_np.items()}),
               jnp.int32(n))
    np.testing.assert_array_equal(t[1].numpy()[:n], np.asarray(j[1])[:n])
    for c in range(3):
        assert isclose(t[2][c].numpy()[:n], np.asarray(j[2][c])[:n]), c
    for f in "xyz":
        assert isclose(getattr(t[0], f).numpy()[:n],
                       np.asarray(getattr(j[0], f))[:n]), f


def test_bench_engine_for_the_sorting_configuration():
    cfg = bench_config(REPO / "bench_state.json", "sorting_5000")
    assert bench_engine(cfg) == TileEngine(mxu=True)
    assert cfg["n_pad"] == 5120
    assert bench_engine(dict(cfg, engine="tile_pallas")) == \
        TileEngine(pallas=True)
    with open(REPO / "bench_state.json") as f:
        assert json.load(f)["sorting_5000"]["builder"] == "build_sorting_mxu"
    X, ov = load_settled(SETTLED_5K, S.Cell, device="cpu")
    sol = Solution(S.Cell, 5000, engine=bench_engine(cfg),
                   n_pad=cfg["n_pad"], device="cpu")
    assert sol.n_pad == X.x.shape[0] == 5120
    assert sol.h_X.x.shape == (5120,) and sol.d_old_v.x.shape == (5120,)


@pytest.mark.parametrize("n_max,n_pad", [
    (5000, None), (5000, 5120), (300, None), (300, 384), (4097, None)])
def test_solution_n_pad_matches_jax(n_max, n_pad):
    assert Solution(S.Cell, n_max, n_pad=n_pad, device="cpu").n_pad == \
        JSolution(JCell, n_max, n_pad=n_pad).n_pad
    with pytest.raises(ValueError, match="n_pad"):
        Solution(S.Cell, n_max, n_pad=n_max - 1, device="cpu")


def test_take_step_is_one_heun_step():
    n, n_pad = 100, 128
    h = S.initial_ball(n, n_pad, seed=2)
    force = S.make_adhesion(P)
    sol = Solution(S.Cell, n, engine=TileEngine(), device="cpu")
    sol.h_X = S.Cell(**h)
    aux = sol.take_step(P.dt, force)
    X, ov, aux1 = heun_step(TileEngine(), force, friction_w_neighbour, "com",
                            pt_from_numpy(S.Cell, h, device="cpu"),
                            Float3.zeros(n_pad), n,
                            P.dt, 1.0)
    for a, b in zip(sol.d_X, X):
        assert torch.equal(a, b)
    for a, b in zip(sol.d_old_v, ov):
        assert torch.equal(a, b)
    assert _flags(aux) == _flags(aux1)
