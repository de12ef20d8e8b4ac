"""The port's all-pairs pass (``ops/tile_pallas.py``, kernel K3's plain
version on the CPU) against the JAX package, mirroring
``tests/test_tile_pallas.py``: the same contract as ``tile_pairwise``,
the i == j diagonal, friction sums and aux channels included.

The same numpy state (made from a seed) goes to both packages; JAX runs
its TPU kernel in interpret mode.  Tolerance: the reference's ``isclose``
(atol 1e-6 + rtol 1e-2, tests/helpers.py) on every sum and field;
friction sums and the ``nbs`` counter exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from test_tile_pallas import Cell as JCell, _force as j_force, _state
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.tile_pallas import tile_pairwise_pallas as j_tile_pallas
from yalla_tpu.solvers import TileEngine as JTileEngine, \
    heun_steps as j_heun_steps
from yalla_tpu_torch.dtypes import Float3, make_pt
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops.tile_pallas import (tile_pairwise_pallas,
                                             tile_pairwise_plain)
from yalla_tpu_torch.solvers import TileEngine, heun_steps

torch.set_num_threads(2)

Cell = make_pt("TPC", "w", "ctype")


def _force(Xi, r, dist, i, j):
    """test_tile_pallas ``_force`` in torch: type-dependent clipped
    spring + diagonal reaction + aux count."""
    diag = i == j
    near = (~diag) & (dist < 1.0)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(near, (0.6 - dist) / safe, 0.0)
    w = w * torch.where(r.ctype == 0.0, 1.5, 0.7)
    dw = torch.where(near, -0.1 * r.w, 0.0) \
        + torch.where(diag, 0.02 * Xi.w, 0.0)
    zero = torch.zeros_like(dist)
    return (Cell(x=r.x * w, y=r.y * w, z=r.z * w, w=dw, ctype=zero),
            {"nbs": torch.where(near, 1.0, 0.0)})


def _both(n_pad, seed):
    jX, jov = _state(n_pad, seed)
    return (jX, jov), (pt_from_numpy(Cell, jX), pt_from_numpy(Float3, jov))


@pytest.mark.parametrize("fn", [tile_pairwise_pallas, tile_pairwise_plain])
def test_tile_pallas_matches_jax(fn):
    n, n_pad = 200, 256
    (jX, jov), (X, ov) = _both(n_pad, 5)
    j = j_tile_pallas(j_force, j_friction, jX, jov, jnp.int32(n))
    before = tile_pairwise_pallas.launches
    t = fn(_force, friction_w_neighbour, X, ov, n)
    assert tile_pairwise_pallas.launches == before   # no kernel on the CPU
    for f in JCell._fields:
        assert isclose(getattr(t[0], f).numpy()[:n],
                       np.asarray(getattr(j[0], f))[:n]), f
    np.testing.assert_array_equal(t[1].numpy()[:n], np.asarray(j[1])[:n])
    for c in range(3):
        assert isclose(t[2][c].numpy()[:n], np.asarray(j[2][c])[:n]), c
    np.testing.assert_array_equal(t[3]["nbs"].numpy()[:n],
                                  np.asarray(j[3]["nbs"])[:n])


def test_tile_engine_pallas_step():
    """3 steps of ``TileEngine(pallas=True)`` against the same steps in
    JAX (its kernel in interpret mode)."""
    n, n_pad = 120, 128
    (jX, jov), (X, ov) = _both(n_pad, 9)
    jXe, _, jaux = j_heun_steps(
        3, JTileEngine(pallas=True), j_force, j_friction, None, "com", jX,
        jov, jnp.int32(n), jnp.float32(0.05), jnp.float32(1.0),
        jnp.int32(0), None)
    Xe, _, aux = heun_steps(3, TileEngine(pallas=True), _force,
                            friction_w_neighbour, "com", X, ov, n, 0.05, 1.0)
    for f in ("x", "y", "z", "w"):
        assert isclose(getattr(Xe, f).numpy()[:n],
                       np.asarray(getattr(jXe, f))[:n]), f
    np.testing.assert_array_equal(aux["nbs"].numpy()[:n],
                                  np.asarray(jaux["nbs"])[:n])
    assert {k: float(v) for k, v in aux.items() if k.startswith("__err_")} \
        == {k: float(v) for k, v in jaux.items() if k.startswith("__err_")}


def test_tile_engine_routing_matches_jax_on_cpu(monkeypatch):
    """On the CPU, ``None`` resolves to the plain path, and the TPU
    kernels' ``n_pad % 128`` rule keeps an unaligned state off the kernel
    wrappers, as in JAX."""
    from yalla_tpu_torch.models import sorting as S
    from yalla_tpu_torch.ops import central_mxu, tile_pallas
    calls = []
    for mod, name, tag in ((tile_pallas, "tile_pairwise_pallas", "tile"),
                           (central_mxu, "central_pairwise_mxu", "central")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, tag=tag:
                            calls.append(tag) or fn(*a))
    p = S.Params()
    for n_pad in (128, 100):
        X = pt_from_numpy(S.Cell, S.initial_ball(90, n_pad))
        ov = Float3.zeros(n_pad)
        for engine in (TileEngine(), TileEngine(pallas=True),
                       TileEngine(mxu=True)):
            for force in (S.make_adhesion(p), S.make_adhesion_central(p)):
                engine.pairwise(force, friction_w_neighbour, X, ov, 90, 1.0)
    # n_pad 128: TileEngine() plain twice; pallas=True: tile, central;
    # mxu=True: plain (hand-written, pallas None), central.  n_pad 100:
    # plain throughout
    assert calls == ["tile", "central", "central"]
