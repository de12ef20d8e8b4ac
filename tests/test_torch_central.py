"""The port's central-force path (``ops/central_mxu.py``, kernel K4's plain
version on the CPU) against the JAX package, mirroring
``tests/test_central.py``.

The same numpy ball (made from a seed) goes to both packages.  Tolerance:
the reference's ``isclose`` (atol 1e-6 + rtol 1e-2, tests/helpers.py) on
every sum, as test_central.py holds the JAX kernel to the generic path;
friction sums (counts of ``dist < 1`` decisions) and flags exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from test_central import (Cell as JCell, _ball, central_adhesion as
                          j_central, handwritten_adhesion as j_handwritten)
from yalla_tpu.dtypes import Float3 as JFloat3
from yalla_tpu.ops.central_mxu import central_pairwise_mxu as j_mxu
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.pairwise_xla import tile_pairwise as j_tile
from yalla_tpu.solvers import TileEngine as JTileEngine, \
    heun_steps as j_heun_steps
from yalla_tpu_torch.dtypes import Float3, make_pt
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.models import sorting as S
from yalla_tpu_torch.ops.central_mxu import (CENTRAL_SENTINEL, _kernel_spec,
                                             central_force,
                                             central_pairwise_mxu,
                                             central_pairwise_plain)
from yalla_tpu_torch.ops.common import (friction_on_background,
                                        friction_w_neighbour)
from yalla_tpu_torch.ops.pairwise_xla import tile_pairwise
from yalla_tpu_torch.solvers import TileEngine, heun_steps
from yalla_tpu_torch.utils import profiling

torch.set_num_threads(2)

Cell = make_pt("CentralCell", "ctype")
R_MAX, R_MIN = 1.0, 0.5


def central_adhesion(aux=None, diag=None):
    """tests/test_central.py ``central_adhesion`` in torch."""
    def coef(dist, Si, Sj, strength):
        a = torch.clamp(R_MAX - dist, min=0.0)
        b = a + 2.0 * (R_MIN - dist)
        rs = torch.rsqrt(torch.clamp(dist * dist, min=1e-12))
        return strength * (a * b) * rs

    return central_force(
        Cell, coef,
        bilinear={"strength": (
            lambda X: (torch.ones_like(X.ctype), 2.0 * X.ctype),
            lambda X: (1.0 + 2.0 * X.ctype, 1.0 + 2.0 * X.ctype))},
        aux=aux, diag=diag)


def _nbs(dist, Si, Sj, strength):
    return (dist < R_MAX).to(torch.float32)


def _j_nbs(dist, Si, Sj, strength):
    return (dist < R_MAX).astype(jnp.float32)


def _diag(Xi):
    return Cell(x=torch.zeros_like(Xi.x), y=torch.zeros_like(Xi.x),
                z=torch.zeros_like(Xi.x), ctype=0.1 * (1.0 - Xi.ctype))


def _j_diag(Xi):
    return JCell(x=jnp.zeros_like(Xi.x), y=jnp.zeros_like(Xi.x),
                 z=jnp.zeros_like(Xi.x), ctype=0.1 * (1.0 - Xi.ctype))


def _both(n, n_pad, ov_scale=True):
    """The test_central ball in both packages, with its old_v."""
    jX = _ball(n, n_pad)
    jov = JFloat3(x=jX.x * 0.01, y=jX.y * -0.02, z=jX.z * 0.005) \
        if ov_scale else JFloat3.zeros(n_pad)
    X = pt_from_numpy(Cell, jX, device="cpu")
    ov = pt_from_numpy(Float3, jov, device="cpu")
    return (jX, jov), (X, ov)


def _assert_sums(j, t, n, fields=("x", "y", "z")):
    for f in fields:
        assert isclose(getattr(t[0], f).numpy()[:n],
                       np.asarray(getattr(j[0], f))[:n]), f"F.{f}"
    np.testing.assert_array_equal(t[1].numpy()[:n], np.asarray(j[1])[:n])
    for c in range(3):
        assert isclose(t[2][c].numpy()[:n], np.asarray(j[2][c])[:n]), \
            f"sum_v[{c}]"
    for k in j[3]:
        np.testing.assert_array_equal(t[3][k].numpy()[:n],
                                      np.asarray(j[3][k])[:n], err_msg=k)


def test_central_wrapper_matches_handwritten():
    """The port's central_force, evaluated generically on the port's
    tile_pairwise, against JAX's hand-written adhesion on JAX's."""
    n, n_pad = 200, 256
    (jX, jov), (X, ov) = _both(n, n_pad)
    j = j_tile(j_handwritten, j_friction, jX, jov, jnp.int32(n))
    t = tile_pairwise(central_adhesion(), friction_w_neighbour, X, ov, n)
    _assert_sums(j, t, n)


def test_central_mxu_matches_jax():
    """The port's wrapper (plain on the CPU) against JAX's kernel in
    interpret mode at n 300 / n_pad 384, with the ``nbs`` aux."""
    n, n_pad = 300, 384
    (jX, jov), (X, ov) = _both(n, n_pad)
    j = j_mxu(j_central(aux={"nbs": _j_nbs}), j_friction, jX, jov,
              jnp.int32(n))
    with profiling.tracing():
        t = central_pairwise_mxu(central_adhesion(aux={"nbs": _nbs}),
                                 friction_w_neighbour, X, ov, n)
        # no kernel on the CPU
        assert "kernels.central_pair" not in profiling.counters()
    assert set(t[3]) == {"nbs"}
    _assert_sums(j, t, n)


def test_central_mxu_diag():
    """i == j reaction terms enter through ``diag``, added outside the
    pair pass on both sides."""
    n, n_pad = 150, 256
    (jX, jov), (X, ov) = _both(n, n_pad, ov_scale=False)
    j = j_mxu(j_central(diag=_j_diag), j_friction, jX, jov, jnp.int32(n))
    t = central_pairwise_mxu(central_adhesion(diag=_diag),
                             friction_w_neighbour, X, ov, n)
    _assert_sums(j, t, n, fields=("x", "y", "z", "ctype"))


def test_central_mxu_heun_trajectory():
    """4 steps through ``TileEngine(mxu=True)`` against the same steps in
    JAX (its kernel in interpret mode)."""
    n, n_pad = 200, 256
    (jX, jov), (X, ov) = _both(n, n_pad, ov_scale=False)
    jXe, _, jaux = j_heun_steps(
        4, JTileEngine(mxu=True), j_central(), j_friction, None, "com", jX,
        jov, jnp.int32(n), jnp.float32(0.05), jnp.float32(1.0),
        jnp.int32(0), None)
    Xe, _, aux = heun_steps(4, TileEngine(mxu=True), central_adhesion(),
                            friction_w_neighbour, "com", X, ov, n, 0.05, 1.0)
    for f in ("x", "y", "z"):
        assert isclose(getattr(Xe, f).numpy()[:n],
                       np.asarray(getattr(jXe, f))[:n]), f
    assert float(aux["__err_non_finite"]) == float(jaux["__err_non_finite"])
    assert float(aux["__err_non_finite"]) == 0.0


@pytest.mark.parametrize("friction", ["w_neighbour", "on_background"])
def test_frictions_and_central_coef_match_jax(friction):
    """Both frictions and their ``central_coef`` declarations, pair by
    pair, against JAX (exact: comparisons only)."""
    from yalla_tpu.ops import common as jcommon
    t_fr = {"w_neighbour": friction_w_neighbour,
            "on_background": friction_on_background}[friction]
    j_fr = getattr(jcommon, "friction_" + friction)
    rng = np.random.default_rng(1)
    dist = rng.uniform(0, 2, (6, 7)).astype(np.float32)
    dist[0, 0] = 1.0
    i = np.arange(6)[:, None]
    j = np.arange(7)[None, :] % 6
    X = Float3(*[torch.zeros(6, 1)] * 3)
    jXp = JFloat3(*[jnp.zeros((6, 1))] * 3)
    np.testing.assert_array_equal(
        t_fr(X, X, torch.as_tensor(dist), torch.as_tensor(i),
             torch.as_tensor(j)).numpy(),
        np.asarray(j_fr(jXp, jXp, jnp.asarray(dist), jnp.asarray(i),
                        jnp.asarray(j))))
    np.testing.assert_array_equal(
        t_fr.central_coef(torch.as_tensor(dist), {}, {}).numpy(),
        np.asarray(j_fr.central_coef(jnp.asarray(dist), {}, {})))


def test_central_plain_padding_at_sentinel():
    """Padding rows sit at the sentinel: whatever the padding holds, the
    active rows' sums do not change (the padding here sits inside the
    ball, within reach of active cells)."""
    n, n_pad = 100, 128
    (_, _), (X, ov) = _both(n, n_pad)
    noisy = X._replace(x=torch.where(torch.arange(n_pad) < n, X.x, 0.1),
                       y=torch.where(torch.arange(n_pad) < n, X.y, 0.1),
                       z=torch.where(torch.arange(n_pad) < n, X.z, 0.1))
    cf = central_adhesion()
    a = central_pairwise_plain(cf, friction_w_neighbour, X, ov, n)
    b = central_pairwise_plain(cf, friction_w_neighbour, noisy, ov, n)
    for u, v in zip(a[:1] + a[2:3], b[:1] + b[2:3]):
        for p, q in zip(u, v):
            assert torch.equal(p[:n], q[:n])
    assert torch.equal(a[1][:n], b[1][:n])
    assert CENTRAL_SENTINEL == 1e4


def test_kernel_spec_takes_the_aux_functor():
    """The force with the ``nbs`` aux runs on the card through the
    functor that sums it; a force whose aux differs from its functor's is
    refused."""
    cf = central_adhesion(aux={"nbs": _nbs})
    cf.cuda_functor = ("sorting_adhesion_central_nbs", S.Params())
    spec, params = _kernel_spec(cf, friction_w_neighbour, [2])
    assert spec["aux"] == ("nbs",) and params.r_max == R_MAX
    # the model's own declaration is the same functor
    model = S.make_adhesion_central(S.Params(), count_neighbours=True)
    assert model.cuda_functor[0] == "sorting_adhesion_central_nbs"
    assert _kernel_spec(model, friction_w_neighbour, [2])[0] is spec
    for aux, functor in (({"nbs": _nbs}, "sorting_adhesion_central"),
                         (None, "sorting_adhesion_central_nbs"),
                         ({"nbs": _nbs, "twice": _nbs},
                          "sorting_adhesion_central_nbs")):
        bad = central_adhesion(aux=aux)
        bad.cuda_functor = (functor, S.Params())
        with pytest.raises(ValueError, match="aux channels"):
            _kernel_spec(bad, friction_w_neighbour, [2])


def test_sorting_adhesion_counts_neighbours_as_jax():
    """``make_adhesion_central(count_neighbours=True)`` on the plain path
    against JAX's kernel (interpret mode) with test_central.py's ``nbs``
    aux: the neighbour count exact."""
    n, n_pad = 300, 384
    (jX, jov), (X, ov) = _both(n, n_pad)
    j = j_mxu(j_central(aux={"nbs": _j_nbs}), j_friction, jX, jov,
              jnp.int32(n))
    force = S.make_adhesion_central(S.Params(), count_neighbours=True)
    t = central_pairwise_mxu(force, friction_w_neighbour,
                             pt_from_numpy(S.Cell, jX, device="cpu"), ov, n)
    assert set(t[3]) == {"nbs"}
    _assert_sums(j, t, n)
