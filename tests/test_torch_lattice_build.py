"""yalla_tpu_torch against yalla_tpu: the pour (kernel K2's plain version),
the lattice build with and without overflow extras, the way back to
stable order, and the extras block-table overflow flag.

Everything here is placement and counting, so every comparison is exact.
Also, port only: the plain lattice path against the port's all-pairs
``TileEngine`` oracle (every Cell field within tests/helpers.py
``isclose``, neighbour counters exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from test_pour import _case
from test_torch_common import jax_pt, settled_600
from test_torch_gpu import POUR_CASES
from test_torch_slice import solution_600
from yalla_tpu import dtypes as jdt
from yalla_tpu.models import branching as JB
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.ops.common import cube_ids as j_cube_ids
from yalla_tpu.ops.lattice_pallas import _extras_tables
from yalla_tpu.ops.lattice_pour import pour_pallas as j_pour
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.models import branching as TB
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.lattice_pallas import extras_block_overflow
from yalla_tpu_torch.ops.lattice_pour import (DST_SENTINEL, pour_pallas,
                                              pour_plain)
from yalla_tpu_torch.solvers import LatticeEngine, TileEngine

torch.set_num_threads(2)

N = 600


def _states():
    X, ov = settled_600()
    return ((jax_pt(JB.Cell, X), jax_pt(jdt.Float3, ov)),
            (pt_from_numpy(TB.Cell, X, device="cpu"),
             pt_from_numpy(tdt.Float3, ov, device="cpu")))


def _equal(port, ref, what):
    if hasattr(ref, "_fields"):
        for f, a, b in zip(ref._fields, port, ref):
            _equal(a, b, f"{what}.{f}")
        return
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=what)


@pytest.mark.parametrize("seed,clustered", [(0, False), (1, True)])
def test_pour_plain_matches_pallas_interpret(seed, clustered):
    """The JAX butterfly pour (interpret mode) on tests/test_pour.py's
    inputs, against the port's plain pour and its CPU wrapper, both given
    the same row starts: equal outputs, nothing unrouted."""
    n_pad, gs, C = 8192, 16, 8
    S, row_starts, _, _ = _case(n_pad, gs, C, 6000, seed, clustered)
    ref = j_pour(jnp.asarray(S), jnp.asarray(row_starts), n_pad, gs, C)
    for fn in (pour_plain, pour_pallas):
        out, live, n_unrouted = fn(torch.as_tensor(S),
                                   torch.as_tensor(row_starts), gs, C)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(live.numpy(), np.asarray(ref[1]))
        assert int(n_unrouted) == int(ref[2]) == 0


def test_pour_empty_and_full_rows_match_pallas_interpret():
    """tests/test_pour.py's empty and full rows (the JAX kernel in
    interpret mode) against the port's plain pour."""
    grid, C, S, row_starts, _ = POUR_CASES["empty_and_full_rows"]
    ref = j_pour(jnp.asarray(S), jnp.asarray(row_starts), S.shape[1],
                 grid[0], C)
    out, live, n_unrouted = pour_plain(torch.as_tensor(S),
                                       torch.as_tensor(row_starts), grid, C)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(live.numpy(), np.asarray(ref[1]))
    assert int(n_unrouted) == int(ref[2]) == 0


@pytest.mark.parametrize("case", list(POUR_CASES))
def test_pour_plain_places_and_counts(case):
    """The plain pour and its CPU wrapper on the GPU test's cube-sorted
    inputs: every entry placed at its slot when its row's window holds it,
    the rest counted in n_unrouted (two in the misrouted case)."""
    grid, C, S, row_starts, unrouted = POUR_CASES[case]
    gx, gy, gz = grid
    W = gx * C
    St, rs = torch.as_tensor(S), torch.as_tensor(row_starts)
    got = pour_plain(St, rs, grid, C)
    for a, b in zip(got, pour_pallas(St, rs, grid, C)):
        assert torch.equal(a, b)
    out, live, n_unrouted = (a.numpy() for a in got)
    assert int(n_unrouted) == unrouted
    want_out = np.zeros((S.shape[0] - 1, W * gy * gz), np.float32)
    want_live = np.zeros(W * gy * gz, np.float32)
    for t in np.flatnonzero(S[-1] < DST_SENTINEL):
        slot = int(S[-1, t])
        r = slot // W
        if row_starts[r] <= t < row_starts[r + 1]:
            want_out[:, slot] = S[:-1, t]
            want_live[slot] = 1.0
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(live, want_live)
    assert int(want_live.sum()) + unrouted == \
        int((S[-1] < DST_SENTINEL).sum())


@pytest.mark.parametrize("gs,C,n", [(32, 4, N), (16, 2, N), (8, 4, N),
                                    (32, 4, 0)])
def test_row_starts_match_jax_count_and_cumsum(gs, C, n):
    """The port's row starts (a binary search of each row's first cube id
    in the sorted ids) against the JAX build's count-and-cumsum
    (yalla_tpu/ops/lattice_xla.py:179-181) on the same state; at gs 8 the
    600 cells overflow the grid's edge cubes."""
    (jX, _), (tX, tov) = _states()
    cid = j_cube_ids(jX, jnp.int32(n), jnp.float32(1.0), gs)
    sorted_cid = jnp.sort(cid)
    row_id = jnp.minimum(sorted_cid // gs, gs * gs)
    cnt = jnp.zeros(gs * gs + 1, jnp.int32).at[row_id].add(1)
    want = np.asarray((jnp.cumsum(cnt) - cnt).astype(jnp.int32))
    got = TL.sort_by_cube(tX, tov, n, 1.0, gs, C).row_starts
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[-1]) == n


@pytest.mark.parametrize("gs,C,extras", [(32, 4, 0), (32, 4, 512),
                                         (16, 2, 64)])
def test_lattice_build_matches_jax(gs, C, extras):
    (jX, jov), (tX, tov) = _states()
    ref = JL.lattice_build(jX, jov, jnp.int32(N), jnp.float32(1.0), gs, C,
                           extras)
    got = TL.lattice_build(tX, tov, N, 1.0, gs, C, extras)
    for name in ref._fields:
        if getattr(ref, name) is not None:
            _equal(getattr(got, name), getattr(ref, name), name)
    assert (got.E is None) == (extras == 0)
    # the 600-cell state overflows C = 4 with 9 cells, C = 2 with more
    assert int(got.n_dropped) + int(got.n_extras if extras else 0) > 0


def test_lattice_unbuild_and_slot_to_stable_match_jax():
    (jX, jov), (tX, tov) = _states()
    ref = JL.lattice_build(jX, jov, jnp.int32(N), jnp.float32(1.0), 32, 4,
                           64)
    got = TL.lattice_build(tX, tov, N, 1.0, 32, 4, 64)
    # move the slot-space state so the way back is visible
    ref = ref._replace(T=ref.T * 2.0, E=ref.E * 2.0)
    got = got._replace(T=got.T * 2.0, E=got.E * 2.0)
    jback, tback = JL.lattice_unbuild(ref, jX, jov), \
        TL.lattice_unbuild(got, tX, tov)
    _equal(tback[0], jback[0], "X")
    _equal(tback[1], jback[1], "old_v")
    np.testing.assert_array_equal(tback[0].x.numpy()[:N],
                                  2.0 * tX.x.numpy()[:N])
    _equal(TL.slot_to_stable(got, got.T), JL.slot_to_stable(ref, ref.T),
           "T")


@pytest.mark.parametrize("C,block_cap", [(4, 16), (2, 8)])
def test_extras_block_overflow_matches_jax(C, block_cap):
    """``__err_extras_block`` against the JAX kernel's sidecar tables
    (plain jnp); with C = 2 the extras crowd past an 8-entry table."""
    (jX, jov), (tX, tov) = _states()
    gs, zb = 32, 2
    ref = JL.lattice_build(jX, jov, jnp.int32(N), jnp.float32(1.0), gs, C,
                           512)
    got = TL.lattice_build(tX, tov, N, 1.0, gs, C, 512)
    yb = 16
    _, _, j_over = _extras_tables(ref, [0, 1, 2], False, gs // zb, gs // yb,
                                  zb, yb, jnp.float32(1.0), gs,
                                  max((block_cap // 8) * 8, 8))
    t_over = extras_block_overflow(got, 1.0, gs, zb, block_cap)
    assert float(t_over) == float(j_over)
    if C == 2:
        assert float(t_over) > 0
    else:
        assert float(t_over) == 0


@pytest.mark.parametrize("fix", ["com", "point", "com_z"])
def test_plain_lattice_matches_tile_oracle(fix):
    force = TB.make_force(TB.Params())
    out = {}
    for name, engine in (("tile", TileEngine()),
                         ("lattice", LatticeEngine(grid_size=16,
                                                   capacity=8))):
        sol = solution_600(engine)
        if fix == "point":
            sol.set_fixed(17)
        elif fix == "com_z":
            sol.set_fixed_xy(17)
        aux = sol.take_steps(2, 0.2, force, precompute=TB.precompute)
        out[name] = sol.copy_to_host(), aux
    (hl, auxl), (ht, auxt) = out["lattice"], out["tile"]
    for f in TB.Cell._fields:
        assert isclose(getattr(hl, f)[:N], getattr(ht, f)[:N]), f
    for k in ("epi_nbs", "mes_nbs"):
        np.testing.assert_array_equal(auxl[k].numpy()[:N],
                                      auxt[k].numpy()[:N], err_msg=k)
