"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``gpu``: without a CUDA device every test skips.  On a machine
with one (which need not have JAX), run

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: the pour is exact; the pair kernels' counters (epi_nbs, sum
of friction) and flags are exact, their other sums within rtol 1e-4 /
atol 1e-5 of the plain version (f32 rounding of FMA-contracted force
arithmetic and another summation order; 1e-4 for the central kernel's
forces, whose factored form cancels two sums of size |x| * sum|w|); the
slices within the reference's ``isclose`` of the same steps on the CPU
(the link and wall forces' ``index_add_`` sums in no fixed order on the
GPU).
"""
import contextlib
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu_torch import growth, inits
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.links import Draws, Links, link_wall_forces
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.models import growth_w_wall as W
from yalla_tpu_torch.models import sorting as S
from yalla_tpu_torch.ops.central_mxu import (central_pairwise_mxu,
                                             central_pairwise_plain)
from yalla_tpu_torch.ops.common import (friction_on_background,
                                        friction_w_neighbour)
from yalla_tpu_torch.ops.gabriel_pallas import (GABRIEL_MAX_NC,
                                                gabriel_lattice_pallas,
                                                gabriel_lattice_plain)
from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                lattice_pairwise_plain)
from yalla_tpu_torch.ops.lattice_pour import (DST_SENTINEL, pour_pallas,
                                              pour_plain)
from yalla_tpu_torch.ops.lattice_xla import lattice_build
from yalla_tpu_torch.ops.tile_pallas import (tile_pairwise_pallas,
                                             tile_pairwise_plain)
from yalla_tpu_torch.solvers import (GabrielEngine, LatticeEngine, Solution,
                                     TileEngine, augment)
from yalla_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

SETTLED_600 = Path(__file__).resolve().parent.parent / ".bench_cache" / \
    "settled_branching_600_s0_v1.npz"
N, GS, C, EXTRAS = 600, 32, 4, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@contextlib.contextmanager
def launches(*kernels):
    """The launches of each of ``kernels`` in the block (the
    ``kernels.<name>`` counters of ``utils.profiling``), a list filled
    when the block ends."""
    got = []
    with profiling.tracing():
        before = profiling.counters()
        yield got
        after = profiling.counters()
    got += [after.get(f"kernels.{k}", 0) - before.get(f"kernels.{k}", 0)
            for k in kernels]


def pour_input(grid, C, cid, n_pad, seed, K=5):
    """A cube-sorted pour input in numpy: ``K - 1`` random channels and the
    target slot of each entry of the sorted cube ids ``cid`` (rank < C in
    its cube, else ``DST_SENTINEL``; rows past ``len(cid)`` too), and the
    first sorted position of each (z, y) row of cubes."""
    gx, gy, gz = grid
    rng = np.random.default_rng(seed)
    cid = np.sort(np.asarray(cid, np.int64))
    n = len(cid)
    first = np.r_[True, cid[1:] != cid[:-1]] if n else np.zeros(0, bool)
    rank = np.arange(n) - np.maximum.accumulate(
        np.where(first, np.arange(n), 0))
    S = rng.random((K, n_pad), np.float32)
    S[-1] = DST_SENTINEL
    S[-1, :n] = np.where(rank < C, cid * C + rank, DST_SENTINEL)
    row_starts = np.searchsorted(cid, np.arange(gy * gz + 1) * gx)
    return S, row_starts.astype(np.int32)


def pour_cases():
    """Cube-sorted pour inputs by name: (grid, C, S, row_starts, expected
    n_unrouted)."""
    rng = np.random.default_rng(0)
    g16 = (16, 16, 16)
    cases = {
        # a scattered and a clustered lattice (overflowing cubes), as
        # tests/test_pour.py makes them
        "scattered": (g16, 8, rng.choice(16 ** 3, 6000)),
        "clustered": (g16, 8, rng.choice(16 ** 3 // 7, 6000) * 7),
        # one half-full row and one full row, the rest empty
        "empty_and_full_rows": (g16, 8, np.r_[
            np.repeat(np.arange(17 * 16, 18 * 16), 4),
            np.repeat(np.arange(100 * 16, 101 * 16), 8)]),
        # 3000 entries in one row of 128 slots
        "crowded_row": (g16, 8, rng.choice(np.arange(5 * 16, 6 * 16), 3000)),
        # rows of 5120 slots, wider than a block's map of 4096
        "wide_rows": ((640, 2, 2), 8, rng.choice(640 * 4, 6000)),
        "no_live_cell": (g16, 8, np.zeros(0, np.int64)),
        # a row width gx * C = 33, no multiple of 4
        "ragged": ((11, 11, 11), 3, rng.choice(11 ** 3, 3000)),
    }
    out = {k: (grid, C, *pour_input(grid, C, cid, 8192, seed=1), 0)
           for k, (grid, C, cid) in cases.items()}
    # one entry moved to a free slot of another row, and the window of the
    # last row cut short by one placed entry: two entries not placed
    grid, C, S, rs, _ = out["scattered"]
    S, rs = S.copy(), rs.copy()
    placed = np.flatnonzero(S[-1] < DST_SENTINEL)
    free = np.setdiff1d(np.arange(16 ** 3 * 8), S[-1, placed])
    S[-1, placed[0]] = free[free >= 8 * 16 * 8][0]
    assert placed[-1] == rs[-1] - 1
    rs[-1] -= 1
    out["misrouted"] = (grid, C, S, rs, 2)
    return out


POUR_CASES = pour_cases()


@pytest.mark.parametrize("case", list(POUR_CASES))
def test_pour_kernel_matches_plain(cuda, case):
    """K2 bit-exact against its plain version on cube-sorted inputs (+0.0
    in empty slots, live exactly 0.0 or 1.0), n_unrouted equal."""
    grid, C, S, row_starts, unrouted = POUR_CASES[case]
    S = torch.as_tensor(S, device=cuda)
    row_starts = torch.as_tensor(row_starts, device=cuda)
    with launches("pour") as launched:
        got = pour_pallas(S, row_starts, grid, C)
    assert launched == [1]
    want = pour_plain(S, row_starts, grid, C)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[2]) == unrouted
    # the same bits: no -0.0 in an empty slot
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert set(got[1].unique().tolist()) <= {0.0, 1.0}


def _layout(device):
    X, ov = load_settled(SETTLED_600, B.Cell, device)
    lay = lattice_build(X, ov, N, 1.0, GS, C, EXTRAS)
    return lay._replace(T=augment(lay.T, N, B.precompute),
                        E=augment(lay.E, N, B.precompute))


def _branching_cells(n, n_pad, spacing, side, seed):
    """``n`` branching cells on a jittered cubic lattice of ``spacing``
    (jitter +-spacing/5, so no two closer than 0.6 spacing), the ``n``
    nearest the origin of a ``side``-point cube of sites, with random
    polarity, morphogens and types; rows past ``n`` are zero.  Returns
    numpy fields and a small old_v."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g - (side - 1) / 2) * spacing
    pos = pos + rng.uniform(-spacing / 5, spacing / 5, pos.shape)
    pos = pos[np.argsort((pos ** 2).sum(1), kind="stable")[:n]]
    h = {f: np.zeros(n_pad, np.float32) for f in B.Cell._fields}
    for c, f in enumerate("xyz"):
        h[f][:n] = pos[:, c]
    h["theta"][:n] = rng.uniform(0, np.pi, n)
    h["phi"][:n] = rng.uniform(-np.pi, np.pi, n)
    h["u"][:n] = rng.uniform(0, 1, n)
    h["v"][:n] = rng.uniform(0, 1, n)
    h["ctype"][:n] = rng.integers(0, 2, n)
    ov = {f: (0.01 * rng.standard_normal(n_pad)).astype(np.float32)
          for f in "xyz"}
    return h, ov


# K1 edge shapes: (cells, rows, lattice spacing, sites per side, grid,
# capacity, extras_cap); n 0 is the empty lattice, "boundary" keeps only
# cells in the outer cubes of its 8^3 grid, "ragged" fills every cube of
# an 11^3 grid, which the 2 x 4 x 8 brick divides in no axis, with no
# extras and, at C 4, with overflow extras (a grid the JAX kernel's extras
# blocks refuse: its flag's last y block is ragged here)
PAIR_CASES = {
    "settled600": None,
    "empty": (0, 640, 0.6, 9, 32, 4, 64),
    "boundary": (2000, 2048, 0.5, 16, 8, 8, 1024),
    "c1": (300, 320, 0.9, 7, 16, 1, 512),
    "c16": (3000, 3072, 0.45, 15, 16, 16, 2048),
    "ragged": (4913, 4992, 0.6, 17, 11, 8, 0),
    "ragged_extras": (4913, 4992, 0.6, 17, 11, 4, 2048),
    # the intercalation_w_gradient functor (16 channels): grid 16, C 8,
    # half the cells epithelial, with overflow extras
    "intercalation_w_gradient": (3000, 3072, 0.45, 15, 16, 8, 2048),
    # thin x-cubes (x_split 2 and 3: the ragged block of cells on 22 and
    # 33 x-cubes), at a capacity that holds every cube and at one that
    # spills hundreds into the extras
    "xsplit2_ragged": (4913, 4992, 0.6, 17, (22, 11, 11), 5, 0, 2),
    "xsplit2_ragged_extras": (4913, 4992, 0.6, 17, (22, 11, 11), 3, 2048,
                              2),
    "xsplit3_ragged": (4913, 4992, 0.6, 17, (33, 11, 11), 5, 0, 3),
    "xsplit3_ragged_extras": (4913, 4992, 0.6, 17, (33, 11, 11), 3, 2048,
                              3),
}
IWG = "intercalation_w_gradient"


def _iwg_cells(h, n, seed):
    """intercalation_w_gradient cells at the positions of ``h`` (the
    first ``n``), with random polarities, morphogens and types (about one
    in two epithelial, some exactly on a pole)."""
    m = importlib.import_module("yalla_tpu_torch.examples." + IWG)
    rng = np.random.default_rng(seed)
    n_pad = len(h["x"])
    out = {f: np.zeros(n_pad, np.float32) for f in m.Cell._fields}
    for f in "xyz":
        out[f][:] = h[f]
    out["theta"][:n] = rng.uniform(0, np.pi, n)
    out["theta"][:n:17] = 0.0
    out["phi"][:n] = rng.uniform(-np.pi, np.pi, n)
    out["w"][:n] = rng.uniform(0, 1, n)
    out["f"][:n] = rng.uniform(0, 1, n)
    out["ctype"][:n] = rng.integers(0, 2, n)
    return m, out


def _pair_case(case, device):
    """(layout, n, grid size, capacity, force, x_split) of one K1 edge
    shape on ``device``."""
    if PAIR_CASES[case] is None:
        return _layout(device), N, GS, C, B.make_force(B.Params()), 1
    n, n_pad, spacing, side, gs, cap, e_cap, *xs = PAIR_CASES[case]
    x_split = xs[0] if xs else 1
    h, ov = _branching_cells(max(n, 1), n_pad, spacing, side, seed=3)
    Cell, force, pre = B.Cell, B.make_force(B.Params()), B.precompute
    if case == IWG:
        m, h = _iwg_cells(h, n, seed=4)
        Cell, force = m.Cell, m.force
        pre = m.polarity_precompute
    if case == "boundary":
        # keep the cells whose cube has a coordinate 0 or gs - 1
        idx = np.floor(np.stack([h[f] for f in "xyz"], -1)) + gs // 2
        keep = ((idx == 0) | (idx == gs - 1)).any(-1) & \
            (np.arange(n_pad) < n)
        order = np.argsort(~keep, kind="stable")
        h = {f: np.where(np.arange(n_pad) < keep.sum(), a[order], 0)
             .astype(np.float32) for f, a in h.items()}
        n = int(keep.sum())
    if "ragged" in case:
        # shift the block of cells from [-4.9, 4.9] to cubes 0 .. 10
        for f in "xyz":
            h[f][:n] += 0.5
    X = Cell(*(torch.as_tensor(h[f], device=device) for f in Cell._fields))
    ovt = Float3(*(torch.as_tensor(ov[f], device=device) for f in "xyz"))
    lay = lattice_build(X, ovt, n, 1.0, gs, cap, e_cap, x_split=x_split)
    assert int(lay.n_dropped) == 0 and int(lay.n_oob) == 0
    assert not (case.endswith("extras") or case == IWG) or \
        int(lay.n_extras) > 100
    E = None if lay.E is None else augment(lay.E, n, pre)
    return (lay._replace(T=augment(lay.T, n, pre), E=E), n, gs, cap, force,
            x_split)


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_kernel_matches_plain(cuda, case):
    """K1 against its plain version on the settled 600-cell state (gs 32,
    C 4, with extras) and on edge shapes: an empty lattice, cells only in
    the boundary cubes, C 1 and C 16 (both with overflow extras), and a
    grid whose bricks are ragged in every axis, without and with extras;
    with the intercalation_w_gradient functor (its 16 channels, its
    two neighbour counts exact; dF within the tolerance plus 1e-6 of the
    slot's sum of term magnitudes, for phi near the poles); and on thin
    x-cubes (x_split 2 and 3) of a ragged grid, without and with
    extras."""
    lay, n, gs, cap, force, x_split = _pair_case(case, cuda)
    kw = dict(grid_size=gs, capacity=cap, z_block=2, extras_block_cap=16,
              x_split=x_split)
    with launches("lattice_pair") as launched:
        got = lattice_pairwise_pallas(force, friction_w_neighbour, lay, n,
                                      1.0, **kw)
    want = lattice_pairwise_plain(force, friction_w_neighbour, lay, n, 1.0,
                                  **kw)
    assert launched == [1]
    assert len(got) == len(want)
    mags = None
    if case == IWG:   # each slot's sum of |term|, per dF field
        def mag(*args):
            dF, aux = force(*args)
            return type(dF)(*(a.abs() for a in dF)), aux
        mags = lattice_pairwise_plain(mag, friction_w_neighbour, lay, n,
                                      1.0, **kw)
        mags = (mags[:4], *mags[4:])
    for k_out, (g, w) in enumerate(zip((got[:4], *got[4:]),
                                       (want[:4], *want[4:]))):
        for f, a, b in zip(w[0]._fields, g[0], w[0]):
            if mags is None:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
            else:
                c = getattr(mags[k_out][0], f)
                tol = 1e-4 * b.abs() + 1e-5 * max(1.0, float(b.abs().max())) \
                    + 1e-6 * c
                assert bool(((a - b).abs() <= tol).all()), f
        assert torch.equal(g[1], w[1])                     # sum of friction
        for a, b in zip(g[2], w[2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        for k in w[3]:
            if k in ("epi_nbs", "mes_nbs", "__err_extras_block"):
                assert torch.equal(g[3][k], w[3][k]), k
            else:
                torch.testing.assert_close(g[3][k], w[3][k], rtol=1e-4,
                                           atol=1e-5)


# K1 on z-slabs: (grid, slabs); 18 planes in 2 slabs of 9, which the
# brick's 2 planes do not divide
ZHALO_CASES = {"d2": ((16, 16, 16), 2), "d4": ((16, 16, 16), 4),
               "ragged_d2": ((16, 16, 18), 2)}


@pytest.mark.parametrize("case", list(ZHALO_CASES))
@pytest.mark.parametrize("functor", ["branching", IWG])
def test_pair_kernel_zhalo_matches_plain(cuda, functor, case):
    """K1 with ``z_halo`` on each z-slab of a lattice of 4,913 cells (grid
    16, C 8, cells in every slab), the halo planes from the whole
    lattice: against its plain version (counters exact, the other sums as
    in ``test_pair_kernel_matches_plain``), and equal bit for bit to the
    kernel's pass over the whole lattice on that slab."""
    from yalla_tpu_torch.parallel.lattice_spmd import slab_of
    grid, n_slabs = ZHALO_CASES[case]
    n, n_pad, cap = 4913, 4992, 8
    h, ov = _branching_cells(n, n_pad, 0.6, 17, seed=5)
    Cell, force, pre = B.Cell, B.make_force(B.Params()), B.precompute
    if functor == IWG:
        m, h = _iwg_cells(h, n, seed=6)
        Cell, force, pre = m.Cell, m.force, m.polarity_precompute
    X = Cell(*(torch.as_tensor(h[f], device=cuda) for f in Cell._fields))
    ovt = Float3(*(torch.as_tensor(ov[f], device=cuda) for f in "xyz"))
    lay = lattice_build(X, ovt, n, 1.0, grid, cap)
    assert int(lay.n_dropped) == 0 and int(lay.n_oob) == 0
    lay = lay._replace(T=augment(lay.T, n, pre))
    kw = dict(grid_size=grid, capacity=cap, z_block=2)
    whole = lattice_pairwise_pallas(force, friction_w_neighbour, lay, n, 1.0,
                                    **kw)

    def mag(*args):    # each slot's sum of |term|, per dF field
        dF, aux = force(*args)
        return type(dF)(*(a.abs() for a in dF)), aux
    n_local = lay.pid.shape[0] // n_slabs
    for k in range(n_slabs):
        shim, halo, gz = slab_of(lay, grid, cap, n_slabs, k)
        slab = dict(grid_z=gz, n_pad=n_pad, z_halo=halo, **kw)
        assert int((shim.pid < n_pad).sum()) > 100
        with launches("lattice_pair") as launched:
            got = lattice_pairwise_pallas(force, friction_w_neighbour, shim,
                                          n, 1.0, **slab)
        assert launched == [1]
        want = lattice_pairwise_plain(force, friction_w_neighbour, shim, n,
                                      1.0, **slab)
        mags = lattice_pairwise_plain(mag, friction_w_neighbour, shim, n,
                                      1.0, **slab)
        for f, a, b, c in zip(want[0]._fields, got[0], want[0], mags[0]):
            tol = 1e-4 * b.abs() + 1e-5 * max(1.0, float(b.abs().max())) \
                + 1e-6 * c
            assert bool(((a - b).abs() <= tol).all()), (k, f)
        assert torch.equal(got[1], want[1])                # sum of friction
        for a, b in zip(got[2], want[2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        for key in want[3]:
            if key in ("epi_nbs", "mes_nbs"):
                assert torch.equal(got[3][key], want[3][key]), key
            else:
                torch.testing.assert_close(got[3][key], want[3][key],
                                           rtol=1e-4, atol=1e-5)
        sl = slice(k * n_local, (k + 1) * n_local)
        for a, b in zip([*got[0], got[1], *got[2], *got[3].values()],
                        [*whole[0], whole[1], *whole[2],
                         *whole[3].values()]):
            assert torch.equal(a, b[sl]), k


def test_z_slab_pallas_false_runs_the_kernel(cuda):
    """``lattice_sharded_heun_steps`` on a ring of one on the card (4
    steps, a build every 2, 4,913 branching cells, grid 16, C 8):
    ``pallas=False`` (JAX's default) launches K1 with ``z_halo`` twice a
    step, as ``pallas=True`` does, and the positions, velocities and
    flags of the two are equal bit for bit."""
    from yalla_tpu_torch.parallel._comm import single
    from yalla_tpu_torch.parallel.lattice_spmd import \
        lattice_sharded_heun_steps
    n, n_pad = 4913, 4992
    h, ov = _branching_cells(n, n_pad, 0.6, 17, seed=5)
    X = B.Cell(*(torch.as_tensor(h[f], device=cuda) for f in B.Cell._fields))
    ovt = Float3(*(torch.as_tensor(ov[f], device=cuda) for f in "xyz"))
    p = B.Params()
    out, k1 = {}, {}
    for pallas in (False, True):
        with launches("lattice_pair") as launched:
            out[pallas] = lattice_sharded_heun_steps(
                single(cuda), 4, 2, B.make_force(p), friction_w_neighbour,
                "com", 16, 8, 2, X, ovt, n, p.dt, 1.0, 0, B.precompute,
                pallas=pallas)
        k1[pallas] = launched[0]
    assert k1 == {False: 8, True: 8}
    (Xf, ovf, auxf), (Xt, ovt_, auxt) = out[False], out[True]
    assert not any(bool(v.any()) for k, v in auxt.items()
                   if k.startswith("__err_"))
    for a, b in zip([*Xf, *ovf], [*Xt, *ovt_]):
        assert torch.equal(a, b)
    assert auxf.keys() == auxt.keys()
    for k in auxt:
        assert torch.equal(auxf[k], auxt[k]), k


def test_pair_kernel_refuses_force_without_functor(cuda):
    lay = _layout(cuda)

    def plain_force(Xi, r, dist, i, j):
        return Xi
    with pytest.raises(ValueError, match="no CUDA functor"):
        lattice_pairwise_pallas(plain_force, friction_w_neighbour, lay, N,
                                1.0, grid_size=GS, capacity=C, z_block=2)


def test_slice_on_gpu_matches_cpu(cuda):
    force = B.make_force(B.Params())
    engine = LatticeEngine(grid_size=GS, capacity=C, z_block=2,
                           extras_cap=EXTRAS, extras_block_cap=16)
    out = {}
    for dev in ("cpu", cuda):
        X, ov = load_settled(SETTLED_600, B.Cell, device="cpu")
        sol = Solution(B.Cell, N, engine=engine, device=dev)
        sol.h_X = B.Cell(*(a.numpy() for a in X))
        sol.copy_to_device()
        sol.d_old_v = Float3(*(a.to(dev) for a in ov))
        with launches("pour", "lattice_pair") as launched:
            sol.take_steps(2, 0.2, force, precompute=B.precompute)
        out[str(dev)] = (sol.copy_to_host(), *launched)
    h_cpu, *cpu_launches = out["cpu"]
    h_gpu, *gpu_launches = out[str(cuda)]
    assert cpu_launches == [0, 0] and gpu_launches == [4, 4]
    for f in B.Cell._fields:
        assert isclose(getattr(h_gpu, f)[:N], getattr(h_cpu, f)[:N]), f


def _rows(out, n):
    """The first ``n`` rows of a pair pass's ``(F, sum_f, sum_v, aux)``
    (rows past the active count are don't-care)."""
    F, sum_f, sum_v, aux = out
    return (type(F)(*(a[:n] for a in F)), sum_f[:n],
            tuple(a[:n] for a in sum_v), {k: a[:n] for k, a in aux.items()})


def _assert_sums(got, want, exact_aux=(), atol=1e-5):
    for a, b in zip(got[0], want[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)
    assert torch.equal(got[1], want[1])                    # sum of friction
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        if k in exact_aux:
            assert torch.equal(got[3][k], want[3][k]), k
        else:
            torch.testing.assert_close(got[3][k], want[3][k], rtol=1e-4,
                                       atol=1e-5)


def _sorting_ball(device, n=900, n_pad=1000):
    X = S.Cell(*(torch.as_tensor(a, device=device)
                 for a in S.initial_ball(n, n_pad, seed=1).values()))
    g = torch.Generator().manual_seed(0)
    ov = Float3(*(0.01 * torch.randn(n_pad, generator=g).to(device)
                  for _ in range(3)))
    return X, ov, n


# K3 edge shapes: (functor, n, n_pad); besides the sorting ball of 900
# cells in 1000 rows (the kernel takes any n_pad) and the settled 600-cell
# branching state with its polarity channels (diagonal, aux and non-xyz
# channels), every n of {1, 127, 600, 5000} in n rows and padded; and the
# relaxation functor at the flagship's 500 seeds in 512 rows, at a ragged
# 127 in 127, at one point and at 3000 in 3100; and the all-pairs
# examples' functors at each example's own initial state, at its published
# size (``functor[example]``; n and n_pad the example's)
TILE_CASES = [("sorting", 900, 1000), ("branching", 600, None)] + [
    (functor, n, n_pad) for functor in ("sorting", "branching")
    for n in (1, 127, 600, 5000)
    for n_pad in (n, -(-n // 128) * 128 + 128)] + [
    ("inits_relu", 500, 512), ("inits_relu", 127, 127),
    ("inits_relu", 1, 128), ("inits_relu", 3000, 3100)] + [
    (f"{functor}[{example}]", None, None)
    for functor, example in (("spring", "springs"),
                             ("gradient_diffusion", "gradient"),
                             ("bending_layer", "bending"),
                             ("relu_migration", "migration"),
                             ("relu_migration", "random_walk"),
                             ("wnt_diffusion", "wnt"))]

# the example forces that declare each example's K3 functor
EXAMPLE_FORCES = {"springs": "spring", "gradient": "diffusion",
                  "bending": "layer_force", "migration": "relu_w_migration",
                  "random_walk": "relu_w_migration", "wnt": "diffusion"}


def _example_case(example, device):
    """(force, X, old_v, n) of an all-pairs example's initial state."""
    m = importlib.import_module(f"yalla_tpu_torch.examples.{example}")
    inits.set_seed(0)
    sol = m.setup(device)
    g = torch.Generator().manual_seed(0)
    ov = Float3(*(0.01 * torch.randn(sol.n_pad, generator=g).to(device)
                  for _ in range(3)))
    return getattr(m, EXAMPLE_FORCES[example]), sol.d_X, ov, sol.d_n


def _magnitudes(force, X, ov, n):
    """Per row and dF field, the plain sum of the pair terms' magnitudes:
    the scale of the rounding of a sum taken in another order."""
    def mag(*args):
        dF = force(*args)
        return type(dF)(*(a.abs() for a in dF))
    return tile_pairwise_plain(mag, friction_w_neighbour, X, ov, n)[0]


def _tile_case(functor, n, n_pad, device):
    """(force, X, old_v, exact aux) of one K3 edge shape on ``device``."""
    if functor == "sorting":
        X = S.Cell(*(torch.as_tensor(a, device=device)
                     for a in S.initial_ball(n, n_pad, seed=1).values()))
        g = torch.Generator().manual_seed(0)
        ov = Float3(*(0.01 * torch.randn(n_pad, generator=g).to(device)
                      for _ in range(3)))
        return S.make_adhesion(S.Params()), X, ov, ()
    if n_pad is None:
        X, ov = load_settled(SETTLED_600, B.Cell, device)
    else:
        h, hov = _branching_cells(n, n_pad, 0.6, 18, seed=2)
        X = B.Cell(*(torch.as_tensor(h[f], device=device)
                     for f in B.Cell._fields))
        ov = Float3(*(torch.as_tensor(hov[f], device=device) for f in "xyz"))
    if functor == "inits_relu":
        # the relaxation force reads x, y, z of whatever point type
        return inits.relu_force, X, ov, ()
    return (B.make_force(B.Params()), augment(X, n, B.precompute), ov,
            ("epi_nbs",))


@pytest.mark.parametrize("functor,n,n_pad", TILE_CASES)
def test_tile_kernel_matches_plain(cuda, functor, n, n_pad):
    """K3 against its plain version: the sorting functor, the branching
    functor with its polarity channels, the relaxation functor and the
    examples' functors; sum_f (and epi_nbs) exact.  An example's dF is
    held to rtol 1e-4 + 1e-5 x max(1, max|plain|) per field, plus 2e-6 of
    the row's sum of term magnitudes: at bending's cells on a polarity
    pole the phi force is a sum of terms of +-1.8e6 that comes to -4,
    which another summation order rounds by about 0.5."""
    example = functor.endswith("]")
    if example:
        force, X, ov, n = _example_case(functor[functor.index("[") + 1:-1],
                                        cuda)
        exact = ()
    else:
        force, X, ov, exact = _tile_case(functor, n, n_pad, cuda)
    with launches("tile_pair") as launched:
        got = tile_pairwise_pallas(force, friction_w_neighbour, X, ov, n)
    want = tile_pairwise_plain(force, friction_w_neighbour, X, ov, n)
    assert launched == [1]
    got, want = _rows(got, n), _rows(want, n)
    if example:
        mags = _magnitudes(force, X, ov, n)
        for a, b, c in zip(got[0], want[0], mags):
            tol = 1e-4 * b.abs() + 1e-5 * max(1.0, float(b.abs().max())) \
                + 2e-6 * c[:n]
            assert bool(((a - b).abs() <= tol).all())
        got = (want[0],) + got[1:]
    _assert_sums(got, want, exact_aux=exact)


# K4 edge shapes (n, n_pad, count neighbours): below one tile of j and
# one block of i, n no multiple of the split and n_pad no multiple of 128,
# the 5k configuration, with and without the ``nbs`` aux
CENTRAL_CASES = [(50, 64, False), (900, 1000, False), (900, 1000, True),
                 (127, 200, True), (5000, 5120, True)]


@pytest.mark.parametrize("n,n_pad,nbs", CENTRAL_CASES)
@pytest.mark.parametrize("friction", [friction_w_neighbour,
                                      friction_on_background])
def test_central_kernel_matches_plain(cuda, friction, n, n_pad, nbs):
    """K4 against its plain version: sum_f and the neighbour count
    exact."""
    X, ov, n = _sorting_ball(cuda, n, n_pad)
    force = S.make_adhesion_central(S.Params(), count_neighbours=nbs)
    with launches("central_pair") as launched:
        got = central_pairwise_mxu(force, friction, X, ov, n)
    want = central_pairwise_plain(force, friction, X, ov, n)
    assert launched == [1]
    assert set(got[3]) == ({"nbs"} if nbs else set())
    _assert_sums(_rows(got, n), _rows(want, n), exact_aux=("nbs",),
                 atol=1e-4)


def test_all_pairs_kernels_refuse_force_without_functor(cuda):
    X, ov, n = _sorting_ball(cuda)

    def plain_force(Xi, r, dist, i, j):
        return Xi
    with pytest.raises(ValueError, match="no CUDA functor"):
        tile_pairwise_pallas(plain_force, friction_w_neighbour, X, ov, n)
    central = S.make_adhesion_central(S.Params())
    del central.cuda_functor
    with pytest.raises(ValueError, match="no CUDA functor"):
        central_pairwise_mxu(central, friction_w_neighbour, X, ov, n)
    # TileEngine() resolves to the kernels on CUDA tensors: no silent
    # plain path
    with pytest.raises(ValueError, match="no CUDA functor"):
        TileEngine().pairwise(plain_force, friction_w_neighbour, X, ov, n,
                              1.0)
    with pytest.raises(ValueError, match="friction"):
        tile_pairwise_pallas(S.make_adhesion(S.Params()),
                             friction_on_background, X, ov, n)


@pytest.mark.parametrize("mxu", [True, False])
def test_sorting_slice_on_gpu_matches_cpu(cuda, mxu):
    p = S.Params()
    force = S.make_adhesion_central(p) if mxu else S.make_adhesion(p)
    engine = TileEngine(mxu=True) if mxu else TileEngine(pallas=True)
    kernel = "central_pair" if mxu else "tile_pair"
    out = {}
    for dev in ("cpu", cuda):
        sol = Solution(S.Cell, 900, engine=engine, device=dev, n_pad=1000)
        sol.h_X = S.Cell(**S.initial_ball(900, 1000, seed=1))
        with launches(kernel) as launched:
            sol.take_steps(2, p.dt, force)
        out[str(dev)] = (sol.copy_to_host(), *launched)
    (h_cpu, l_cpu), (h_gpu, l_gpu) = out["cpu"], out[str(cuda)]
    assert (l_cpu, l_gpu) == (0, 4)
    for f in S.Cell._fields:
        assert isclose(getattr(h_gpu, f)[:900], getattr(h_cpu, f)[:900]), f


GABRIEL = dict(grid_size=16, capacity=8, max_candidates=20)


def _half_space(device, n_cells=2000):
    """The 2,000-cell half-space tissue (1,793 cells in 2,048 rows) with a
    small seeded old_v."""
    h, n = W.half_space_tissue(n_cells, 2048)
    X = Float3(*(torch.as_tensor(h[f], device=device) for f in "xyz"))
    g = torch.Generator().manual_seed(0)
    ov = Float3(*(0.01 * torch.randn(2048, generator=g).to(device)
                  for _ in range(3)))
    return X, ov, n


def _assert_gabriel(got, want):
    """K5 against its plain version: every flag and the friction sum (kept
    non-wall pairs) exact, F and sum_v within tolerance."""
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k
    assert torch.equal(got[1], want[1])
    for a, b in zip(list(got[0]) + list(got[2]),
                    list(want[0]) + list(want[2])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nc", [20, 100, 4])
def test_gabriel_kernel_matches_plain(cuda, nc):
    """K5 with the growth_w_wall functor on the 2,000-cell tissue: compact
    sets that hold every candidate (NC 20, NC 100) and one that overflows
    on most points (NC 4), where the first NC in stencil order must be the
    plain version's."""
    X, ov, n = _half_space(cuda)
    kw = dict(GABRIEL, max_candidates=nc)
    with launches("gabriel_pair") as launched:
        got = gabriel_lattice_pallas(W.relu_force, W.wall_friction, X, ov,
                                     n, 1.0, **kw)
    want = gabriel_lattice_plain(W.relu_force, W.wall_friction, X, ov, n,
                                 1.0, **kw)
    assert launched == [1]
    _assert_gabriel(got, want)
    over = want[3]["__err_gabriel_candidates"][:n]
    if nc == 4:
        # both kinds of point: overflowed and not
        assert 0 < int(over.sum()) < n
        assert float(want[1][:n][over > 0].sum()) > 0
    else:
        assert float(over.max()) == 0.0
    for k in ("__err_lattice_dropped", "__err_out_of_grid"):
        assert float(want[3][k]) == 0.0, k


# K5 edge shapes: (cells, rows, grid, capacity, NC), uniform random points
# over the whole grid.  Capacities no multiple of the 4 ids a lane group
# reads at once, cubes filled to capacity and past it (most cases drop
# points: their ids read zero), C 1, an empty lattice, a single point,
# grids no brick divides, the largest compact set and the smallest, and a
# capacity whose brick is smaller than 4 x 4 x 4
GABRIEL_CASES = {
    "ragged": (4000, 4096, (11, 11, 11), 8, 40),
    "flat": (600, 640, (10, 7, 3), 6, 40),
    "c3": (3000, 3072, 12, 3, 20),
    "c1": (2000, 2048, 12, 1, 20),
    "c16_full": (12000, 12288, 8, 16, GABRIEL_MAX_NC),
    "c32": (6000, 6144, 8, 32, 64),
    "nc1": (3000, 3072, 12, 8, 1),
    "empty": (0, 256, 16, 8, 20),
    "one": (1, 256, 16, 8, 20),
}


@pytest.mark.parametrize("case", list(GABRIEL_CASES))
def test_gabriel_kernel_edge_shapes(cuda, case):
    n, n_pad, grid, cap, nc = GABRIEL_CASES[case]
    dims = (grid,) * 3 if isinstance(grid, int) else grid
    rng = np.random.default_rng(11)
    h = [np.zeros(n_pad, np.float32) for _ in dims]
    for a, g in zip(h, dims):
        a[:n] = rng.uniform(-(g // 2), g - g // 2, n)
    X = Float3(*(torch.as_tensor(a, device=cuda) for a in h))
    ov = Float3(*(torch.as_tensor(
        (0.01 * rng.standard_normal(n_pad)).astype(np.float32), device=cuda)
        for _ in range(3)))
    kw = dict(grid_size=grid, capacity=cap, max_candidates=nc)
    got = gabriel_lattice_pallas(W.relu_force, W.wall_friction, X, ov, n,
                                 1.0, **kw)
    want = gabriel_lattice_plain(W.relu_force, W.wall_friction, X, ov, n,
                                 1.0, **kw)
    _assert_gabriel(got, want)
    assert float(want[3]["__err_out_of_grid"]) == 0.0
    if n > 1 and nc > 1:
        assert float(want[1].sum()) > 0            # kept pairs to compare


def test_gabriel_kernel_refuses_force_or_friction_without_functor(cuda):
    X, ov, n = _half_space(cuda)

    def plain_force(Xi, r, dist, i, j):
        return Xi
    with pytest.raises(ValueError, match="no CUDA functor"):
        gabriel_lattice_pallas(plain_force, W.wall_friction, X, ov, n, 1.0,
                               **GABRIEL)
    with pytest.raises(ValueError, match="friction"):
        gabriel_lattice_pallas(W.relu_force, friction_w_neighbour, X, ov, n,
                               1.0, **GABRIEL)
    with pytest.raises(ValueError, match="max_candidates"):
        gabriel_lattice_pallas(W.relu_force, W.wall_friction, X, ov, n, 1.0,
                               **dict(GABRIEL, max_candidates=129))
    # GabrielEngine() and Solution(solver="gabriel") reach K5 on CUDA
    with pytest.raises(ValueError, match="no CUDA functor"):
        GabrielEngine(grid_size=16).pairwise(plain_force, W.wall_friction,
                                             X, ov, n, 1.0)
    sol = Solution(Float3, 2000, solver="gabriel", grid_size=16,
                   device=cuda, n_pad=2048)
    sol.h_X = Float3(*(a.cpu().numpy() for a in X))
    sol.h_n = n
    with launches("gabriel_pair") as launched:
        sol.take_step(W.dt, W.relu_force, pw_friction=W.wall_friction)
    assert launched == [2]


def gabriel_slice(device, n_steps=2, seed=0):
    """``n_steps`` steps of the growth_w_wall loop on the 2,000-cell
    tissue with K5's engine, the protrusion draws made from a numpy seed;
    returns the host state and the launch counts of K5 and K2."""
    sol = W.half_space_solution(2000, GabrielEngine(lattice=True, **GABRIEL),
                                device)
    links = Links(2000, W.protrusion_strength, device=device)
    links.set_d_n(sol.h_n)
    rng = np.random.default_rng(seed)
    m = links.n_pad
    with launches("gabriel_pair", "pour") as launched:
        for _ in range(n_steps):
            draws = Draws(*(torch.as_tensor(a, device=device) for a in (
                rng.integers(0, 27, m), rng.random(m, np.float32),
                rng.random(m, np.float32))))
            links.update(W.update_protrusions_wall, sol, draws=draws)
            sol.take_step(W.dt, W.relu_force, pw_friction=W.wall_friction,
                          gen_forces=link_wall_forces(links, W.WALL))
    return (sol.copy_to_host(), sol.h_n, *launched)


def test_gabriel_slice_on_gpu_matches_cpu(cuda):
    h_cpu, n, *cpu_launches = gabriel_slice("cpu")
    h_gpu, _, *gpu_launches = gabriel_slice(cuda)
    assert cpu_launches == [0, 0] and gpu_launches == [4, 4]
    for f in "xyz":
        assert isclose(getattr(h_gpu, f)[:n], getattr(h_cpu, f)[:n]), f


def test_lattice_engine_pairwise_on_gpu_matches_cpu(cuda):
    """``LatticeEngine.pairwise`` (K2, K1, the sums back in stable-id order,
    the extras merged) on the card against the same pass on the CPU."""
    engine = LatticeEngine(grid_size=GS, capacity=C, z_block=2,
                           extras_cap=EXTRAS, extras_block_cap=16)
    force = B.make_force(B.Params())
    outs = {}
    for dev in ("cpu", cuda):
        X, ov = load_settled(SETTLED_600, B.Cell, dev)
        with launches("pour", "lattice_pair") as launched:
            out = engine.pairwise(force, friction_w_neighbour,
                                  augment(X, N, B.precompute), ov, N, 1.0)
        assert launched == ([1, 1] if dev == cuda else [0, 0])
        F, sum_f, sum_v, aux = out
        outs[str(dev)] = (type(F)(*(a.cpu() for a in F)), sum_f.cpu(),
                          tuple(a.cpu() for a in sum_v),
                          {k: v.cpu() for k, v in aux.items()})
    flags = [k for k in outs["cpu"][3] if k.startswith("__err_")]
    assert sorted(flags) == ["__err_extras_block", "__err_lattice_dropped",
                             "__err_out_of_grid"]
    _assert_sums(outs[str(cuda)], outs["cpu"],
                 exact_aux=("epi_nbs", *flags))


# (rows, cells, birth_cap, divisions lost): 40 free rows for some hundred
# wanting cells; room for all; a birth_cap below the wanting cells
@pytest.mark.parametrize("n_pad,n,birth_cap,loses", [
    (640, 600, None, True), (8192, 6000, None, False),
    (8192, 6000, 100, True)])
def test_proliferate_on_gpu_matches_cpu(cuda, n_pad, n, birth_cap, loses):
    """``proliferate`` and ``record_divisions`` on the card against the CPU
    with the same draws: the same cells divide into the same slots, the
    lineage tables are equal, the fields equal to rounding of the
    daughters' offsets."""
    h, hov = _branching_cells(n, n_pad, 0.6, 22, seed=4)
    h["v"][:n] *= 2000.0               # about half above the threshold
    p = B.Params()
    d = growth.draw(torch.Generator().manual_seed(9), n_pad,
                    torch.device("cpu"))
    outs = {}
    for dev in ("cpu", cuda):
        X = B.Cell(*(torch.as_tensor(h[f], device=dev)
                     for f in B.Cell._fields))
        ov = Float3(*(torch.as_tensor(hov[f], device=dev) for f in "xyz"))
        props = (torch.full((n_pad,), 3.0, device=dev),
                 torch.ones(n_pad, device=dev))
        draws = growth.Draws(d.rnd.to(dev),
                             Float3(*(a.to(dev) for a in d.direction)))
        lin = growth.lineage_init(2 * n_pad, n_pad, n, device=dev)
        X2, ov2, n2, props2, info = growth.proliferate(
            B.make_want_fn(p), B.make_child_fn(p), X, ov, n, None, props,
            birth_cap, draws=draws)
        lin = growth.record_divisions(lin, info, X2, X2.ctype.to(torch.int32),
                                      0.5)
        outs[str(dev)] = (X2, ov2, n2, props2, info, lin)
    c, g = outs["cpu"], outs[str(cuda)]
    assert g[2] == c[2] > n and g[4][2:] == c[4][2:]
    assert (c[4].n_lost > 0) == loses
    assert torch.equal(g[4].ok.cpu(), c[4].ok)
    assert torch.equal(g[4].child_idx.cpu(), c[4].child_idx)
    for a, b in zip((*g[0], *g[1], *g[3]), (*c[0], *c[1], *c[3])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)
    assert g[5].n_nodes == c[5].n_nodes == c[4].n_divided
    for f, a, b in zip(growth.Lineage._fields[1:], g[5][1:], c[5][1:]):
        assert torch.equal(a.cpu(), b), f
