"""The port's multi-device paths against the JAX package, on the CPU.

Each test of ``tests/test_parallel.py`` has one here, at a smaller size:
the port's sharded run on 2 or 4 ranks (processes over gloo, started by
``parallel._comm.spawn``; they import only the port) against the JAX
package's single-device run in this process, as ``test_parallel.py``
holds JAX's sharded run against it.  Tolerances: positions within atol
5e-5 (``test_parallel.py``'s own) or the reference's ``isclose``
(atol 1e-6 + rtol 1e-2) where ``test_parallel.py`` takes that; the
``__err_*`` flags equal.  Then the engines' ``(i_offset, i_size)`` window
against JAX's (the plain passes; forces and ``sum_v`` within atol 1e-5,
friction sums and flags exact), its routing, and the dry run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu import Float3 as JFloat3
from yalla_tpu.inits import relu_force as j_relu
from yalla_tpu.links import Links as JLinks
from yalla_tpu.links import link_forces as j_link_forces
from yalla_tpu.ops import grid_xla as JG
from yalla_tpu.ops import pairwise_xla as JP
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.lattice_xla import lattice_heun_steps as j_lattice_steps
from yalla_tpu.solvers import TileEngine as JTileEngine
from yalla_tpu.solvers import heun_steps as j_heun_steps
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.ops import grid_xla as TG
from yalla_tpu_torch.ops import pairwise_xla as TP
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.parallel import dryrun
from yalla_tpu_torch.parallel._comm import spawn
from yalla_tpu_torch.solvers import (GabrielEngine, GridEngine,
                                     LatticeEngine, TileEngine)

torch.set_num_threads(2)


def j_spring(Xi, r, dist, i, j):
    """``tests/test_parallel.py::clipped_spring``."""
    valid = (i != j) & (dist < 1.0)
    safe = jnp.where(dist > 0, dist, 1.0)
    w = jnp.where(valid, (0.5 - dist) / safe, 0.0)
    return JFloat3(x=r.x * w, y=r.y * w, z=r.z * w)


def block(dims, n_pad, seed, spacing=0.75):
    """``test_parallel.py``'s jittered block of cells, ``dims`` (x, y, z)
    cells on a side, here long in z so that every slab of the grid holds
    cells: numpy f32 positions ``[n_pad, 3]``, zeros past the cells;
    returns ``(n, pos)``."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"),
                 -1).reshape(-1, 3)
    n = len(g)
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:n] = (g - np.asarray(dims) / 2) * spacing \
        + rng.uniform(-0.15, 0.15, (n, 3))
    return n, pos


def sphere(n, n_pad, seed):
    """Points uniform in a ball of radius ``(n / 0.74)^(1/3) * 0.37``
    (about ``random_sphere(0.733333)``'s packing), zeros past ``n``."""
    rng = np.random.default_rng(seed)
    r = 0.733333 * (n / 0.74) ** (1 / 3) / 2 * rng.random(n) ** (1 / 3)
    v = rng.normal(size=(n, 3))
    pos = np.zeros((n_pad, 3), np.float32)
    pos[:n] = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    return pos


def fields(pos):
    return {f: pos[:, k].copy() for k, f in enumerate("xyz")}


def zeros3(n_pad):
    return {f: np.zeros(n_pad, np.float32) for f in "xyz"}


def jax_state(pos):
    X = JFloat3(*(jnp.asarray(pos[:, k]) for k in range(3)))
    return X, JFloat3.zeros(pos.shape[0])


def jax_flags(aux):
    return {k: float(np.max(np.asarray(v))) for k, v in aux.items()
            if k.startswith("__err_")}


def assert_positions(got, want, n, close):
    for f, b in zip("xyz", want):
        a, b = got[f][:n], np.asarray(b)[:n]
        if close == "isclose":
            assert isclose(a, b), f"{f}: {np.abs(a - b).max()}"
        else:
            assert np.allclose(a, b, atol=close), \
                f"{f}: {np.abs(a - b).max()}"


def assert_flags(got, want):
    """Every flag both runs raise is equal (the JAX single-device run
    publishes some the sharded paths do not, and the other way round)."""
    common = set(got) & set(want)
    assert common, (got, want)
    for k in common:
        assert got[k] == want[k], (k, got[k], want[k])


# ---- the cells axis -------------------------------------------------------

@pytest.mark.parametrize("kind,n_ranks", [("tile", 2), ("grid", 4)])
def test_port_sharded_cells_step_matches_jax(kind, n_ranks):
    """``test_sharded_tile_matches_single`` and
    ``test_sharded_grid_matches_single``: 2 steps of ``clipped_spring`` on
    50 cells in 128 rows, the port's sharded step on the ranks' rows
    (the windowed plain pass) against JAX's single-device steps."""
    n, n_pad = 50, 128
    pos = sphere(n, n_pad, seed=2024)
    from yalla_tpu.solvers import GridEngine as JGridEngine
    jeng = JTileEngine() if kind == "tile" else JGridEngine()
    X, ov = jax_state(pos)
    Xs, _, aux = j_heun_steps(2, jeng, j_spring, j_friction, None, "com", X,
                              ov, jnp.int32(n), jnp.float32(0.1),
                              jnp.float32(1.0), jnp.int32(0), None)
    eng = TileEngine() if kind == "tile" else GridEngine()
    got = spawn(dryrun.run_cells, n_ranks, eng, "clipped_spring",
                fields(pos), zeros3(n_pad), n, 0.1, 1.0, 2,
                device="cpu")
    assert_positions(got["X"], Xs, n, "isclose")
    assert_positions(got["X"], Xs, n, 1e-5)
    assert_flags(got["flags"], jax_flags(aux))


@pytest.mark.parametrize("fix_mode", ["point", "com_z"])
def test_port_sharded_cells_step_fixes_a_point(fix_mode):
    """The pinned point's fix from the rank that holds it: 4 ranks of 32
    rows, the point (row 70) on rank 2, against JAX's single-device
    step."""
    n, n_pad = 100, 128
    pos = sphere(n, n_pad, seed=7)
    X, ov = jax_state(pos)
    Xs, _, aux = j_heun_steps(2, JTileEngine(), j_spring, j_friction, None,
                              fix_mode, X, ov, jnp.int32(n),
                              jnp.float32(0.1), jnp.float32(1.0),
                              jnp.int32(70), None)
    got = spawn(dryrun.run_cells, 4, TileEngine(), "clipped_spring",
                fields(pos), zeros3(n_pad), n, 0.1, 1.0, 2, fix_mode, 70,
                device="cpu")
    assert_positions(got["X"], Xs, n, 1e-5)
    assert_flags(got["flags"], jax_flags(aux))


# ---- the z-slab ----------------------------------------------------------

GS, C, ZB = 16, 8, 2


@pytest.fixture(scope="module")
def slab_reference():
    """JAX's single-device resident lattice run (4 steps, a build every
    2) of ``relu_force`` on 1,152 cells, shared by the z-slab tests."""
    n_pad = 1280
    n, pos = block((8, 8, 18), n_pad, seed=11)
    X, ov = jax_state(pos)
    Xs, _, aux = j_lattice_steps(
        4, 2, j_relu, j_friction, "com", GS, C, ZB, X, ov, jnp.int32(n),
        jnp.float32(0.1), jnp.float32(1.0), jnp.int32(0))
    return n, n_pad, pos, Xs, jax_flags(aux)


@pytest.mark.parametrize("pallas,n_ranks", [(False, 4), (False, 2),
                                            (True, 2), (True, 4)])
def test_port_z_slab_matches_jax(slab_reference, pallas, n_ranks):
    """``test_lattice_z_slab_sharded_matches_single`` (``pallas=False``)
    and ``test_lattice_z_slab_sharded_pallas_matches_single``
    (``pallas=True``): the port's z-slab run against JAX's single-device
    run, cells in every slab.  Both reach K1's wrapper, which on CPU
    tensors runs its plain version with ``z_halo``
    (``pairwise_on_padded`` on the exchanged planes)."""
    n, n_pad, pos, Xs, flags = slab_reference
    got = spawn(dryrun.run_slab, n_ranks, "relu", fields(pos),
                zeros3(n_pad), n, 0.1, 1.0, GS, C, ZB, 4, 2, pallas,
                device="cpu")
    assert got["flags"]["__err_lattice_dropped"] == 0
    assert got["flags"]["__err_non_finite"] == 0
    assert_positions(got["X"], Xs, n, 5e-5)
    assert_flags(got["flags"], flags)
    cz = np.clip(np.floor(pos[:n, 2]) + GS // 2, 0, GS - 1)
    assert len(np.unique(cz // (GS // n_ranks))) == n_ranks


def test_port_z_slab_pallas_false_reaches_the_kernel_wrapper(
        slab_reference, monkeypatch):
    """On a ring of one rank, in this process (so that the spy sees the
    calls): ``lattice_sharded_heun_steps(..., pallas=False)`` calls
    ``lattice_pairwise_pallas`` once a pass, 2 a step, and
    ``ShardedLatticeEngine(pallas=False).pairwise`` once a call, each
    with ``z_halo``; their results equal ``pallas=True``'s bit for bit,
    and the run's positions are within 5e-5 of JAX's single-device run,
    its shared flags equal."""
    from yalla_tpu_torch.inits import relu_force
    from yalla_tpu_torch.parallel import lattice_spmd
    from yalla_tpu_torch.parallel._comm import single
    n, n_pad, pos, Xs, flags = slab_reference
    calls = []
    real = lattice_spmd.lattice_pairwise_pallas

    def spy(*args, **kw):
        calls.append(kw["z_halo"] is not None)
        return real(*args, **kw)
    monkeypatch.setattr(lattice_spmd, "lattice_pairwise_pallas", spy)
    mesh = single("cpu")
    X = Float3(*(torch.as_tensor(pos[:, k]) for k in range(3)))
    ov = Float3.zeros(n_pad, device="cpu")
    steps, passes = {}, {}
    for pallas in (False, True):
        del calls[:]
        steps[pallas] = lattice_spmd.lattice_sharded_heun_steps(
            mesh, 4, 2, relu_force, friction_w_neighbour, "com", GS, C, ZB,
            X, ov, n, 0.1, 1.0, 0, pallas=pallas)
        assert calls == [True] * 8, pallas
        del calls[:]
        eng = lattice_spmd.ShardedLatticeEngine(mesh, GS, C, ZB, pallas)
        passes[pallas] = eng.pairwise(relu_force, friction_w_neighbour, X,
                                      ov, n, 1.0)
        assert calls == [True], pallas
    (Xf, ovf, auxf), (Xt, ovt, auxt) = steps[False], steps[True]
    for a, b in zip([*Xf, *ovf], [*Xt, *ovt]):
        assert torch.equal(a, b)
    assert auxf.keys() == auxt.keys()
    assert all(torch.equal(auxf[k], auxt[k]) for k in auxt)
    (Ff, sff, svf, axf), (Ft, sft, svt, axt) = passes[False], passes[True]
    for a, b in zip([*Ff, sff, *svf, *axf.values()],
                    [*Ft, sft, *svt, *axt.values()]):
        assert torch.equal(a, b)
    assert_positions({f: a.numpy() for f, a in zip("xyz", Xf)}, Xs, n, 5e-5)
    assert_flags({k: float(v.float().max()) for k, v in auxf.items()
                  if k.startswith("__err_")}, flags)


def _links(rng, n, seed):
    """A JAX ``Links`` of ``n // 2`` random z-spanning links, and its
    table for the port."""
    links = JLinks(n // 2, strength=0.25, seed=seed)
    links.h_a[:n // 2] = rng.integers(0, n, n // 2)
    links.h_b[:n // 2] = rng.integers(0, n, n // 2)
    links.copy_to_device()
    return links, (links.h_a[:n // 2].copy(), links.h_b[:n // 2].copy(),
                   0.25)


def test_port_resident_sharded_links_match_jax():
    """``test_resident_sharded_links_match_single``: links inside the
    resident z-slab loop (the slot channels gathered to stable order, the
    hook on every rank, each rank adding its slab's rows) against JAX's
    single-device resident run with the same generic force; 4 ranks,
    grid 16, C 16."""
    n_pad = 1024
    rng = np.random.default_rng(31)
    n, pos = block((7, 7, 16), n_pad, seed=31, spacing=0.8)
    links, table = _links(rng, n, seed=7)
    gen = j_link_forces(links)
    X, ov = jax_state(pos)
    Xs, _, aux = j_lattice_steps(
        4, 2, j_spring, j_friction, "com", GS, 16, ZB, X, ov, jnp.int32(n),
        jnp.float32(0.1), jnp.float32(1.0), jnp.int32(0), None, False,
        gen._replace(args=None), gen.args)
    got = spawn(dryrun.run_slab, 4, "clipped_spring", fields(pos),
                zeros3(n_pad), n, 0.1, 1.0, GS, 16, ZB, 4, 2, False, table,
                device="cpu")
    assert got["flags"]["__err_lattice_dropped"] == 0
    assert_positions(got["X"], Xs, n, 5e-5)
    assert_flags(got["flags"], jax_flags(aux))


def test_port_sharded_lattice_engine_with_links():
    """``test_sharded_lattice_engine_with_links``: ``heun_steps`` on a
    ``ShardedLatticeEngine`` (a build per pass) with links, friction
    mixing and the COM fix, 2 ranks, against JAX's single-device
    all-pairs run."""
    n_pad = 640
    rng = np.random.default_rng(21)
    n, pos = block((6, 6, 16), n_pad, seed=21, spacing=0.8)
    links, table = _links(rng, n, seed=5)
    gen = j_link_forces(links)
    X, ov = jax_state(pos)
    Xs, _, aux = j_heun_steps(4, JTileEngine(), j_spring, j_friction,
                              gen._replace(args=None), "com", X, ov,
                              jnp.int32(n), jnp.float32(0.1),
                              jnp.float32(1.0), jnp.int32(0), gen.args)
    got = spawn(dryrun.run_engine, 2, "clipped_spring", fields(pos),
                zeros3(n_pad), n, 0.1, 1.0, GS, 16, ZB, 4, False, table,
                device="cpu")
    assert got["flags"]["__err_lattice_dropped"] == 0
    assert_positions(got["X"], Xs, n, 5e-5)
    assert_flags(got["flags"], jax_flags(aux))


# ---- the (i_offset, i_size) window ---------------------------------------

def _tissue(n=300, n_pad=384, half=2.5, seed=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-half, half, (n_pad, 3)).astype(np.float32)
    ov = rng.random((n_pad, 3)).astype(np.float32)
    jX = JFloat3(*(jnp.asarray(pos[:, k]) for k in range(3)))
    jov = JFloat3(*(jnp.asarray(ov[:, k]) for k in range(3)))
    tX = Float3(*(torch.as_tensor(pos[:, k].copy()) for k in range(3)))
    tov = Float3(*(torch.as_tensor(ov[:, k].copy()) for k in range(3)))
    return n, jX, jov, tX, tov


def t_spring(Xi, r, dist, i, j):
    return dryrun.clipped_spring(Xi, r, dist, i, j)


def _assert_window(t, j, size):
    for f, a, b in zip("xyz", t[0], j[0]):
        assert a.shape == (size,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=f"F.{f}")
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    for c in range(3):
        np.testing.assert_allclose(t[2][c].numpy(), np.asarray(j[2][c]),
                                   atol=1e-5)
    for k in j[3]:
        np.testing.assert_array_equal(t[3][k].numpy(), np.asarray(j[3][k]),
                                      err_msg=k)


@pytest.mark.parametrize("i_offset,i_size", [(128, 128), (96, 160)])
@pytest.mark.parametrize("pass_", ["tile", "grid", "gabriel"])
def test_window_matches_jax(pass_, i_offset, i_size):
    """``tile_pairwise``, ``grid_pairwise`` and ``gabriel_pairwise`` on the
    rows ``[i_offset, i_offset + i_size)`` against the JAX passes."""
    n, jX, jov, tX, tov = _tissue()
    win = dict(i_offset=i_offset, i_size=i_size)
    if pass_ == "tile":
        j = JP.tile_pairwise(j_spring, j_friction, jX, jov, jnp.int32(n),
                             **win)
        t = TP.tile_pairwise(t_spring, friction_w_neighbour, tX, tov, n,
                             **win)
    elif pass_ == "grid":
        j = JG.grid_pairwise(j_spring, j_friction, jX, jov, jnp.int32(n),
                             1.0, grid_size=16, row_cap=32, i_block=64,
                             **win)
        t = TG.grid_pairwise(t_spring, friction_w_neighbour, tX, tov, n,
                             1.0, grid_size=16, row_cap=32, i_block=64,
                             **win)
    else:
        j = JG.gabriel_pairwise(j_spring, j_friction, jX, jov, jnp.int32(n),
                                1.0, grid_size=16, row_cap=32, i_block=32,
                                max_candidates=40, **win)
        t = TG.gabriel_pairwise(t_spring, friction_w_neighbour, tX, tov, n,
                                1.0, grid_size=16, row_cap=32, i_block=32,
                                max_candidates=40, **win)
    _assert_window(t, j, i_size)


def test_window_never_reaches_a_kernel(monkeypatch):
    """A windowed ``pairwise`` runs the plain pass on every engine that
    has a kernel (K3, K4, K5 sum the whole population only), and the
    window's rows equal the whole pass's; ``LatticeEngine.pairwise``
    refuses a window, where JAX asserts."""
    from yalla_tpu_torch.ops import central_mxu, gabriel_pallas, tile_pallas

    def refuse(*a, **k):
        raise AssertionError("a windowed pass reached a kernel")
    n, _, _, tX, tov = _tissue()
    whole = {
        "tile": TileEngine(pallas=False, mxu=False).pairwise(
            t_spring, friction_w_neighbour, tX, tov, n, 1.0),
        "gabriel": GabrielEngine(grid_size=16, lattice=False).pairwise(
            t_spring, friction_w_neighbour, tX, tov, n, 1.0)}
    for mod, name in ((tile_pallas, "tile_pairwise_pallas"),
                      (central_mxu, "central_pairwise_mxu"),
                      (gabriel_pallas, "gabriel_lattice_pallas")):
        monkeypatch.setattr(mod, name, refuse)
    for kind, eng in (("tile", TileEngine(pallas=True, mxu=True)),
                      ("gabriel", GabrielEngine(grid_size=16,
                                                lattice=True))):
        out = eng.pairwise(t_spring, friction_w_neighbour, tX, tov, n, 1.0,
                           i_offset=128, i_size=128)
        assert torch.equal(out[1], whole[kind][1][128:256])
        for a, b in zip(out[0], whole[kind][0]):
            torch.testing.assert_close(a, b[128:256], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="window"):
        LatticeEngine(grid_size=16).pairwise(
            t_spring, friction_w_neighbour, tX, tov, n, 1.0, i_offset=128,
            i_size=128)


# ---- the dry run ------------------------------------------------------------

def test_dryrun_multichip_on_the_cpu(capfd):
    """``dryrun_multichip(2, device="cpu")``: both sharded paths, the
    division passes and JAX's asserts, on two gloo ranks; rank 0 prints
    ``__graft_entry__.dryrun_multichip``'s two lines."""
    out = dryrun.dryrun_multichip(2, device="cpu")
    lines = capfd.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith("dryrun_multichip")] == [
        f"dryrun_multichip: cells-axis step OK on 2 devices (n=64, "
        f"n_pad=128)",
        f"dryrun_multichip: OK on 2 devices (z-slab lattice + in-scan "
        f"proliferation, n={out['n_cells']}, n_pad=128)"]
    assert out["n_cells"] >= 64 and out["transport"] == "gloo"


def test_spawn_raises_a_rank_error():
    """A rank that raises stops the run, and the error reaches the
    caller."""
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="grid z extent"):
        spawn(dryrun.run_slab, 3, "relu", fields(block((2, 2, 2), 128,
                                                       1)[1]),
              zeros3(128), 10, 0.1, 1.0, GS, C, ZB, 2, 2, False,
              device="cpu")
