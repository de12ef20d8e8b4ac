"""The slot-order integrator's glue as CUDA graphs (``ops.lattice_xla.
lattice_heun_steps`` at a fresh binning before every pass).

The loop calls each pass's ``lattice_build`` itself and hands the glue
after each to a segment: ``first`` (the pass, the derivative in stable
order, X1) and ``second`` (the corrector's pass, the Heun combination,
the folds of the aux and the flags).  On the CPU: the segments, run on
their inputs as a graph holds them (each count a 0-d int64 tensor, each
tensor a copy), give the eager loop's bits on the settled 600-cell
branching tissue with its overflow extras held and with them overflowing;
each segment keeps one key over the steps; the builds keep the contract
the benchmark's spy checks (``perfbench/loops/steps.py``); which calls
qualify (``solvers.lattice_segment_key``); that a CPU call never reaches
a graph.  Marked ``gpu`` (skipped without a CUDA device; on a machine with
one, ``python -m pytest tests/test_torch_lattice_segments.py --noconftest
-q``): repeated ``take_steps(11)`` calls on a cap of the settled 500k
tissue replay the segments, equal the eager loop bit for bit and count
two replays a step.
"""
from pathlib import Path

import pytest
import torch

from perfbench.loops.steps import BuildSpy
from test_torch_segment_graph import (  # noqa: F401 (the cuda fixture)
    _OnCuda, cuda, graph_view)
from yalla_tpu_torch import solvers, step_graph
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.ops import lattice_xla
from yalla_tpu_torch.ops.common import ERR_PREFIX, friction_w_neighbour
from yalla_tpu_torch.solvers import (GenericForce, LatticeEngine, Solution,
                                     lattice_segment_key, segment_key)
from yalla_tpu_torch.utils import profiling

CACHE = Path(__file__).resolve().parent.parent / ".bench_cache"
P = B.Params()
FORCE = B.make_force(P)
STEPS = 11
ENGINES = {
    # 9 cells past C 4 held in the extras
    "extras_held": LatticeEngine(grid_size=16, capacity=4, z_block=2,
                                 extras_cap=64, extras_block_cap=16),
    # 42 cells past C 3 for 16 extras: cells dropped, blocks overflowing
    "extras_overflowing": LatticeEngine(grid_size=16, capacity=3, z_block=2,
                                        extras_cap=16, extras_block_cap=8)}


def settled_600():
    torch.set_num_threads(2)
    X, old_v = load_settled(CACHE / "settled_branching_600_s0_v1.npz",
                            B.Cell, device="cpu")
    return X, old_v, 600


def run(engine, X, old_v, n, segment=step_graph.eager, n_steps=STEPS):
    return lattice_xla.lattice_heun_steps(
        n_steps, 1, FORCE, friction_w_neighbour, "com", engine.grid_size,
        engine.capacity, engine.z_block, X, old_v, n, P.dt, P.r_max, 0,
        B.precompute, True, None, None, None, engine.extras_cap,
        engine.extras_block_cap, segment=segment)


def leaves(out):
    X, old_v, aux = out
    return list(zip(X._fields, X)) + list(zip(("vx", "vy", "vz"), old_v)) \
        + sorted(aux.items())


def assert_same_bits(got, want):
    g, w = leaves(got), leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    assert any(k.startswith(ERR_PREFIX) for k, _ in g)
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("engine_name", list(ENGINES))
def test_lattice_segments_on_graph_inputs_give_the_eager_loop(engine_name):
    engine = ENGINES[engine_name]
    X, old_v, n = settled_600()
    lay = lattice_xla.lattice_build(X, old_v, n, P.r_max, engine.grid_size,
                                    engine.capacity, engine.extras_cap)
    assert int(lay.n_extras) > 0
    want = run(engine, X, old_v, n)
    got = run(engine, X, old_v, n, graph_view)
    assert_same_bits(got, want)
    flags = {k: float(v) for k, v in want[2].items()
             if k.startswith(ERR_PREFIX)}
    raised = engine_name == "extras_overflowing"
    assert (flags["__err_lattice_dropped"] > 0) == raised, flags
    assert (flags["__err_extras_block"] > 0) == raised, flags


def test_lattice_segments_keep_one_key_each_over_the_steps():
    """The keys a graph of each segment is kept under
    (``step_graph.cache_key``): one pair, the same at every step, the
    first step's among them."""
    X, old_v, n = settled_600()
    keys = []

    def record(tag, body, tree, copy):
        keys.append(step_graph.cache_key((tag,), tree))
        return graph_view(tag, body, tree, copy)
    run(ENGINES["extras_overflowing"], X, old_v, n, record, n_steps=4)
    assert len(keys) == 8
    assert keys[0] != keys[1]
    assert keys == keys[:2] * 4
    assert all(hash(k) == hash(j) for k, j in zip(keys, keys[:2] * 4))


def test_lattice_segments_keep_the_build_contract(monkeypatch):
    """Through ``Solution.take_steps`` with the segments on graph inputs:
    the builds the benchmark's spy watches by name, two a step, the first
    on the call's input, each predictor's build on the old_v object of
    the build before it, and the states kept from the first, third and
    last step's builds unchanged when the call returns; the spy sees no
    gap."""
    X, old_v, n = settled_600()
    engine = ENGINES["extras_held"]
    cells = Solution(B.Cell, X.x.shape[0], engine=engine,
                     cube_size=P.r_max, device="cpu")
    cells.d_X, cells.d_old_v, cells.d_n = X, old_v, n
    seen = []
    real = lattice_xla.lattice_build

    def build(Xc, ovc, *args, **kwargs):
        seen.append((Xc, ovc, [a.clone() for a in (*Xc, *ovc)]))
        return real(Xc, ovc, *args, **kwargs)
    monkeypatch.setattr(lattice_xla, "lattice_build", build)
    monkeypatch.setattr(solvers, "_segments", lambda key: graph_view)
    with BuildSpy(lattice_xla, X, old_v, STEPS) as spy:
        cells.take_steps(STEPS, P.dt, FORCE, pw_friction=friction_w_neighbour,
                         precompute=B.precompute)
    spy.finish()
    assert spy.calls == len(seen) == 2 * STEPS
    assert spy.gaps and not any(spy.gaps), spy.gaps
    assert seen[0][0] is X and seen[0][1] is old_v
    for k in range(1, 2 * STEPS, 2):
        assert seen[k][1] is seen[k - 1][1], k
    assert sorted(spy.kept) == [0, 2, 2 * STEPS - 2]
    for k, (Xk, ovk) in spy.kept.items():
        assert Xk is seen[k][0] and ovk is seen[k][1]
        for a, c in zip((*Xk, *ovk), seen[k][2]):
            assert torch.equal(a, c), k
    # the interval's output is not a state a build kept
    assert all(cells.d_X.x is not s[0].x for s in seen)


def key(X=None, engine=ENGINES["extras_held"], rebuild_every=1, gen=None,
        rebin_m_cap=0, dt=P.dt):
    if X is None:
        X = B.Cell(*(_OnCuda() for _ in B.Cell._fields))
    return lattice_segment_key(engine, rebuild_every, FORCE,
                               friction_w_neighbour, "com", X, dt, P.r_max,
                               0, B.precompute, gen, rebin_m_cap)


def test_lattice_segment_key_on_cuda_at_a_build_every_pass():
    assert key() is not None
    assert key() == key(engine=LatticeEngine(grid_size=16, capacity=4,
                                             z_block=2, extras_cap=64,
                                             extras_block_cap=16))
    assert key() != key(engine=ENGINES["extras_overflowing"])
    assert key() != key(dt=P.dt / 2)
    # not the key of an eager Heun step's segments on the same engine
    assert key() != segment_key(ENGINES["extras_held"], FORCE,
                                friction_w_neighbour, "com",
                                B.Cell(*(_OnCuda() for _ in B.Cell._fields)),
                                P.dt, P.r_max, 0, B.precompute)


@pytest.mark.parametrize("case", ["cpu", "capturing", "rebuild_every",
                                  "rebin", "generic_force", "dt_tensor"])
def test_lattice_segment_key_none_where_the_loop_runs_eagerly(case,
                                                              monkeypatch):
    kw = {"cpu": dict(X=B.Cell(*(torch.zeros(8) for _ in B.Cell._fields))),
          "capturing": {}, "rebuild_every": dict(rebuild_every=4),
          "rebin": dict(rebin_m_cap=64),
          "generic_force": dict(gen=GenericForce(lambda X, n, args: X,
                                                 capture_key="k")),
          "dt_tensor": dict(dt=torch.tensor(P.dt))}[case]
    if case == "capturing":
        monkeypatch.setattr(solvers, "_capturing", lambda: True)
    assert key(**kw) is None


def test_take_steps_on_the_cpu_never_reaches_a_graph(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU call reached a CUDA graph")
    monkeypatch.setattr(step_graph, "segment", refuse)
    X, old_v, n = settled_600()
    cells = Solution(B.Cell, X.x.shape[0], engine=ENGINES["extras_held"],
                     cube_size=P.r_max, device="cpu")
    cells.d_X, cells.d_old_v, cells.d_n = X, old_v, n
    cells.take_steps(2, P.dt, FORCE, pw_friction=friction_w_neighbour,
                     precompute=B.precompute)
    assert_same_bits((cells.d_X, cells.d_old_v, cells.aux),
                     run(ENGINES["extras_held"], X, old_v, n, n_steps=2))


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

N_PAD = 32768
CARD_ENGINE = LatticeEngine(grid_size=72, capacity=6, z_block=2,
                            extras_cap=1024, extras_block_cap=64)


def cap_cells(device):
    """The cells of the settled 500k tissue with x > 22 (19,927 cells) in
    ``N_PAD`` rows, on ``CARD_ENGINE``: (Solution, held state)."""
    X, old_v = load_settled(CACHE / "settled_branching_500000_s0_v1.npz",
                            B.Cell, device="cpu")
    keep = torch.nonzero(X.x[:500_000] > 22.0).squeeze(1)
    n = keep.numel()

    def pad(a):
        return torch.cat([a[keep], a.new_zeros(N_PAD - n)]).to(device)
    cells = Solution(B.Cell, N_PAD, engine=CARD_ENGINE, cube_size=P.r_max,
                     device=device)
    return cells, (B.Cell(*(pad(a) for a in X)),
                   Float3(*(pad(a) for a in old_v)), n)


def card_calls(cells, held, calls=3):
    """``calls`` calls of ``take_steps(STEPS)`` from ``held``: each call's
    outputs, and a copy of them made when it returned."""
    cells.d_X, cells.d_old_v, cells.d_n = held
    out = []
    for _ in range(calls):
        cells.take_steps(STEPS, P.dt, FORCE,
                         pw_friction=friction_w_neighbour,
                         precompute=B.precompute)
        got = (cells.d_X, cells.d_old_v, cells.aux)
        out.append((got, [(k, a.clone()) for k, a in leaves(got)]))
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
def test_graphed_take_steps_are_the_eager_loop(cuda, monkeypatch):
    cells, held = cap_cells(cuda)
    lay = lattice_xla.lattice_build(held[0], held[1], held[2], P.r_max,
                                    CARD_ENGINE.grid_size,
                                    CARD_ENGINE.capacity,
                                    CARD_ENGINE.extras_cap)
    assert int(lay.n_extras) > 0 and int(lay.n_dropped) == 0
    step_graph.clear()
    with profiling.tracing():
        got = card_calls(cells, held)
        counters = profiling.counters()
    with monkeypatch.context() as m:
        m.setattr(solvers, "lattice_segment_key", lambda *args: None)
        with profiling.tracing():
            want = card_calls(cells, held)
            eager = profiling.counters()
    assert not any(k.startswith("integrator.segment") for k in eager)
    assert counters["integrator.segment_capture"] == 2
    # the first call: eager at step 1, captured at step 2
    assert counters["integrator.segment_replay"] == 2 * (STEPS - 2) \
        + 2 * STEPS * 2
    assert counters["kernels.lattice_pair"] == 2 * STEPS * 3
    assert counters["kernels.pour"] == eager["kernels.pour"] == 2 * STEPS * 3
    assert len(step_graph.segment_keys()) == 2
    for k, ((g, g_copy), (w, _)) in enumerate(zip(got, want)):
        assert_same_bits(g, w)
        # kept past every later replay, unchanged
        for (name, a), (_, c) in zip(leaves(g), g_copy):
            assert torch.equal(a, c), (k, name)

    # a later call with another count replays every segment: the count
    # is an input of the graphs, not a constant of their capture
    fewer = (held[0], held[1], held[2] - 2000)
    with profiling.tracing():
        (got_fewer, _), = card_calls(cells, fewer, calls=1)
        counters = profiling.counters()
    assert counters["integrator.segment_replay"] == 2 * STEPS
    assert "integrator.segment_capture" not in counters
    with monkeypatch.context() as m:
        m.setattr(solvers, "lattice_segment_key", lambda *args: None)
        (want_fewer, _), = card_calls(cells, fewer, calls=1)
    assert_same_bits(got_fewer, want_fewer)
    assert not torch.equal(got_fewer[0].x, got[0][0][0].x)
    step_graph.clear()
