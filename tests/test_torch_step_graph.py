"""The Heun step's CUDA graph (``yalla_tpu_torch/step_graph.py``).

On the CPU: which steps qualify and what their key holds
(``solvers.step_graph_key``), that a CPU step never reaches the graph,
that a key called once is run eagerly and remembered within a bound, and
the counters' tally.  Marked ``gpu`` (skipped without a CUDA device; on a
machine with one, ``python -m pytest tests/test_torch_step_graph.py
--noconftest -q``): frames of the flagship on a cap of the settled 500k
tissue (about 20k cells, overflow extras live, the count changing between
substeps), the graph's steps against the eager steps bit for bit, the
counters, the outputs kept past later replays, and the cache's eviction.
"""
from pathlib import Path

import pytest
import torch

from yalla_tpu_torch import solvers, step_graph
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.growth import lineage_init
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.ops.common import (ERR_PREFIX, friction_w_neighbour,
                                        momentum_fix)
from yalla_tpu_torch.ops.lattice_xla import lattice_build
from yalla_tpu_torch.solvers import (GabrielEngine, GenericForce, GridEngine,
                                     LatticeEngine, TileEngine, heun_step,
                                     step_graph_key)
from yalla_tpu_torch.utils import profiling

CACHE = Path(__file__).resolve().parent.parent / ".bench_cache"
SETTLED_500K = CACHE / "settled_branching_500000_s0_v1.npz"
SETTLED_600 = CACHE / "settled_branching_600_s0_v1.npz"
P = B.Params()
FORCE = B.make_force(P)
ENGINE = LatticeEngine(grid_size=72, capacity=6, z_block=2, extras_cap=1024,
                       extras_block_cap=64)
N_PAD, SUBSTEPS = 32768, 6


class _OnCuda:
    """Stands for a CUDA tensor where only its description is read."""
    is_cuda = True
    dtype = torch.float32
    device = torch.device("cuda")

    def __init__(self, rows=N_PAD):
        self.shape = torch.Size([rows])


def state_of(rows=N_PAD):
    """A flagship state of tensor stand-ins: (X, old_v)."""
    return (B.Cell(*(_OnCuda(rows) for _ in B.Cell._fields)),
            Float3(*(_OnCuda(rows) for _ in range(3))))


def key(engine=ENGINE, X=None, old_v=None, dt=P.dt, cube_size=P.r_max,
        gen=None, force=FORCE):
    if X is None:
        X, old_v = state_of()
    return step_graph_key(engine, force, friction_w_neighbour, "com", X,
                          old_v, dt, cube_size, 0, B.precompute, gen)


def test_step_graph_key_on_a_cuda_kernel_lattice_engine():
    assert key() is not None


def test_step_graph_key_none_on_cpu_tensors():
    X = B.Cell(*(torch.zeros(N_PAD) for _ in B.Cell._fields))
    old_v = Float3.zeros(N_PAD, device="cpu")
    assert key(X=X, old_v=old_v) is None


@pytest.mark.parametrize("engine", [
    TileEngine(), GridEngine(), GabrielEngine(),
    LatticeEngine(grid_size=72, capacity=6, pallas=False)],
    ids=["tile", "grid", "gabriel", "lattice_pallas_false"])
def test_step_graph_key_none_for_other_engines(engine):
    assert key(engine=engine) is None


def test_step_graph_key_none_with_a_generic_force():
    gen = GenericForce(lambda X, n, args: X)
    assert key(gen=gen) is None


def test_step_graph_key_one_for_equal_engines():
    twin = LatticeEngine(grid_size=72, capacity=6, z_block=2,
                         extras_cap=1024, extras_block_cap=64)
    assert twin is not ENGINE
    assert key(engine=twin) == key()
    assert hash(key(engine=twin)) == hash(key())


@pytest.mark.parametrize("change", [
    dict(dt=0.1), dict(cube_size=1.5), dict(force=B.make_force(P)),
    dict(force=B.make_force(P._replace(D_v=0.3))),
    dict(engine=LatticeEngine(grid_size=72, capacity=8, z_block=2,
                              extras_cap=1024, extras_block_cap=64)),
    dict(X=state_of(N_PAD + 4096)[0], old_v=state_of(N_PAD + 4096)[1])],
    ids=["dt", "cube_size", "force", "force_params", "engine", "rows"])
def test_step_graph_key_another_for_a_change(change):
    assert key(**change) is not None
    assert key(**change) != key()


def test_heun_step_on_the_cpu_never_reaches_the_graph(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU step reached the CUDA graph")
    monkeypatch.setattr(step_graph, "run", refuse)
    X, old_v = load_settled(SETTLED_600, B.Cell, device="cpu")
    engine = LatticeEngine(grid_size=32, capacity=4, z_block=2)
    args = (engine, FORCE, friction_w_neighbour, "com", X, old_v, 600,
            P.dt, P.r_max, 0, B.precompute)
    X1, ov1, aux = heun_step(*args)
    X2, ov2, aux2 = solvers._heun(*args, None, None)
    assert all(torch.equal(a, b) for a, b in zip(X1, X2))
    assert all(torch.equal(a, b) for a, b in zip(ov1, ov2))
    assert aux.keys() == aux2.keys()
    assert all(torch.equal(aux[k], aux2[k]) for k in aux)


def test_step_graph_runs_a_key_seen_once_eagerly_and_bounds_what_it_keeps():
    step_graph.clear()
    calls = []

    def body(X, old_v, n):
        calls.append(n)
        return X, old_v, {}
    for k in range(3 * step_graph._MAX_SEEN):
        # a fresh closure every step: a new key each time
        assert step_graph.run(("fresh", k), body, (), (), k) == ((), (), {})
    assert calls == list(range(3 * step_graph._MAX_SEEN))
    assert step_graph.keys() == []
    assert len(step_graph._steps.seen) == step_graph._MAX_SEEN
    step_graph.clear()
    assert not step_graph._steps.seen


def test_tally_keeps_counts_off_the_table():
    with profiling.tracing():
        profiling.count("kernels.pour")
        with profiling.tally() as t:
            profiling.count("kernels.pour", 2)
            profiling.count("kernels.lattice_pair")
        profiling.count("kernels.pour")
        assert profiling.counters() == {"kernels.pour": 2}
    assert t == {"kernels.pour": 2, "kernels.lattice_pair": 1}
    with profiling.tally() as t:
        profiling.count("integrator.graph_replay")
    assert t == {"integrator.graph_replay": 1}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cap_state(device):
    """The cells of the settled 500k tissue with x > 22 (19,927 cells,
    4,610 of them epithelial) in ``N_PAD`` rows, as a flagship state."""
    X, old_v = load_settled(SETTLED_500K, B.Cell, device="cpu")
    keep = torch.nonzero(X.x[:500_000] > 22.0).squeeze(1)
    n = keep.numel()

    def pad(a):
        return torch.cat([a[keep], a.new_zeros(N_PAD - n)]).to(device)
    key = torch.Generator(device=device)
    key.manual_seed(5)
    return B.State(X=B.Cell(*(pad(a) for a in X)),
                   old_v=Float3(*(pad(a) for a in old_v)), n=n,
                   lineage=lineage_init(2 * N_PAD, N_PAD, n, device=device),
                   epi_nbs=torch.zeros(N_PAD, device=device),
                   mes_nbs=torch.zeros(N_PAD, device=device), key=key)


def leaves(out):
    """A step's outputs as ``[(name, tensor)]``."""
    X, old_v, aux = out
    return ([(f, a) for f, a in zip(X._fields, X)]
            + [("old_v." + f, a) for f, a in zip("xyz", old_v)]
            + sorted(aux.items()))


def frame_steps(frame, state, monkeypatch):
    """The frame's result, and each of its steps: (n, outputs, a copy of
    the outputs made when the step returned)."""
    steps = []
    real = B.heun_step

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        steps.append((args[6], out,
                      [(k, a.clone()) for k, a in leaves(out)]))
        return out
    with monkeypatch.context() as m:
        m.setattr(B, "heun_step", spy)
        out, errs = frame(state, 0.0)
    torch.cuda.synchronize()
    return out, errs, steps


@pytest.mark.gpu
def test_graph_step_is_the_eager_step_bit_for_bit(cuda, monkeypatch):
    state = cap_state(cuda)
    lay = lattice_build(state.X, state.old_v, state.n, P.r_max,
                        ENGINE.grid_size, ENGINE.capacity, ENGINE.extras_cap)
    assert int(lay.n_extras) > 0 and int(lay.n_dropped) == 0
    step_graph.clear()
    frame = B.make_frame(P, ENGINE, substeps=SUBSTEPS)
    with profiling.tracing():
        got, got_errs, got_steps = frame_steps(frame, state, monkeypatch)
        counters = profiling.counters()
    with monkeypatch.context() as m:
        m.setattr(solvers, "step_graph_key", lambda *args: None)
        m.setattr(solvers, "segment_key", lambda *args: None)
        with profiling.tracing():
            want, want_errs, want_steps = frame_steps(frame, state,
                                                      monkeypatch)
            eager = profiling.counters()
    assert "integrator.graph_capture" not in eager

    ns = [n for n, _, _ in got_steps]
    assert len(set(ns)) > 2, ns
    assert ns == [n for n, _, _ in want_steps]
    assert counters["integrator.graph_capture"] == 1
    assert counters["integrator.graph_replay"] == SUBSTEPS - 2
    assert counters["kernels.lattice_pair"] == 2 * SUBSTEPS
    assert counters["kernels.pour"] == 2 * SUBSTEPS
    assert eager["kernels.lattice_pair"] == 2 * SUBSTEPS
    assert step_graph.keys() and len(step_graph.keys()) == 1

    for k, ((_, g, g_copy), (_, w, _)) in enumerate(zip(got_steps,
                                                        want_steps)):
        g_leaves, w_leaves = leaves(g), leaves(w)
        assert [a for a, _ in g_leaves] == [a for a, _ in w_leaves]
        assert any(name.startswith(ERR_PREFIX) for name, _ in g_leaves)
        for (name, a), (_, b), (_, c) in zip(g_leaves, w_leaves, g_copy):
            assert a.dtype == b.dtype and torch.equal(a, b), (k, name)
            # kept past every later replay, unchanged
            assert torch.equal(a, c), (k, name)
    for f in B.Cell._fields:
        assert torch.equal(getattr(got.X, f), getattr(want.X, f)), f
    for a, b in zip(got.old_v, want.old_v):
        assert torch.equal(a, b)
    assert got.n == want.n
    assert torch.equal(got.epi_nbs, want.epi_nbs)
    assert torch.equal(got.mes_nbs, want.mes_nbs)
    assert got_errs.keys() == want_errs.keys()
    for name in got_errs:
        assert torch.equal(got_errs[name], want_errs[name]), name
    step_graph.clear()


@pytest.mark.gpu
def test_step_graph_keeps_two_graphs_and_evicts_the_oldest(cuda):
    state = cap_state(cuda)
    step_graph.clear()
    engines = [LatticeEngine(grid_size=72, capacity=6, z_block=2,
                             extras_cap=1024, extras_block_cap=cap)
               for cap in (64, 72, 80)]
    held = []
    with profiling.tracing():
        for engine in engines:
            for _ in range(3):
                heun_step(engine, FORCE, friction_w_neighbour, "com",
                          state.X, state.old_v, state.n, P.dt, P.r_max, 0,
                          B.precompute)
            held.append([k[0] for k in step_graph.keys()])
        counters = profiling.counters()
    assert held == [engines[:1], engines[:2], engines[1:]]
    assert counters["integrator.graph_capture"] == 3
    assert counters["integrator.graph_replay"] == 3
    # a replay of the second engine makes the third the oldest
    heun_step(engines[1], FORCE, friction_w_neighbour, "com", state.X,
              state.old_v, state.n, P.dt, P.r_max, 0, B.precompute)
    assert [k[0] for k in step_graph.keys()] == [engines[2], engines[1]]
    step_graph.clear()


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


@pytest.mark.parametrize("split", [False, True],
                         ids=["device_count", "two_parts"])
@pytest.mark.parametrize("n", [1, 3, 4097, 19_927, 32_767])
def test_fix_components_same_bits_with_a_device_count(device, n, split):
    """``ops.common.momentum_fix``, the COM drift and the pinned point: a
    count as an int and as a 0-d device tensor (the step's graph) give
    the same bits; so do the state in one part and split in two, the
    second with its stable ids as a tensor."""
    g = torch.Generator(device=device)
    g.manual_seed(n)
    dX = Float3(*(torch.randn(N_PAD, generator=g, device=device) * 10.0 ** e
                  for e in (-3, 0, 3)))
    active = torch.arange(N_PAD, device=device) < n
    h = N_PAD // 3
    n_dev = torch.full((), n, dtype=torch.int64, device=device)
    for mode in ("com", "com_z"):
        want, = momentum_fix([(dX, active, 0)], n, mode, h + 7)
        if split:
            ids = torch.arange(h, N_PAD, device=device)
            parts = [(Float3(*(a[:h] for a in dX)), active[:h], 0),
                     (Float3(*(a[h:] for a in dX)), active[h:], ids)]
            got = Float3(*(torch.cat(a) for a in zip(
                *momentum_fix(parts, n, mode, h + 7))))
        else:
            got, = momentum_fix([(dX, active, 0)], n_dev, mode, h + 7)
        for a, b in zip(got, want):
            assert torch.equal(a, b), mode


@pytest.mark.gpu
def test_graph_replays_under_and_after_the_profiler(cuda):
    """The step captured outside ``torch.profiler``: a replay under the
    profiler shows K1, K2 and the glue as device operations, and replays
    after the profiler stops still give the eager step's bits."""
    state = cap_state(cuda)
    step_graph.clear()
    args = (ENGINE, FORCE, friction_w_neighbour, "com", state.X,
            state.old_v, state.n, P.dt, P.r_max, 0, B.precompute)
    for _ in range(2):
        heun_step(*args)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        heun_step(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("lattice_pair_kernel" in k for k in names) == 2
    assert sum("pour_kernel" in k for k in names) == 2
    assert len(names) > 200
    got = heun_step(*args)
    want = solvers._heun(*args, None, None)
    for (name, a), (_, b) in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b), name
    step_graph.clear()
