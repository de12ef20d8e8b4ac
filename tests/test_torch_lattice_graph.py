"""The lattice engine's pair pass as a CUDA graph
(``step_graph.lattice_pass``, ``solvers.lattice_pass_key``).

``LatticeEngine.pairwise`` with ``graph`` (which ``solvers._heun`` asks
for only where the step's glue runs as segments) runs its pass (the
build, K1's wrapper, the gathers back to stable-id order and the flags)
eagerly at a key's first call, captures it at its second and replays it
from then on; its outputs leave as copies.  On the CPU, on the
intercalation_w_gradient example at a tiny size (``iwg_helpers``): which
passes qualify and what their key holds; that a CPU pass never reaches a
graph; that ``_heun`` asks for the graph between segments and nowhere
else; the route on a stand-in for the cache, the pass run on its inputs
as a graph holds them (the count a 0-d int64 tensor), gives the eager
pass's bits and the eager step's, and times each call in one
``lattice.build`` and one ``lattice.pair`` span; the benchmark's reader
of ``iwg.lattice_graph_share``.  Marked ``gpu`` (skipped without a CUDA
device; on a machine with one, ``python -m pytest
tests/test_torch_lattice_graph.py --noconftest -q``): 11 steps of the
example with the pass graphs against the same steps with the passes
eager, bit for bit under ``torch.use_deterministic_algorithms``, the
counters and spans, the outputs held past later replays; a pass called
inside another capture; and the flagship's whole-step graph, which holds
no pass graph.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from iwg_helpers import small_example
from perfbench import harness
from test_torch_segment_graph import (  # noqa: F401 (fixtures)
    _OnCuda, as_in_graph, cuda, deterministic, graph_view)
from yalla_tpu_torch import solvers, step_graph
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.links import link_forces
from yalla_tpu_torch.ops.common import augment, friction_w_neighbour
from yalla_tpu_torch.polarity import polarity_precompute
from yalla_tpu_torch.solvers import (GabrielEngine, LatticeEngine,
                                     lattice_pass_key)
from yalla_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
EX = "yalla_tpu_torch.examples.intercalation_w_gradient"
ENGINE = LatticeEngine(grid_size=32, capacity=16, z_block=2)


def example_module():
    import importlib
    return importlib.import_module(EX)


def on_cuda(ex):
    return ex.Cell(*(_OnCuda() for _ in ex.Cell._fields))


def pass_key(engine=ENGINE, X=None, cube_size=1.0, force=None,
             friction=friction_w_neighbour, **kw):
    ex = example_module()
    return lattice_pass_key(engine, ex.force if force is None else force,
                            friction, on_cuda(ex) if X is None else X,
                            cube_size, **kw)


def test_lattice_pass_key_holds_what_the_capture_bakes_in():
    ex = example_module()
    key = pass_key()
    assert key == (ENGINE, ex.force, friction_w_neighbour,
                   ("intercalation_w_gradient", ex.r_max), 1.0, ex.Cell)
    assert key == pass_key() and hash(key) == hash(pass_key())


def test_lattice_pass_key_none_on_cpu_tensors():
    ex = example_module()
    X = ex.Cell(*(torch.zeros(128) for _ in ex.Cell._fields))
    assert pass_key(X=X) is None


def test_lattice_pass_key_none_on_a_window_or_inside_a_capture(
        monkeypatch):
    assert pass_key(i_offset=0, i_size=64) is None
    assert pass_key(i_offset=64) is None
    assert pass_key(cube_size=torch.tensor(1.0)) is None
    monkeypatch.setattr(solvers, "_capturing", lambda: True)
    assert pass_key() is None


def test_lattice_pass_key_none_for_another_engine():
    @dataclasses.dataclass(frozen=True)
    class Sub(LatticeEngine):
        pass
    assert pass_key(engine=Sub(grid_size=32, capacity=16)) is None
    assert pass_key(engine=GabrielEngine(grid_size=32)) is None


def test_lattice_pass_key_none_where_a_value_does_not_hash():
    assert pass_key(engine=dataclasses.replace(
        ENGINE, grid_size=[32, 32, 32])) is None


def test_lattice_pass_key_same_for_passes_whose_counts_differ():
    X = Float3.zeros(128, device="cpu")
    old_v = Float3.zeros(128, device="cpu")
    key = pass_key()
    assert step_graph.cache_key(key, (X, old_v, 5)) == \
        step_graph.cache_key(key, (Float3(*(a + 1 for a in X)), old_v, 97))
    assert step_graph.cache_key(key, (X, old_v, 5)) != \
        step_graph.cache_key(key, (Float3.zeros(256, device="cpu"), old_v,
                                   5))


@pytest.mark.parametrize("field, value", [
    ("grid_size", 40), ("capacity", 8), ("z_block", 4), ("extras_cap", 64),
    ("extras_block_cap", 32), ("x_split", 2), ("pallas", False)])
def test_lattice_pass_key_differs_with_an_engine_field(field, value):
    other = dataclasses.replace(ENGINE, **{field: value})
    assert getattr(other, field) == value
    assert pass_key(engine=other) is not None
    assert pass_key(engine=other) != pass_key()


def test_lattice_pass_key_differs_with_a_functor_parameter(monkeypatch):
    ex = example_module()
    key = pass_key()
    monkeypatch.setattr(ex, "r_max", 2 * ex.r_max)
    assert pass_key() is not None and pass_key() != key
    monkeypatch.undo()
    assert pass_key() == key
    assert pass_key(friction=solvers.friction_on_background) != key
    assert pass_key(cube_size=2.0) != key


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """The tiny example on the CPU after one step: (module, cells, run
    state)."""
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as m:
        ex, _, _ = small_example(m, tmp_path_factory.mktemp("iwg"))
        cells = ex.setup("cpu", ex.IC_PATH)
        state = ex.start(cells, seed=3)
        ex.step(cells, state)
        yield ex, cells, state


def pass_args(example):
    ex, cells, _ = example
    n = cells.get_d_n()
    return (ex.force, friction_w_neighbour,
            augment(cells.d_X, n, polarity_precompute), cells.d_old_v, n,
            ex.r_max)


def leaves(out):
    got = []
    step_graph._flatten(out, got, {})
    return got


def assert_same_bits(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w) > 4
    for k, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_cpu_pairwise_never_reaches_a_graph(example, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU pass reached a CUDA graph")
    monkeypatch.setattr(step_graph, "lattice_pass", refuse)
    _, cells, _ = example
    args = pass_args(example)
    with profiling.tracing():
        got = cells.engine.pairwise(*args, graph=True)
        spans = profiling.spans()
        counters = profiling.counters()
    assert spans["lattice.build"][0] == spans["lattice.pair"][0] == 1
    assert not any(k.startswith("lattice.graph") for k in counters)
    assert_same_bits(got, cells.engine.pairwise(*args))


class _Replayer:
    """Stands for a captured pass: runs it on its inputs as a graph holds
    them, and hands out its own output tensors, the same at every
    replay."""

    def __init__(self, body):
        self.body, self.tree, self.outs = body, None, None

    def load(self, X, old_v, n):
        self.tree = as_in_graph((X, old_v, n))
        return self

    def replay(self):
        out = self.body(*self.tree)
        outs = []
        spec = step_graph._flatten(out, outs, {}, counts=False)
        if self.outs is None:
            self.outs = [torch.empty_like(a) for a in outs]
        for a, b in zip(self.outs, outs):
            a.copy_(b)
        return step_graph._build(spec, self.outs)


def stand_in_cache(monkeypatch):
    """The route's key and cache stood in for on the CPU: None at the
    first call, one :class:`_Replayer` after; returns the keys asked
    for."""
    seen, graph = [], []

    def lattice_pass(key, body, X, old_v, n):
        seen.append(key)
        if len(seen) == 1:
            return None
        if not graph:
            graph.append(_Replayer(body))
        return graph[0].load(X, old_v, n)
    monkeypatch.setattr(solvers, "lattice_pass_key", lambda *args: ("key",))
    monkeypatch.setattr(step_graph, "lattice_pass", lattice_pass)
    return seen


def test_lattice_route_on_graph_inputs_gives_the_eager_pass(example,
                                                            monkeypatch):
    """The route's three calls (eager, capture, replay) on a stand-in for
    the cache: the eager pass's bits, one span of each name a call."""
    _, cells, _ = example
    args = pass_args(example)
    want = cells.engine.pairwise(*args)
    seen = stand_in_cache(monkeypatch)
    with profiling.tracing():
        outs = [cells.engine.pairwise(*args, graph=True) for _ in range(3)]
        spans = profiling.spans()
    assert seen == [("key",)] * 3
    assert spans["lattice.build"][0] == spans["lattice.pair"][0] == 3
    for got in outs:
        assert_same_bits(got, want)
    # a replay hands out the graph's own tensors
    assert leaves(outs[1])[0] is leaves(outs[2])[0]
    assert leaves(outs[0])[0] is not leaves(outs[1])[0]


def test_segment_run_eagerly_takes_copies_of_a_pass_graphs_outputs():
    """A segment's first, eager call takes copies of the tensors a lattice
    pass's graph holds as outputs (its capture and replays copy them into
    their buffers), and every other input as it is."""
    owned, other = torch.arange(4.0), torch.ones(4)
    seen = []

    def body(tree):
        seen.append(tree)
        return tree[0] + tree[1]
    step_graph.clear()
    step_graph._lattice_passes.graphs["stand-in"] = SimpleNamespace(
        outs=[owned])
    try:
        got = step_graph.segment(("eager", 1), body, (owned, other, 3),
                                 False)
    finally:
        step_graph.clear()
    a, b, n = seen[0]
    assert a is not owned and torch.equal(a, owned)
    assert b is other and n == 3
    assert torch.equal(got, owned + other)
    # with no pass graph held, nothing is copied
    step_graph.segment(("eager", 2), body, (owned, other, 3), False)
    assert seen[1][0] is owned
    step_graph.clear()


def step_args(example):
    ex, cells, state = example
    gen = link_forces(state.links)
    return (cells.engine, ex.force, friction_w_neighbour, cells._fix_mode,
            cells.d_X, cells.d_old_v, cells.get_d_n(), ex.dt, ex.r_max,
            cells._fix_point, polarity_precompute, gen, gen.args)


def test_heun_asks_for_the_pass_graph_only_between_segments(example,
                                                            monkeypatch):
    asked = []
    real = LatticeEngine.pairwise

    def spy(engine, *args, **kw):
        asked.append(kw.get("graph", False))
        return real(engine, *args, **kw)
    monkeypatch.setattr(LatticeEngine, "pairwise", spy)
    args = step_args(example)
    solvers._heun(*args)
    solvers.heun_step(*args)
    assert asked == [False] * 4
    solvers._heun(*args, graph_view)
    assert asked[4:] == [True, True]


def test_segmented_step_with_pass_graphs_gives_the_eager_step(example,
                                                              monkeypatch):
    """Two steps with their glue as segments and their passes on the
    stand-in cache (the first pass eager, the other three replays) give
    the eager step's bits."""
    args = step_args(example)
    want = solvers._heun(*args)
    seen = stand_in_cache(monkeypatch)
    for _ in range(2):
        got = solvers._heun(*args, graph_view)
        assert_same_bits(got, want)
    assert len(seen) == 4


def test_lattice_graph_share_reader_reads_replays_over_passes():
    read = harness.load_module(REPO / "perfbench" / "metrics"
                               / "iwg.lattice_graph_share.py").read
    ctx = SimpleNamespace(trace=None)
    with profiling.tracing():
        for _ in range(4):
            with profiling.span("integrator.heun_step"):
                pass
        profiling.count("lattice.graph_replay", 6)
        profiling.count("gabriel.graph_replay", 2)
        assert read(ctx) == pytest.approx(0.75)
    # a program without the counter (the parent's) reads nothing
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            pass
        assert read(ctx) is None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

STEPS = 11


def card_example(monkeypatch, tmp_path):
    """The tiny example on the card: (module, cells)."""
    ex, _, _ = small_example(monkeypatch, tmp_path)
    return ex, ex.setup("cuda", ex.IC_PATH)


def run_steps(ex, cells, held, seed, steps=STEPS):
    """``steps`` example steps from ``held``: the state after each and
    each step's neighbour counts."""
    cells.d_X, cells.d_old_v, cells.d_n = held
    state = ex.start(cells, seed=seed)
    after = []
    for _ in range(steps):
        aux = ex.step(cells, state)
        after.append((cells.d_X, cells.d_old_v, cells.get_d_n(),
                      state.links.d_a, state.links.d_b,
                      aux["epi_nbs"], aux["mes_nbs"]))
    torch.cuda.synchronize()
    return after


def spied(monkeypatch):
    """Spies on the lattice engine's pass and on the Heun step: the
    passes' outputs, and each step's outputs with a copy made when it
    returned."""
    passes, heun = [], []
    real_pass, real_heun = LatticeEngine.pairwise, solvers.heun_step

    def spy_pass(engine, *args, **kw):
        out = real_pass(engine, *args, **kw)
        passes.append(out)
        return out

    def spy_heun(*args, **kw):
        out = real_heun(*args, **kw)
        heun.append((out, [a.clone() for a in leaves(out)]))
        return out
    monkeypatch.setattr(LatticeEngine, "pairwise", spy_pass)
    monkeypatch.setattr(solvers, "heun_step", spy_heun)
    return passes, heun


def assert_same_states(got, want):
    names = ("x", "old_v", "n", "a", "b", "epi_nbs", "mes_nbs")
    for k, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(names, g, w):
            if isinstance(a, int):
                assert a == b, (k, name)
            else:
                for u, v in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                    assert torch.equal(u, v), (k, name)


@pytest.mark.gpu
def test_graphed_lattice_passes_are_the_eager_passes(cuda, deterministic,
                                                     monkeypatch, tmp_path):
    ex, cells = card_example(monkeypatch, tmp_path)
    step_graph.clear()
    start = (cells.d_X, cells.d_old_v, cells.get_d_n())
    with monkeypatch.context() as m:
        passes, heun = spied(m)
        with profiling.tracing():
            got = run_steps(ex, cells, start, 11)
            counters = profiling.counters()
            spans = profiling.spans()
    with monkeypatch.context() as m:
        m.setattr(solvers, "lattice_pass_key", lambda *args: None)
        _, want_heun = spied(m)
        with profiling.tracing():
            want = run_steps(ex, cells, start, 11)
            eager = profiling.counters()
    assert not any(k.startswith("lattice.graph") for k in eager)
    assert eager["integrator.segment_replay"] == 2 * STEPS

    assert counters["integrator.segment_replay"] == 2 * (STEPS - 2)
    assert counters["lattice.graph_capture"] == 1
    assert counters["lattice.graph_replay"] == 2 * STEPS - 2
    assert counters["kernels.lattice_pair"] == 2 * STEPS
    assert counters["kernels.pour"] == 2 * STEPS
    assert spans["lattice.build"][0] == 2 * STEPS
    assert spans["lattice.pair"][0] == 2 * STEPS
    assert len(step_graph.lattice_pass_keys()) == 1
    counts = [s[2] for s in got]
    assert counts == [s[2] for s in want] and len(set(counts)) > 1, counts
    assert_same_states(got, want)
    # from the capture on, every pass hands out the graph's own tensors
    assert len(passes) == 2 * STEPS
    owned = leaves(passes[1])
    assert all(a is b for out in passes[2:] for a, b in zip(leaves(out),
                                                            owned))
    assert not any(a is b for a, b in zip(leaves(passes[0]), owned))
    # the segments took them in before the next replay: every step's
    # outputs are the eager step's bits, and kept past every later replay,
    # unchanged
    assert len(heun) == len(want_heun) == STEPS
    for k, ((g, g_copy), (w, _)) in enumerate(zip(heun, want_heun)):
        assert_same_bits(g, w)
        for j, (a, c) in enumerate(zip(leaves(g), g_copy)):
            assert torch.equal(a, c), (k, j)
    step_graph.clear()


@pytest.mark.gpu
def test_lattice_pass_inside_another_capture_runs_eagerly(
        cuda, deterministic, monkeypatch, tmp_path):
    ex, cells = card_example(monkeypatch, tmp_path)
    step_graph.clear()
    n = cells.get_d_n()
    Xa = augment(cells.d_X, n, polarity_precompute)
    nc = torch.full((), n, dtype=torch.int64, device=cuda)
    args = (ex.force, friction_w_neighbour, Xa, cells.d_old_v)
    with profiling.tracing():
        # the key's first call
        want = cells.engine.pairwise(*args, nc, ex.r_max, graph=True)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = cells.engine.pairwise(*args, nc, ex.r_max, graph=True)
        graph.replay()
        torch.cuda.synchronize()
        counters = profiling.counters()
    assert not any(k.startswith("lattice.graph") for k in counters)
    assert step_graph.lattice_pass_keys() == []
    assert_same_bits(got, want)
    step_graph.clear()


@pytest.mark.gpu
def test_whole_step_graph_holds_no_lattice_pass_graph(cuda):
    """Three flagship steps on the kernel lattice engine: the whole step's
    graph runs its passes eagerly at its warm-up and inside its capture,
    then replays them; no pass graph is made or kept."""
    from test_torch_step_graph import ENGINE as B_ENGINE
    from test_torch_step_graph import FORCE, P, B, cap_state
    state = cap_state(cuda)
    step_graph.clear()
    with profiling.tracing():
        for _ in range(3):
            solvers.heun_step(B_ENGINE, FORCE, friction_w_neighbour, "com",
                              state.X, state.old_v, state.n, P.dt, P.r_max,
                              0, B.precompute)
        counters = profiling.counters()
    assert counters["integrator.graph_capture"] == 1
    assert counters["integrator.graph_replay"] == 1
    assert not any(k.startswith("lattice.graph") for k in counters)
    assert step_graph.lattice_pass_keys() == []
    assert not step_graph._lattice_passes.seen
    step_graph.clear()
