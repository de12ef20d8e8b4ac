"""The grid engine's gather pass as a CUDA graph (``step_graph.grid_pass``,
``solvers.grid_pass_key``).

``GridEngine.pairwise`` with ``graph`` (which ``solvers._heun`` asks for
only where the step's glue runs as segments) runs its pass (the build's
sort and scatter tables, the candidate gathers, the Python pair force and
the sums) eagerly at a key's first call, captures it at its second and
replays it from then on, its outputs the graph's own.  On the CPU, on the
tutorial example (model_features_sequential_addition) at a tiny size
(``mfsa_helpers``): which passes qualify and what their key holds; that a
CPU pass never reaches a graph; that ``_heun`` asks for the graph between
segments and nowhere else; the route on a stand-in for the cache, the
pass run on its inputs as a graph holds them (the count a 0-d int64
tensor), gives the eager pass's bits and the eager step's, and times each
call in one ``grid.build`` and one ``grid.pair`` span; an eagerly run
segment takes copies of a pass graph's outputs; the benchmark's reader of
``mfsa.grid_graph_share``.  Marked ``gpu`` (skipped without a CUDA
device; on a machine with one, ``python -m pytest
tests/test_torch_grid_graph.py --noconftest -q``): 11 steps of the first
and of the fifth part with the pass graphs against the same steps with
the passes eager, bit for bit under ``torch.use_deterministic_algorithms``,
the counters and spans, the outputs held past later replays; and the five
parts, which hold at most two pass graphs.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from mfsa_helpers import small_example
from perfbench import harness
from test_torch_segment_graph import (  # noqa: F401 (fixtures)
    _OnCuda, as_in_graph, cuda, deterministic, graph_view)
from yalla_tpu_torch import solvers, step_graph
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.links import link_forces
from yalla_tpu_torch.ops.common import (augment, friction_on_background,
                                        friction_w_neighbour)
from yalla_tpu_torch.polarity import polarity_precompute
from yalla_tpu_torch.solvers import (GabrielEngine, GridEngine,
                                     LatticeEngine, grid_pass_key)
from yalla_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
EX = "yalla_tpu_torch.examples.model_features_sequential_addition"
ENGINE = GridEngine(grid_size=50, row_cap=48)
FRICTIONS = {"background": friction_on_background,
             "neighbour": friction_w_neighbour}


def example_module():
    import importlib
    return importlib.import_module(EX)


def on_cuda(ex):
    return ex.Cell(*(_OnCuda() for _ in ex.Cell._fields))


def pass_key(engine=ENGINE, X=None, cube_size=1.0, force=None,
             friction=friction_w_neighbour, **kw):
    ex = example_module()
    return grid_pass_key(engine, ex.force if force is None else force,
                         friction, on_cuda(ex) if X is None else X,
                         cube_size, **kw)


def test_grid_pass_key_holds_what_the_capture_bakes_in():
    ex = example_module()
    key = pass_key()
    assert key == (ENGINE, ex.force, friction_w_neighbour, None, 1.0,
                   ex.Cell)
    assert key == pass_key() and hash(key) == hash(pass_key())


@pytest.mark.parametrize("field, value", [
    ("grid_size", 40), ("row_cap", 32), ("i_block", 1024)])
def test_grid_pass_key_differs_with_an_engine_field(field, value):
    other = dataclasses.replace(ENGINE, **{field: value})
    assert getattr(other, field) == value
    assert pass_key(engine=other) is not None
    assert pass_key(engine=other) != pass_key()


def test_grid_pass_key_differs_with_the_friction_force_and_cube():
    key = pass_key()
    assert pass_key(friction=friction_on_background) not in (None, key)
    assert pass_key(cube_size=2.0) not in (None, key)

    def other_force(Xi, r, dist, i, j):
        return r
    assert pass_key(force=other_force) not in (None, key)


def test_grid_pass_key_same_for_passes_whose_counts_differ():
    X = Float3.zeros(128, device="cpu")
    old_v = Float3.zeros(128, device="cpu")
    key = pass_key()
    assert step_graph.cache_key(key, (X, old_v, 5)) == \
        step_graph.cache_key(key, (Float3(*(a + 1 for a in X)), old_v, 97))
    assert step_graph.cache_key(key, (X, old_v, 5)) != \
        step_graph.cache_key(key, (Float3.zeros(256, device="cpu"), old_v,
                                   5))


def test_grid_pass_key_none_on_cpu_tensors():
    ex = example_module()
    X = ex.Cell(*(torch.zeros(128) for _ in ex.Cell._fields))
    assert pass_key(X=X) is None


def test_grid_pass_key_none_on_a_window_or_inside_a_capture(monkeypatch):
    assert pass_key(i_offset=0, i_size=64) is None
    assert pass_key(i_offset=64) is None
    assert pass_key(cube_size=torch.tensor(1.0)) is None
    monkeypatch.setattr(solvers, "_capturing", lambda: True)
    assert pass_key() is None


def test_grid_pass_key_none_for_another_engine():
    @dataclasses.dataclass(frozen=True)
    class Sub(GridEngine):
        pass
    assert pass_key(engine=Sub(grid_size=50, row_cap=48)) is None
    assert pass_key(engine=GabrielEngine(grid_size=50)) is None
    assert pass_key(engine=LatticeEngine(grid_size=32)) is None


def test_grid_pass_key_none_where_a_value_does_not_hash():
    assert pass_key(engine=dataclasses.replace(
        ENGINE, grid_size=[50])) is None


@pytest.fixture(scope="module")
def example():
    """The tiny example on the CPU after one step: (module, cells, run
    state)."""
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as m:
        ex = small_example(m)
        cells = ex.setup("cpu", 5)
        state = ex.start(cells, seed=5)
        ex.step(cells, state)
        yield ex, cells, state


def pass_args(example, friction=friction_w_neighbour):
    ex, cells, _ = example
    n = cells.get_d_n()
    return (ex.force, friction,
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
    monkeypatch.setattr(step_graph, "grid_pass", refuse)
    _, cells, _ = example
    args = pass_args(example)
    with profiling.tracing():
        got = cells.engine.pairwise(*args, graph=True)
        spans = profiling.spans()
        counters = profiling.counters()
    assert spans["grid.build"][0] == spans["grid.pair"][0] == 1
    assert not any(k.startswith("grid.graph") for k in counters)
    assert_same_bits(got, cells.engine.pairwise(*args))


def test_grid_spans_fire_once_a_call_on_a_window_too(example):
    """The sharded cells path's window runs the pass eagerly, in one span
    of each name a call, and gives the whole pass's rows."""
    _, cells, _ = example
    args = pass_args(example)
    whole = cells.engine.pairwise(*args)
    with profiling.tracing():
        got = cells.engine.pairwise(*args, 64, 128, graph=True)
        spans = profiling.spans()
    assert spans["grid.build"][0] == spans["grid.pair"][0] == 1
    for a, b in zip(leaves(got), leaves(whole)):
        assert torch.equal(a, b[64:192])


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

    def grid_pass(key, body, X, old_v, n):
        seen.append(key)
        if len(seen) == 1:
            return None
        if not graph:
            graph.append(_Replayer(body))
        return graph[0].load(X, old_v, n)
    monkeypatch.setattr(solvers, "grid_pass_key", lambda *args: ("key",))
    monkeypatch.setattr(step_graph, "grid_pass", grid_pass)
    return seen


@pytest.mark.parametrize("friction", FRICTIONS)
def test_grid_route_on_graph_inputs_gives_the_eager_pass(example,
                                                         monkeypatch,
                                                         friction):
    """The route's three calls (eager, capture, replay) on a stand-in for
    the cache: the eager pass's bits, one span of each name a call."""
    _, cells, _ = example
    args = pass_args(example, FRICTIONS[friction])
    want = cells.engine.pairwise(*args)
    seen = stand_in_cache(monkeypatch)
    with profiling.tracing():
        outs = [cells.engine.pairwise(*args, graph=True) for _ in range(3)]
        spans = profiling.spans()
    assert seen == [("key",)] * 3
    assert spans["grid.build"][0] == spans["grid.pair"][0] == 3
    for got in outs:
        assert_same_bits(got, want)
    # a replay hands out the graph's own tensors
    assert leaves(outs[1])[0] is leaves(outs[2])[0]
    assert leaves(outs[0])[0] is not leaves(outs[1])[0]


def test_segment_run_eagerly_takes_copies_of_a_grid_pass_graphs_outputs():
    """A segment's first, eager call takes copies of the tensors a grid
    pass's graph holds as outputs (its capture and replays copy them into
    their buffers), and every other input as it is."""
    owned, other = torch.arange(4.0), torch.ones(4)
    seen = []

    def body(tree):
        seen.append(tree)
        return tree[0] + tree[1]
    step_graph.clear()
    step_graph._grid_passes.graphs["stand-in"] = SimpleNamespace(
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


def step_args(example, part):
    """A Heun step's arguments as the first part (the background's
    friction) or the fifth (the neighbours', the protrusions' pull)
    calls it."""
    ex, cells, state = example
    if part == 0:
        friction, gen = friction_on_background, None
    else:
        friction, gen = friction_w_neighbour, link_forces(state.links)
    return (cells.engine, ex.force, friction, cells._fix_mode, cells.d_X,
            cells.d_old_v, cells.get_d_n(), ex.dt, ex.r_max,
            cells._fix_point, polarity_precompute, gen,
            None if gen is None else gen.args)


def test_heun_asks_for_the_pass_graph_only_between_segments(example,
                                                            monkeypatch):
    asked = []
    real = GridEngine.pairwise

    def spy(engine, *args, **kw):
        asked.append(kw.get("graph", False))
        return real(engine, *args, **kw)
    monkeypatch.setattr(GridEngine, "pairwise", spy)
    args = step_args(example, 4)
    solvers._heun(*args)
    solvers.heun_step(*args)
    assert asked == [False] * 4
    solvers._heun(*args, graph_view)
    assert asked[4:] == [True, True]


@pytest.mark.parametrize("part", [0, 4])
def test_segmented_step_with_pass_graphs_gives_the_eager_step(example,
                                                              monkeypatch,
                                                              part):
    """Two steps with their glue as segments and their passes on the
    stand-in cache (the first pass eager, the other three replays) give
    the eager step's bits."""
    args = step_args(example, part)
    want = solvers._heun(*args)
    seen = stand_in_cache(monkeypatch)
    for _ in range(2):
        got = solvers._heun(*args, graph_view)
        assert_same_bits(got, want)
    assert len(seen) == 4


def test_grid_graph_share_reader_reads_replays_over_passes():
    read = harness.load_module(REPO / "perfbench" / "metrics"
                               / "mfsa.grid_graph_share.py").read
    ctx = SimpleNamespace(trace=None)
    with profiling.tracing():
        for _ in range(4):
            with profiling.span("integrator.heun_step"):
                pass
        profiling.count("grid.graph_replay", 6)
        profiling.count("lattice.graph_replay", 2)
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


def card_example(monkeypatch, part_steps=STEPS):
    """The tiny example on the card, ``part_steps`` + 1 steps a part:
    (module, cells)."""
    ex = small_example(monkeypatch, part_steps)
    return ex, ex.setup("cuda", 5)


def run_steps(ex, cells, held, seed, part, steps=STEPS):
    """``steps`` example steps of part ``part`` from ``held``: the state
    after each and each step's neighbour counts."""
    cells.d_X, cells.d_old_v, cells.d_n = held
    state = ex.start(cells, seed=seed)
    state.t = part * (state.n_steps + 1)
    if part == 4:
        state.links.set_d_n(ex.n_0 * ex.prots_per_cell)
    after = []
    real = cells.take_step

    def take_step(*args, **kw):
        aux = real(*args, **kw)
        after.append((cells.d_X, cells.d_old_v, cells.get_d_n(),
                      state.links.d_a, state.links.d_b,
                      aux["epi_nbs"], aux["mes_nbs"]))
        return aux
    cells.take_step = take_step
    try:
        for _ in range(steps):
            ex.step(cells, state)
    finally:
        del cells.take_step
    torch.cuda.synchronize()
    return after


def spied(monkeypatch):
    """Spies on the grid engine's pass and on the Heun step: the passes'
    outputs, and each step's outputs with a copy made when it
    returned."""
    passes, heun = [], []
    real_pass, real_heun = GridEngine.pairwise, solvers.heun_step

    def spy_pass(engine, *args, **kw):
        out = real_pass(engine, *args, **kw)
        passes.append(out)
        return out

    def spy_heun(*args, **kw):
        out = real_heun(*args, **kw)
        heun.append((out, [a.clone() for a in leaves(out)]))
        return out
    monkeypatch.setattr(GridEngine, "pairwise", spy_pass)
    monkeypatch.setattr(solvers, "heun_step", spy_heun)
    return passes, heun


def assert_same_states(got, want):
    names = ("x", "old_v", "n", "a", "b", "epi_nbs", "mes_nbs")
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(names, g, w):
            if isinstance(a, int):
                assert a == b, (k, name)
            else:
                for u, v in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                    assert torch.equal(u, v), (k, name)


@pytest.mark.gpu
@pytest.mark.parametrize("part", [0, 4])
def test_graphed_grid_passes_are_the_eager_passes(cuda, deterministic,
                                                  monkeypatch, part):
    ex, cells = card_example(monkeypatch)
    step_graph.clear()
    start = (cells.d_X, cells.d_old_v, cells.get_d_n())
    with monkeypatch.context() as m:
        passes, heun = spied(m)
        with profiling.tracing():
            got = run_steps(ex, cells, start, 11, part)
            counters = profiling.counters()
            spans = profiling.spans()
    with monkeypatch.context() as m:
        m.setattr(solvers, "grid_pass_key", lambda *args: None)
        _, want_heun = spied(m)
        with profiling.tracing():
            want = run_steps(ex, cells, start, 11, part)
            eager = profiling.counters()
    assert not any(k.startswith("grid.graph") for k in eager)
    assert eager["integrator.segment_replay"] == 2 * STEPS

    assert counters["integrator.segment_replay"] == 2 * (STEPS - 2)
    assert counters["grid.graph_capture"] == 1
    assert counters["grid.graph_replay"] == 2 * STEPS - 2
    assert spans["grid.build"][0] == 2 * STEPS
    assert spans["grid.pair"][0] == 2 * STEPS
    assert len(step_graph.grid_pass_keys()) == 1
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
def test_five_parts_hold_at_most_two_grid_pass_graphs(cuda, deterministic,
                                                      monkeypatch):
    """The five parts of the tiny run (four steps each, the growth of the
    fourth changing the count) with the pass graphs and with the passes
    eager: the same bits after every step; one graph for the background's
    friction and one for the neighbours', each captured once."""
    ex, cells = card_example(monkeypatch, part_steps=3)
    step_graph.clear()
    start = (cells.d_X, cells.d_old_v, cells.get_d_n())
    steps = 5 * (ex.part_steps + 1)
    with profiling.tracing():
        got = run_steps(ex, cells, start, 7, 0, steps)
        counters = profiling.counters()
    keys = step_graph.grid_pass_keys()
    with monkeypatch.context() as m:
        m.setattr(solvers, "grid_pass_key", lambda *args: None)
        want = run_steps(ex, cells, start, 7, 0, steps)
    assert len(keys) == 2 <= step_graph.MAX_GRID_PASSES
    assert {k[2] for k in keys} == set(FRICTIONS.values())
    assert counters["grid.graph_capture"] == 2
    # each key's first pass runs eagerly and its second captures
    assert counters["grid.graph_replay"] == 2 * steps - 4
    counts = [s[2] for s in got]
    assert counts == [s[2] for s in want] and len(set(counts)) > 1, counts
    assert_same_states(got, want)
    step_graph.clear()


@pytest.mark.gpu
def test_grid_pass_inside_another_capture_runs_eagerly(cuda, deterministic,
                                                       monkeypatch):
    ex, cells = card_example(monkeypatch)
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
    assert not any(k.startswith("grid.graph") for k in counters)
    assert step_graph.grid_pass_keys() == []
    assert_same_bits(got, want)
    step_graph.clear()
