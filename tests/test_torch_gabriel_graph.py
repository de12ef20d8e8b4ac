"""The Gabriel engine's lattice pass as a CUDA graph
(``step_graph.gabriel_pass``, ``solvers.gabriel_pass_key``).

``GabrielEngine.pairwise``'s lattice route (the build, then K5's wrapper)
runs eagerly at a key's first call, is captured at its second and replays
from then on; its outputs leave as copies.  On the CPU: which passes
qualify and what their key holds; that a CPU pass never reaches a graph;
the route on a stand-in for the cache, the pass run on its inputs as a
graph holds them (the count a 0-d int64 tensor), gives the eager pass's
bits and times each call in one ``gabriel.build`` and one ``gabriel.pair``
span; the benchmark's reader of ``gabriel.graph_share``.  Marked ``gpu``
(skipped without a CUDA device; on a machine with one, ``python -m pytest
tests/test_torch_gabriel_graph.py --noconftest -q``): 11 steps of the
example with the pass graphs against the same steps with the passes
eager, bit for bit under ``torch.use_deterministic_algorithms``, the
counters and spans, the outputs held past later replays, and a pass
called inside another capture.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from test_torch_segment_graph import (  # noqa: F401 (fixtures)
    _OnCuda, as_in_graph, card_example, cuda, deterministic, example,
    run_steps)
from yalla_tpu_torch import solvers, step_graph
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.models.growth_w_wall import (Params, r_max, relu_force,
                                                  wall_friction)
from yalla_tpu_torch.solvers import GabrielEngine, gabriel_pass_key
from yalla_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
ENGINE = GabrielEngine(grid_size=16, row_cap=64, capacity=16, lattice=True)
ON_CUDA = Float3(*(_OnCuda() for _ in range(3)))


def pass_key(engine=ENGINE, X=ON_CUDA, cube_size=r_max, **kw):
    return gabriel_pass_key(engine, relu_force, wall_friction, X, cube_size,
                            **kw)


def test_gabriel_pass_key_on_cuda():
    key = pass_key()
    assert key is not None
    assert key == pass_key() and hash(key) == hash(pass_key())


def test_gabriel_pass_key_none_on_cpu_tensors():
    assert pass_key(X=Float3.zeros(128, device="cpu")) is None


def test_gabriel_pass_key_none_where_a_value_does_not_hash():
    assert pass_key(engine=dataclasses.replace(
        ENGINE, grid_size=[16, 16, 16])) is None


def test_gabriel_pass_key_none_on_a_window_or_inside_a_capture(
        monkeypatch):
    assert pass_key(i_offset=0, i_size=64) is None
    assert pass_key(i_offset=64) is None
    assert pass_key(cube_size=torch.tensor(1.0)) is None
    monkeypatch.setattr(solvers, "_capturing", lambda: True)
    assert pass_key() is None


def test_gabriel_pass_key_same_for_passes_whose_counts_differ():
    X = Float3.zeros(128, device="cpu")
    old_v = Float3.zeros(128, device="cpu")
    key = pass_key()
    assert step_graph.cache_key(key, (X, old_v, 5)) == \
        step_graph.cache_key(key, (Float3(*(a + 1 for a in X)), old_v, 97))
    assert step_graph.cache_key(key, (X, old_v, 5)) != \
        step_graph.cache_key(key, (Float3.zeros(256, device="cpu"), old_v,
                                   5))


@pytest.mark.parametrize("field, value", [
    ("max_candidates", 64), ("capacity", 8), ("grid_size", 24),
    ("gabriel_coefficient", 0.7)])
def test_gabriel_pass_key_differs_with_an_engine_field(field, value):
    other = dataclasses.replace(ENGINE, **{field: value})
    assert pass_key(engine=other) is not None
    assert pass_key(engine=other) != pass_key()


def test_gabriel_pass_key_differs_with_a_functor_parameter(monkeypatch):
    key = pass_key()
    monkeypatch.setattr(relu_force, "cuda_functor",
                        ("growth_w_wall_relu", Params(r_max=2 * r_max)))
    assert pass_key() is not None and pass_key() != key
    assert gabriel_pass_key(ENGINE, relu_force,
                            solvers.friction_on_background, ON_CUDA,
                            r_max) != key
    assert pass_key(cube_size=2 * r_max) != key


def pass_args(example):
    _, cells, _ = example
    return (relu_force, wall_friction, cells.d_X, cells.d_old_v,
            cells.get_d_n(), r_max)


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
    monkeypatch.setattr(step_graph, "gabriel_pass", refuse)
    args = pass_args(example)
    with profiling.tracing():
        got = ENGINE.pairwise(*args)
        spans = profiling.spans()
        counters = profiling.counters()
    assert spans["gabriel.build"][0] == spans["gabriel.pair"][0] == 1
    assert not any(k.startswith("gabriel.graph") for k in counters)
    from yalla_tpu_torch.ops.gabriel_pallas import gabriel_lattice_pallas
    assert_same_bits(got, gabriel_lattice_pallas(
        *args, grid_size=ENGINE.grid_size, capacity=ENGINE.capacity,
        max_candidates=ENGINE.max_candidates,
        gabriel_coefficient=ENGINE.gabriel_coefficient))


class _Replayer:
    """Stands for a captured pass: runs it on its inputs as a graph holds
    them, and hands out copies of its outputs."""

    def __init__(self, body, X, old_v, n):
        self.body, self.tree = body, as_in_graph((X, old_v, n))

    def replay(self):
        out = self.body(*self.tree)
        outs = []
        spec = step_graph._flatten(out, outs, {}, counts=False)
        return step_graph._build(spec, [a.clone() for a in outs])


def test_lattice_route_on_graph_inputs_gives_the_eager_pass(example,
                                                            monkeypatch):
    """The route's three calls (eager, capture, replay) on a stand-in for
    the cache: the eager pass's bits, one span of each name a call."""
    seen = []

    def gabriel_pass(key, body, X, old_v, n):
        seen.append(key)
        return None if len(seen) == 1 else _Replayer(body, X, old_v, n)
    monkeypatch.setattr(solvers, "gabriel_pass_key",
                        lambda *args: ("key",))
    monkeypatch.setattr(step_graph, "gabriel_pass", gabriel_pass)
    args = pass_args(example)
    with profiling.tracing():
        outs = [ENGINE.pairwise(*args) for _ in range(3)]
        spans = profiling.spans()
    assert seen == [("key",)] * 3
    assert spans["gabriel.build"][0] == spans["gabriel.pair"][0] == 3
    for got in outs[1:]:
        assert_same_bits(got, outs[0])
    assert leaves(outs[1])[0] is not leaves(outs[2])[0]


def test_graph_share_reader_reads_replays_over_passes():
    read = harness.load_module(REPO / "perfbench" / "metrics"
                               / "gabriel.graph_share.py").read
    ctx = SimpleNamespace(trace=None)
    with profiling.tracing():
        for _ in range(4):
            with profiling.span("integrator.heun_step"):
                pass
        profiling.count("gabriel.graph_replay", 6)
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


def held_passes(monkeypatch):
    """A spy on the lattice route: each pass's outputs, with a copy made
    when it returned."""
    held = []
    real = GabrielEngine._lattice_pass

    def spy(engine, *args):
        out = real(engine, *args)
        held.append((out, [a.clone() for a in leaves(out)]))
        return out
    monkeypatch.setattr(GabrielEngine, "_lattice_pass", spy)
    return held


@pytest.mark.gpu
def test_graphed_gabriel_passes_are_the_eager_passes(cuda, deterministic,
                                                     monkeypatch):
    ex, cells = card_example(monkeypatch)
    step_graph.clear()
    start = (cells.d_X, cells.d_old_v, cells.get_d_n())
    with monkeypatch.context() as m:
        held = held_passes(m)
        with profiling.tracing():
            got, _, calls = run_steps(ex, cells, start, 11, monkeypatch,
                                      STEPS)
            counters = profiling.counters()
            spans = profiling.spans()
    with monkeypatch.context() as m:
        m.setattr(solvers, "gabriel_pass_key", lambda *args: None)
        with profiling.tracing():
            want, _, _ = run_steps(ex, cells, start, 11, monkeypatch, STEPS)
            eager = profiling.counters()
    assert not any(k.startswith("gabriel.graph") for k in eager)

    assert calls["pairwise"] == 2 * STEPS
    assert counters["gabriel.graph_capture"] == 1
    assert counters["gabriel.graph_replay"] == 2 * STEPS - 2
    assert counters["kernels.gabriel_pair"] == 2 * STEPS
    assert counters["kernels.pour"] == 2 * STEPS
    assert spans["gabriel.build"][0] == 2 * STEPS
    assert spans["gabriel.pair"][0] == 2 * STEPS
    assert len(step_graph.pass_keys()) == 1
    counts = [s[2] for s in got]
    assert counts == [s[2] for s in want] and len(set(counts)) > 1, counts
    for k, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("x", "old_v", "n", "a", "b", "n_links"), g,
                              w):
            if isinstance(a, int):
                assert a == b, (k, name)
            else:
                for u, v in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
                    assert torch.equal(u, v), (k, name)
    # every pass's outputs, the first passes' among them, kept past every
    # later replay, unchanged
    assert len(held) == 2 * STEPS
    for k, (out, copy) in enumerate(held):
        for j, (a, c) in enumerate(zip(leaves(out), copy)):
            assert torch.equal(a, c), (k, j)
    step_graph.clear()


@pytest.mark.gpu
def test_gabriel_pass_inside_another_capture_runs_eagerly(cuda,
                                                          deterministic,
                                                          monkeypatch):
    _, cells = card_example(monkeypatch)
    step_graph.clear()
    args = (relu_force, wall_friction, cells.d_X, cells.d_old_v,
            cells.get_d_n(), r_max)
    with profiling.tracing():
        want = cells.engine.pairwise(*args)     # the key's first call
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = cells.engine.pairwise(*args)
        graph.replay()
        torch.cuda.synchronize()
        counters = profiling.counters()
    assert not any(k.startswith("gabriel.graph") for k in counters)
    assert step_graph.pass_keys() == []
    assert_same_bits(got, want)
    step_graph.clear()
