"""The eager Heun step's glue as CUDA graphs (``step_graph.segment``).

``solvers._heun`` calls its two pair passes itself and hands the glue
after each to a segment: ``first`` (the first pass's outputs to X1) and
``second`` (the second pass's outputs to the step's result).  On the CPU:
the segments, run on their inputs as a graph holds them (each count a 0-d
int64 tensor, each tensor a copy), give the eager step's bits on every
engine and generic force of the growth_w_wall example at a tiny size
(``gww_helpers``); the link and wall forces give the same bits with their
counts as 0-d tensors, and the same bits as the formula that added every
dead link row into row 0; which steps qualify (``solvers.segment_key``) and
what their key holds; that a CPU step never reaches a graph.  Marked
``gpu`` (skipped without a CUDA device; on a machine with one, ``python
-m pytest tests/test_torch_segment_graph.py --noconftest -q``): 20 steps
of the example graphed against eager, bit for bit under
``torch.use_deterministic_algorithms``, the counters, the outputs kept
past later replays, the cache's bound and the calls the benchmark's spy
watches.
"""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gww_helpers import small_example
from perfbench import harness
from yalla_tpu_torch import links as links_mod
from yalla_tpu_torch import solvers, step_graph
from yalla_tpu_torch.dtypes import Float3, pt_zeros_like
from yalla_tpu_torch.links import Links, link_forces, link_wall_forces, \
    linear_force, wall_forces
from yalla_tpu_torch.models.growth_w_wall import (WALL, dt, r_max,
                                                  relu_force, wall_friction)
from yalla_tpu_torch.ops.common import ERR_PREFIX
from yalla_tpu_torch.solvers import (GabrielEngine, GenericForce, GridEngine,
                                     LatticeEngine, TileEngine, segment_key)
from yalla_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
GRID = 16
ENGINES = {
    "tile": TileEngine(),
    "grid": GridEngine(grid_size=GRID, row_cap=64),
    "gabriel_lattice": GabrielEngine(grid_size=GRID, row_cap=64,
                                     capacity=16, lattice=True),
    "gabriel_windowed": GabrielEngine(grid_size=GRID, row_cap=64,
                                      lattice=False),
    "lattice": LatticeEngine(grid_size=GRID, capacity=16)}
FORCES = ("none", "wall", "link_wall")


@pytest.fixture(scope="module")
def example():
    """The tiny example relaxed on the CPU, one rewiring made: (module,
    cells, run state)."""
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as m:
        ex = small_example(m)
        cells = ex.setup("cpu", 3)
        state = ex.start(cells, seed=3)
        ex.step(cells, state)
        yield ex, cells, state


def force(name, links):
    return {"none": None, "wall": wall_forces(WALL),
            "link_wall": link_wall_forces(links, WALL)}[name]


def as_in_graph(tree):
    """``tree`` as a segment's graph holds it: each tensor a copy, each
    int a 0-d int64 tensor."""
    leaves = []
    spec = step_graph._flatten(tree, leaves, {})
    return step_graph._build(spec, [
        a.clone() if isinstance(a, torch.Tensor)
        else torch.full((), a, dtype=torch.int64) for a in leaves])


def graph_view(tag, body, tree, copy):
    return body(as_in_graph(tree))


def leaves(out):
    X, old_v, aux = out
    return list(zip("xyz", X)) + list(zip(("vx", "vy", "vz"), old_v)) \
        + sorted(aux.items())


def assert_same_bits(got, want):
    g, w = leaves(got), leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    assert any(k.startswith(ERR_PREFIX) for k, _ in g)
    for (k, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("gen_name", FORCES)
@pytest.mark.parametrize("engine_name", list(ENGINES))
def test_segments_on_graph_inputs_give_the_eager_step(example, engine_name,
                                                      gen_name):
    ex, cells, state = example
    gen = force(gen_name, state.links)
    args = (ENGINES[engine_name], relu_force, wall_friction, cells._fix_mode,
            cells.d_X, cells.d_old_v, cells.get_d_n(), dt, r_max,
            cells._fix_point, None, gen, None if gen is None else gen.args)
    want = solvers._heun(*args)
    got = solvers._heun(*args, graph_view)
    assert_same_bits(got, want)


@pytest.mark.parametrize("gen_name", ["link", "wall", "link_wall"])
def test_link_and_wall_forces_same_bits_with_device_counts(example,
                                                           gen_name):
    _, cells, state = example
    links = state.links
    assert 0 < links.get_d_n() < links.n_max
    gen = {"link": link_forces(links), "wall": wall_forces(WALL),
           "link_wall": link_wall_forces(links, WALL)}[gen_name]
    n = cells.get_d_n()
    want = gen.fn(cells.d_X, n, gen.args)
    X, nc, args = as_in_graph((cells.d_X, n, gen.args))
    got = gen.fn(X, nc, args)
    assert isinstance(nc, torch.Tensor)
    for f, a, b in zip("xyz", got, want):
        assert torch.equal(a, b), f
    assert any(bool((a != 0).any()) for a in want)


def row0_link_dX(force, X, args):
    """The link forces as they were first written: every row adds at its
    own ends, a dead row (past ``n_links``, or ``a == b``) its masked
    zero, so the unset rows of a table (``a == b == 0``) all add into
    row 0."""
    a, b, n_links, strength = args
    live = (torch.arange(a.shape[0], device=a.device) < n_links) & (a != b)
    Xa = type(X)(*(f[a] for f in X))
    Xb = type(X)(*(f[b] for f in X))
    r = Xa - Xb
    dist = torch.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    dFa, dFb = force(Xa, Xb, r, dist, strength)

    def add(zero, fa, fb):
        fa = torch.where(live, torch.as_tensor(fa).expand(live.shape), 0.0)
        fb = torch.where(live, torch.as_tensor(fb).expand(live.shape), 0.0)
        return zero.index_add(0, a, fa).index_add(0, b, fb)
    return type(X)(*(add(z, fa, fb)
                     for z, fa, fb in zip(pt_zeros_like(X), dFa, dFb)))


def dead_row_table(cells, n_links=150, m=256, seed=0):
    """A link table of ``m`` rows over the example's cells: ``n_links``
    live rows, of which every fifth has ``a == b`` and one ends at row
    0, and past them stale links and unset rows (``a == b == 0``)."""
    g = torch.Generator().manual_seed(seed)
    n = cells.get_d_n()
    a = torch.randint(1, n, (m,), generator=g)
    b = torch.randint(1, n, (m,), generator=g)
    b[:n_links:5] = a[:n_links:5]
    b[7] = 0
    a[m - 64:] = 0
    b[m - 64:] = 0
    return a, b, n_links


@pytest.mark.parametrize("count_kind", ["int", "device"])
@pytest.mark.parametrize("gen_name", ["link_dX", "link", "link_wall"])
def test_dead_link_rows_give_the_row0_formula_bits(example, monkeypatch,
                                                   gen_name, count_kind):
    _, cells, _ = example
    a, b, n_links = dead_row_table(cells)
    links = Links(a.shape[0], device="cpu")
    links.d_a, links.d_b = a, b
    links.set_d_n(n_links)
    assert n_links < links.n_max
    n = cells.get_d_n()
    X, args = cells.d_X, links.state
    if gen_name == "link_dX":
        def fn(X, n, args):
            return links_mod._link_dX(linear_force, X, args)
    else:
        gen = link_forces(links) if gen_name == "link" \
            else link_wall_forces(links, WALL)
        fn, args = gen.fn, gen.args
    if count_kind == "device":
        X, n, args = as_in_graph((X, n, args))
        assert isinstance(n, torch.Tensor)
    got = fn(X, n, args)
    with monkeypatch.context() as m:
        m.setattr(links_mod, "_link_dX", row0_link_dX)
        want = fn(X, n, args)
    for f, u, v in zip("xyz", got, want):
        assert u.shape == v.shape and torch.equal(u, v), f
    assert bool((want.x[0] != 0) | (want.y[0] != 0) | (want.z[0] != 0))


def test_dead_link_rows_add_into_rows_of_their_own(example, monkeypatch):
    """Every index a dead row adds at lies past X's rows and no other row
    shares it: no address takes the adds of every dead row."""
    _, cells, _ = example
    a, b, n_links = dead_row_table(cells)
    seen = []
    real = torch.Tensor.index_add

    def spy(self, dim, index, source, **kw):
        seen.append(index.clone())
        return real(self, dim, index, source, **kw)
    monkeypatch.setattr(torch.Tensor, "index_add", spy)
    links_mod._link_dX(linear_force, cells.d_X, (a, b, n_links, 0.15))
    assert len(seen) == 6
    live = (torch.arange(a.shape[0]) < n_links) & (a != b)
    n_rows = cells.d_X.x.shape[0]
    for index, ends in zip(seen, [a, b] * 3):
        assert torch.equal(index[live], ends[live])
        dead = index[~live]
        assert bool((dead >= n_rows).all())
        assert dead.unique().numel() == dead.numel() > 64


class _OnCuda:
    """Stands for a CUDA tensor where only its description is read."""
    is_cuda = True


def key(X=None, gen=None, **kw):
    if X is None:
        X = Float3(*(_OnCuda() for _ in range(3)))
    return segment_key(kw.get("engine", ENGINES["gabriel_lattice"]),
                       relu_force, wall_friction, "com", X, dt, r_max, 0,
                       None, gen)


def test_segment_key_on_cuda_with_and_without_a_declared_force():
    links = Links(64, device="cpu")
    assert key() is not None
    assert key(gen=link_wall_forces(links, WALL)) is not None
    assert key(gen=link_wall_forces(links, WALL)) != key()


def test_segment_key_none_on_cpu_tensors():
    assert key(X=Float3.zeros(128, device="cpu")) is None


def test_segment_key_none_for_a_force_without_capture_key():
    assert key(gen=GenericForce(lambda X, n, args: X)) is None
    assert key(gen=solvers._as_generic(lambda X, n: X)) is None


def test_links_builders_declare_equal_capture_keys_for_equal_builders():
    a, b = Links(64, device="cpu"), Links(128, 0.3, device="cpu")
    made = {"link": (link_forces(a), link_forces(b)),
            "wall": (wall_forces(WALL), wall_forces(WALL + 1)),
            "link_wall": (link_wall_forces(a, WALL),
                          link_wall_forces(b, WALL + 1))}
    for g1, g2 in made.values():
        assert g1.capture_key is not None
        assert g1.fn is not g2.fn
        assert g1.capture_key == g2.capture_key
        assert hash(g1.capture_key) == hash(g2.capture_key)
    assert len({g1.capture_key for g1, _ in made.values()}) == 3
    other = link_forces(a, force=lambda *args: args, fields=("x",))
    assert other.capture_key != made["link"][0].capture_key


def test_segment_key_same_for_steps_whose_counts_differ(monkeypatch):
    """The keys a graph of each segment is kept under
    (``step_graph.cache_key``), over example steps whose cell and link
    counts differ: one pair a step, the same on every step."""
    torch.set_num_threads(2)
    ex = small_example(monkeypatch)
    cells = ex.setup("cpu", 5)
    cells.engine = dataclasses.replace(cells.engine, lattice=True)
    state = ex.start(cells, seed=5)
    real = solvers._heun
    seen = []

    def spy(engine, pw_int, pw_friction, fix_mode, X, old_v, n, dt,
            cube_size, fix_point, precompute, gen, gen_args, segment):
        base = segment_key(engine, pw_int, pw_friction, fix_mode,
                           type(X)(*(_OnCuda() for _ in X)), dt, cube_size,
                           fix_point, precompute, gen)
        assert base is not None
        keys = []

        def record(tag, body, tree, copy):
            keys.append(step_graph.cache_key(base + (tag,), tree))
            return body(tree)
        out = real(engine, pw_int, pw_friction, fix_mode, X, old_v, n, dt,
                   cube_size, fix_point, precompute, gen, gen_args, record)
        seen.append(((n, gen_args[0][2]), keys))
        return out
    monkeypatch.setattr(solvers, "_heun", spy)
    for _ in range(8):
        ex.step(cells, state)
    counts = [c for c, _ in seen]
    assert any(a[0] != b[0] and a[1] != b[1]
               for a, b in zip(counts, counts[1:])), counts
    first = seen[0][1]
    assert len(first) == 2 and first[0] != first[1]
    assert all(keys == first for _, keys in seen)
    assert all(hash(k) == hash(j) for _, keys in seen
               for k, j in zip(keys, first))


def test_cache_key_holds_the_structure_not_the_counts():
    a, b = torch.zeros(4), torch.ones(4, dtype=torch.int64)
    k = step_graph.cache_key(("k",), ((a, b), {"n": 3, "s": 0.5}))
    assert k == step_graph.cache_key(("k",), ((a + 1, b), {"n": 9,
                                                           "s": 0.5}))
    assert k != step_graph.cache_key(("k",), ((a, b), {"n": 3, "s": 0.25}))
    assert k != step_graph.cache_key(("k",), ((a, a), {"n": 3, "s": 0.5}))
    assert k != step_graph.cache_key(("k",), ((a[:3], b), {"n": 3,
                                                           "s": 0.5}))
    # one tensor twice is one input
    assert step_graph.cache_key((), (a, a)) != step_graph.cache_key(
        (), (a, a.clone()))
    leaves = []
    spec = step_graph._flatten((Float3(a, a, b), [a, 2], {"n": 3}), leaves,
                               {})
    assert len(leaves) == 4
    out = step_graph._build(spec, leaves)
    assert type(out[0]) is Float3 and out[0].x is a and out[0].z is b
    assert out[1] == [a, 2] and out[2] == {"n": 3}


def test_heun_step_on_the_cpu_never_reaches_a_graph(example, monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU step reached a CUDA graph")
    monkeypatch.setattr(step_graph, "run", refuse)
    monkeypatch.setattr(step_graph, "segment", refuse)
    ex, cells, state = example
    gen = link_wall_forces(state.links, WALL)
    args = (cells.engine, relu_force, wall_friction, cells._fix_mode,
            cells.d_X, cells.d_old_v, cells.get_d_n(), dt, r_max,
            cells._fix_point, None, gen, gen.args)
    assert_same_bits(solvers.heun_step(*args), solvers._heun(*args))


def test_segment_share_reader_reads_replays_over_segments():
    read = harness.load_module(REPO / "perfbench" / "metrics"
                               / "integrator.segment_share.py").read
    ctx = SimpleNamespace(trace=None)
    with profiling.tracing():
        for _ in range(4):
            with profiling.span("integrator.heun_step"):
                pass
        profiling.count("integrator.segment_replay", 6)
        assert read(ctx) == pytest.approx(0.75)
    # a program without the counter (the parent's) reads nothing
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            pass
        assert read(ctx) is None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

STEPS = 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """``index_add`` on the card fixes no order unless asked to."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def card_example(monkeypatch, seed=7):
    """The tiny example relaxed on the card, its growth on the Gabriel
    lattice pass (K5): (module, cells)."""
    ex = small_example(monkeypatch)
    cells = ex.setup("cuda", seed)
    cells.engine = dataclasses.replace(cells.engine, lattice=True)
    return ex, cells


def run_steps(ex, cells, held, seed, monkeypatch, steps=STEPS):
    """``steps`` example steps from ``held``: the state after each, each
    Heun step's outputs with a copy made when it returned, and the calls
    of the names the benchmark's spy watches and of the link and wall
    forces (``links._wall_dX``, under ``wall_dX``)."""
    cells.d_X, cells.d_old_v, cells.d_n = held
    state = ex.start(cells, seed=seed)
    calls = {"update": 0, "take_step": 0, "proliferate": 0, "pairwise": 0,
             "wall_dX": 0}
    heun = []

    def counted(name, real):
        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return call
    real_heun = solvers.heun_step

    def spy_heun(*args, **kwargs):
        out = real_heun(*args, **kwargs)
        heun.append((out, [(k, a.clone()) for k, a in leaves(out)]))
        return out
    after = []
    with monkeypatch.context() as m:
        m.setattr(Links, "update", counted("update", Links.update))
        m.setattr(solvers.Solution, "take_step",
                  counted("take_step", solvers.Solution.take_step))
        m.setattr(GabrielEngine, "pairwise",
                  counted("pairwise", GabrielEngine.pairwise))
        m.setattr(ex, "proliferate", counted("proliferate", ex.proliferate))
        m.setattr(links_mod, "_wall_dX",
                  counted("wall_dX", links_mod._wall_dX))
        m.setattr(solvers, "heun_step", spy_heun)
        for _ in range(steps):
            ex.step(cells, state)
            after.append((cells.d_X, cells.d_old_v, cells.get_d_n(),
                          state.links.d_a, state.links.d_b,
                          state.links.get_d_n()))
    torch.cuda.synchronize()
    return after, heun, calls


@pytest.mark.gpu
def test_graphed_example_steps_are_the_eager_steps(cuda, deterministic,
                                                   monkeypatch):
    ex, cells = card_example(monkeypatch)
    step_graph.clear()
    held = (cells.d_X, cells.d_old_v, cells.get_d_n())
    with profiling.tracing():
        got, got_heun, calls = run_steps(ex, cells, held, 11, monkeypatch)
        counters = profiling.counters()
        spans = profiling.spans()
    with monkeypatch.context() as m:
        m.setattr(solvers, "segment_key", lambda *args: None)
        with profiling.tracing():
            want, want_heun, _ = run_steps(ex, cells, held, 11, monkeypatch)
            eager = profiling.counters()
    assert not any(k.startswith("integrator.segment") for k in eager)

    forces = calls.pop("wall_dX")
    assert calls == {"update": STEPS, "take_step": STEPS,
                     "proliferate": STEPS, "pairwise": 2 * STEPS}
    assert counters["integrator.segment_capture"] == 2
    assert counters["integrator.segment_replay"] == 2 * (STEPS - 2)
    assert spans["integrator.heun_step"][0] == STEPS
    # the link and wall forces' Python runs at the eager step and the
    # capture, once a pass
    assert forces == 4
    assert counters["kernels.gabriel_pair"] == 2 * STEPS
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
    for k, ((g, g_copy), (w, _)) in enumerate(zip(got_heun, want_heun)):
        assert_same_bits(g, w)
        # kept past every later replay, unchanged
        for (name, a), (_, c) in zip(leaves(g), g_copy):
            assert torch.equal(a, c), (k, name)
    step_graph.clear()


@pytest.mark.gpu
def test_segment_graphs_keep_four_and_evict_the_oldest(cuda, monkeypatch):
    ex, cells = card_example(monkeypatch)
    step_graph.clear()
    engines = [dataclasses.replace(cells.engine, max_candidates=m)
               for m in (64, 72, 80, 88)]
    held = []
    with profiling.tracing():
        for engine in engines:
            cells.engine = engine
            for _ in range(3):
                cells.take_step(dt, relu_force, pw_friction=wall_friction,
                                gen_forces=wall_forces(WALL))
            held.append([(k[0].max_candidates, k[-1])
                         for k in step_graph.segment_keys()])
        counters = profiling.counters()
    assert held == [[(64, "first"), (64, "second")],
                    [(64, "first"), (64, "second"), (72, "first"),
                     (72, "second")],
                    [(64, "first"), (64, "second"), (72, "first"),
                     (72, "second"), (80, "first"), (80, "second")],
                    [(72, "first"), (72, "second"), (80, "first"),
                     (80, "second"), (88, "first"), (88, "second")]]
    assert counters["integrator.segment_capture"] == 8
    assert counters["integrator.segment_replay"] == 8
    assert step_graph.MAX_SEGMENTS == 6
    step_graph.clear()

