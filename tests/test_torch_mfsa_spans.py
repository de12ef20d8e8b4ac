"""The grid engine's spans and the tutorial example's frame on the CPU at a
tiny size (``mfsa_helpers``): a frame (``write_frame``, the span
``output.frame`` over its writes and their ``output.readback``) and one
step of each part (``model.step``, its self time its wall less its
layers' spans), recorded under ``tracing()``, none off it: ``grid.build``
and ``grid.pair`` once a pair pass, two a step, as children of
``integrator.heun_step``, and not for the grid the rewiring builds
(``rewiring.update``).  Beside
them, the cell's three readers on tables and traces made by hand, and
the work ``perfbench/roofline_mfsa.py`` counts against a count by
brute force."""
import itertools
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from helpers import self_is_total_less
from mfsa_helpers import small_example
from perfbench import harness, roofline, roofline_mfsa
from yalla_tpu_torch.utils import profiling
from yalla_tpu_torch.vtkio import Vtk_output

REPO = Path(__file__).resolve().parent.parent
# the spans of a frame and a step of each part, by count: the frame reads
# back the positions and the cell types (and the links in part 5), the
# step its flags (and the division count in part 4)
COMMON = {"output.frame": 1, "model.step": 1, "integrator.heun_step": 1,
          "grid.build": 2, "grid.pair": 2, "integrator.readback": 1}
PARTS = [dict(COMMON, **{"output.submit": 4, "output.readback": 2}),
         dict(COMMON, **{"output.submit": 4, "output.readback": 2}),
         dict(COMMON, **{"output.submit": 4, "output.readback": 2}),
         dict(COMMON, **{"output.submit": 4, "output.readback": 2,
                         "growth.proliferate": 1, "growth.readback": 1}),
         dict(COMMON, **{"output.submit": 5, "output.readback": 3,
                         "rewiring.update": 1})]
# the spans opened directly inside the step's, each part
STEP_CHILDREN = [("integrator.heun_step", "integrator.readback")] * 3 + [
    ("integrator.heun_step", "integrator.readback", "growth.proliferate"),
    ("integrator.heun_step", "integrator.readback", "rewiring.update")]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The tables of a frame and a step at the first step of each part,
    traced, and of the same untraced a step later."""
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    try:
        ex = small_example(mp)
        cells = ex.setup("cpu", 5)
        state = ex.start(cells, seed=5)
        cell_type = ex.cell_types(cells)
        out_dir = str(tmp_path_factory.mktemp("mfsa"))
        traced, untraced = [], []
        with Vtk_output("mfsa", out_dir, verbose=False) as out:
            for t in range(5 * (ex.part_steps + 1)):
                first = t % (ex.part_steps + 1)
                profiling.clear()
                if first == 0:
                    with profiling.tracing():
                        ex.write_frame(out, cells, state, cell_type)
                        ex.step(cells, state)
                    traced.append(profiling.spans())
                else:
                    ex.write_frame(out, cells, state, cell_type)
                    ex.step(cells, state)
                    if first == 1:
                        untraced.append(profiling.spans())
        return traced, untraced
    finally:
        mp.undo()


@pytest.mark.parametrize("part", range(5))
def test_mfsa_frame_and_step_record_their_spans(tables, part):
    spans = tables[0][part]
    want = PARTS[part]
    assert set(want) <= set(spans), sorted(spans)
    assert {k: spans[k][0] for k in want} == want
    assert all(spans[k][1] > 0 for k in want)
    # the passes' spans lie inside the step's, the writes inside the frame
    assert spans["integrator.heun_step"][1] >= \
        spans["grid.build"][1] + spans["grid.pair"][1]
    assert spans["output.frame"][1] >= spans["output.submit"][1]


@pytest.mark.parametrize("part", range(5))
def test_mfsa_step_self_time_is_what_its_layers_leave(tables, part):
    spans = tables[0][part]
    assert self_is_total_less(spans, "model.step", STEP_CHILDREN[part])
    assert 0 < spans["model.step"][2] < spans["model.step"][1]


@pytest.mark.parametrize("part", range(5))
def test_mfsa_frame_and_step_record_nothing_off_tracing(tables, part):
    assert tables[1][part] == {}


def test_grid_spans_are_the_passes_not_other_builds():
    """``gabriel_pairwise`` and ``random_cube_neighbours`` build the grid
    too: neither records ``grid.build``; ``GridEngine.pairwise`` records
    it once a call."""
    from yalla_tpu_torch import Solution
    from yalla_tpu_torch.dtypes import Po_cell
    from yalla_tpu_torch.links import random_cube_neighbours
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.grid_xla import gabriel_pairwise
    from yalla_tpu_torch.solvers import GridEngine
    cells = Solution(Po_cell, 64, device="cpu")
    cells.h_n = 64
    g = torch.Generator().manual_seed(3)
    for f in ("x", "y", "z"):
        getattr(cells.h_X, f)[:64] = (torch.rand(64, generator=g)
                                      * 3).numpy()
    cells.copy_to_device()
    X = cells.d_X

    def force(Xi, r, dist, i, j):
        return r * 0.0
    ov = cells.d_old_v
    profiling.clear()
    with profiling.tracing():
        GridEngine().pairwise(force, friction_w_neighbour, X, ov, 64, 1.0)
        gabriel_pairwise(force, friction_w_neighbour, X, ov, 64, 1.0)
        random_cube_neighbours(X, 64, 2.0, 32, torch.arange(64),
                               torch.zeros(64, dtype=torch.int64),
                               torch.zeros(64))
    spans = profiling.spans()
    assert spans["grid.build"][0] == spans["grid.pair"][0] == 1


def reader(name):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / f"{name}.py").read


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def test_mfsa_span_readers_read_their_ratios(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("output.frame"):
                clock.t += 0.004
            with profiling.span("integrator.heun_step"):
                for _ in range(2):
                    with profiling.span("grid.build"):
                        clock.t += 0.001
                    with profiling.span("grid.pair"):
                        clock.t += 0.003
    ctx = SimpleNamespace(trace=SimpleNamespace(),
                          traffic={"trace_intervals": 2})
    assert reader("mfsa.grid_host_ms_per_step")(ctx) == \
        pytest.approx(1e3 * 2 * 0.008 / 2)
    assert reader("mfsa.output_ms_per_frame")(ctx) == pytest.approx(4.0)
    # a program without the spans (the parent's) reads nothing
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            pass
    assert reader("mfsa.grid_host_ms_per_step")(ctx) is None
    assert reader("mfsa.output_ms_per_frame")(ctx) is None


def hand_state(n_pad=8):
    """(x, y, z, w, ctype): two epithelial cells 0.5 apart, a mesenchymal
    cell of w 0.5 0.6 from the first and 0.78 from the second, and a
    mesenchymal cell of w -1 far from them, all live."""
    x, y, z, w, ctype = (torch.zeros(n_pad) for _ in range(5))
    for a in (x, y, z):
        a[:3] = 0.1
    x[1] = 0.6
    y[2] = 0.7
    x[3] = 5.0
    ctype[:2] = 1.0
    w[2], w[3] = 0.5, -1.0
    return x, y, z, w, ctype


def test_mfsa_work_on_a_state_counted_by_hand():
    """All six ordered pairs of the three near cells are in reach, two
    with a mesenchymal i of w >= 0, two epithelial both ways; four live
    diagonals, one mesenchymal of w >= 0."""
    n_bytes, n_ops, pairs = roofline_mfsa.pass_work(*hand_state(), 4)
    assert pairs == 6
    assert n_ops == (6 * roofline_mfsa.OPS_PAIR + 2 * roofline_mfsa.OPS_MES
                     + 2 * roofline_mfsa.OPS_BEND + 4 * roofline_mfsa.OPS_SELF
                     + roofline_mfsa.OPS_SELF_MES)
    assert n_bytes == 4 * 27 * 4


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mfsa_work_equals_a_brute_force_count(seed):
    """Pairs and operations on a random state of 90 live cells in 100
    rows against every ordered pair tested one by one."""
    g = torch.Generator().manual_seed(seed)
    n, n_pad = 90, 100
    x, y, z = (torch.rand(n_pad, generator=g) * 3.0 for _ in range(3))
    w = torch.rand(n_pad, generator=g) * 2 - 0.5
    ctype = (torch.rand(n_pad, generator=g) < 0.4).float()
    pairs = mes = both = 0
    for i, j in itertools.permutations(range(n), 2):
        rx, ry, rz = x[i] - x[j], y[i] - y[j], z[i] - z[j]
        if float(torch.sqrt(rx * rx + ry * ry + rz * rz)) < 1.0:
            pairs += 1
            mes += int(ctype[i] == 0 and w[i] >= 0)
            both += int(ctype[i] == 1 and ctype[j] == 1)
    takes = int(((ctype[:n] == 0) & (w[:n] >= 0)).sum())
    _, n_ops, got = roofline_mfsa.pass_work(x, y, z, w, ctype, n)
    assert got == pairs > n
    assert n_ops == (pairs * roofline_mfsa.OPS_PAIR
                     + mes * roofline_mfsa.OPS_MES
                     + both * roofline_mfsa.OPS_BEND
                     + n * roofline_mfsa.OPS_SELF
                     + takes * roofline_mfsa.OPS_SELF_MES)


def test_mfsa_step_mfu_reader_on_a_trace_made_by_hand():
    """The step's share is the least time of its passes over the
    window's wall; untraced, or with a loop that keeps no states, it
    reads nothing."""
    X = hand_state()
    ctx = SimpleNamespace(trace=SimpleNamespace(window_s=2e-3),
                          loop=SimpleNamespace(mfsa_states=lambda: [
                              (X, 4, 1), (X, 4, 1)]))
    least = 2 * roofline.bound(*roofline_mfsa.pass_work(*X, 4)[:2])[0]
    assert reader("mfsa.step_mfu")(ctx) == pytest.approx(
        100 * least / 2e-3)
    assert reader("mfsa.step_mfu")(SimpleNamespace(
        trace=SimpleNamespace(window_s=1.0), loop=SimpleNamespace())) \
        is None
    assert reader("mfsa.step_mfu")(SimpleNamespace(trace=None)) is None
    assert reader("mfsa.output_ms_per_frame")(
        SimpleNamespace(trace=None)) is None
