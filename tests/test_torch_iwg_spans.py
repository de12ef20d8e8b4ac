"""The intercalation_w_gradient layers' spans on the CPU at a tiny size
(``iwg_helpers``): a frame of the example (``write_frame``, the span
``output.frame`` over its five writes, each ``output.submit``, among them
``write_field``'s, and ``output.readback`` for the positions, the links
and the cell types) and one step (``model.step``, and in it
``rewiring.update``, the lattice engine's eager ``lattice.build`` and
``lattice.pair``, ``integrator.readback`` and ``growth.readback``),
recorded under ``tracing()``, none off it, the step's self time its wall
less its layers' spans; ``write_polarity`` under ``output.submit`` too.
Beside them, the benchmark's readers of those
spans and of the two new cells' device traces, on tables and traces made
by hand, and the K1 work that ``perfbench/roofline_iwg.py`` counts on a
state counted by hand."""
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from helpers import self_is_total_less
from iwg_helpers import small_example
from perfbench import harness, roofline, roofline_iwg
from yalla_tpu_torch.utils import profiling
from yalla_tpu_torch.vtkio import Vtk_output

REPO = Path(__file__).resolve().parent.parent
SPANS = {"output.frame": 1, "output.submit": 5, "output.readback": 3,
         "model.step": 1, "rewiring.update": 1, "lattice.build": 2,
         "lattice.pair": 2, "integrator.heun_step": 1,
         "integrator.readback": 1, "growth.readback": 1}
# the spans opened directly inside the step's
STEP_CHILDREN = ("rewiring.update", "integrator.heun_step",
                 "integrator.readback", "growth.proliferate")


@pytest.fixture
def one_step(monkeypatch, tmp_path):
    """``fn(traced)``: one frame of the example and one step, under
    ``tracing()`` where ``traced``; returns the table."""
    torch.set_num_threads(2)
    ex, _, _ = small_example(monkeypatch, tmp_path)
    cells = ex.setup("cpu", ex.IC_PATH)
    state = ex.start(cells, seed=3)
    cell_type = ex.cell_types(cells)

    def run(traced):
        profiling.clear()
        with Vtk_output("iwg", str(tmp_path / "out"), verbose=False) as out:
            if traced:
                with profiling.tracing():
                    ex.write_frame(out, cells, state, cell_type)
                    ex.step(cells, state)
            else:
                ex.write_frame(out, cells, state, cell_type)
                ex.step(cells, state)
        return profiling.spans()
    return run


def test_iwg_frame_and_step_record_their_spans(one_step):
    spans = one_step(True)
    assert set(SPANS) <= set(spans), sorted(spans)
    assert {k: spans[k][0] for k in SPANS} == SPANS
    assert all(spans[k][1] > 0 for k in SPANS)
    # the frame's span holds its writes
    assert spans["output.frame"][1] >= spans["output.submit"][1]


def test_iwg_step_self_time_is_what_its_layers_leave(one_step):
    spans = one_step(True)
    assert self_is_total_less(spans, "model.step", STEP_CHILDREN)
    assert 0 < spans["model.step"][2] < spans["model.step"][1]


def test_iwg_frame_and_step_record_nothing_off_tracing(one_step):
    assert one_step(False) == {}


@pytest.mark.parametrize("write", ["write_field", "write_polarity"])
def test_field_and_polarity_writes_are_submit_spans(write, tmp_path):
    """Each of the two writes is one ``output.submit``, like the
    positions before it."""
    from yalla_tpu_torch import Solution
    from yalla_tpu_torch.dtypes import Po_cell
    cells = Solution(Po_cell, 10, device="cpu")
    cells.h_n = 10
    cells.h_X.theta[:] = 0.5
    cells.copy_to_device()
    profiling.clear()
    with Vtk_output("f", str(tmp_path), verbose=False) as out:
        with profiling.tracing():
            out.write_positions(cells)
            getattr(out, write)(cells, *(("theta",) if write ==
                                          "write_field" else ()))
    assert profiling.spans()["output.submit"][0] == 2
    assert b"POINT_DATA 10" in (tmp_path / "f_0.vtk").read_bytes()


def reader(name):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / f"{name}.py").read


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def test_iwg_span_readers_read_their_ratios(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("output.frame"):
                clock.t += 0.006
            with profiling.span("integrator.heun_step"):
                with profiling.span("lattice.build"):
                    clock.t += 0.002
                with profiling.span("lattice.pair"):
                    clock.t += 0.003
    ctx = SimpleNamespace(trace=SimpleNamespace(),
                          traffic={"trace_intervals": 2})
    assert reader("iwg.lattice_host_ms_per_step")(ctx) == \
        pytest.approx(1e3 * (0.004 + 0.006) / 2)
    assert reader("iwg.output_ms_per_frame")(ctx) == pytest.approx(6.0)
    # a program without the spans (the parent's has no output.frame)
    # reads nothing
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            pass
    assert reader("iwg.lattice_host_ms_per_step")(ctx) is None
    assert reader("iwg.output_ms_per_frame")(ctx) is None


DEVICE = ("iwg.lattice_pair_roofline", "iwg.step_mfu",
          "iwg.link_forces_ms_per_step", "iwg.output_ms_per_frame",
          "steps.lattice_pair_roofline")


@pytest.mark.parametrize("name", DEVICE)
def test_iwg_device_readers_are_none_untraced(name):
    assert reader(name)(SimpleNamespace(trace=None, cfg={
        "kernels": ["lattice_pair", "pour"]})) is None


def test_iwg_link_forces_reader_reads_its_kernels():
    per_op = {"void indexFuncLargeIndex<float>": 0.003,
              "void indexFuncSmallIndex<float>": 0.001,
              "lattice_pair_kernel<IntercalationWGradient>": 0.5}
    ctx = SimpleNamespace(trace=SimpleNamespace(steps=4), op_seconds=lambda
                          names: harness.op_seconds(SimpleNamespace(
                              per_op=per_op), names))
    assert reader("iwg.link_forces_ms_per_step")(ctx) == pytest.approx(1.0)
    per_op.pop("void indexFuncLargeIndex<float>")
    per_op.pop("void indexFuncSmallIndex<float>")
    assert reader("iwg.link_forces_ms_per_step")(ctx) is None


def hand_state(n_pad=8):
    """(x, y, z, ctype): two epithelial cells 0.5 apart and a mesenchymal
    cell 0.6 from the first, 0.78 from the second, all in one cube."""
    x, y, z, ctype = (torch.zeros(n_pad) for _ in range(4))
    for a in (x, y, z):
        a[:3] = 0.1
    x[1] = 0.6
    y[2] = 0.7
    ctype[:2] = 1.0
    return x, y, z, ctype


def test_iwg_k1_work_on_a_state_counted_by_hand():
    """Each cell's stencil holds the three cells (9 tested for reach),
    all six ordered pairs are in reach, two have a mesenchymal i and two
    are epithelial both ways; at grid 4 and capacity 2, 128 slots."""
    n_bytes, n_ops = roofline_iwg.k1_work(*hand_state(), 3, 1.0, 4, 2)
    assert n_ops == (9 * roofline.OPS_DIST + 6 * roofline_iwg.OPS_PAIR
                     + 2 * roofline_iwg.OPS_MES + 2 * roofline_iwg.OPS_BEND
                     + 3 * roofline_iwg.OPS_SELF
                     + roofline_iwg.OPS_SELF_MES)
    assert n_bytes == 3 * 16 * 4 + 128 + 128 * 13 * 4


def test_iwg_roofline_readers_on_a_trace_made_by_hand():
    """K1's share is its least time over its kernels' device time, the
    step's share K1's and K2's least times over the window."""
    X = hand_state()
    cfg = {"engine": {"grid_size": 4, "capacity": 2}, "cube_size": 1.0,
           "fields": 15, "kernels": ["lattice_pair", "pour"]}
    per_op = {"lattice_pair_kernel<IntercalationWGradient>": 1e-6,
              "pour_kernel": 1e-6, "void indexFuncLargeIndex<float>": 1.0}
    ctx = SimpleNamespace(
        trace=SimpleNamespace(window_s=2e-3, steps=1), cfg=cfg,
        loop=SimpleNamespace(iwg_states=lambda: [(X, 3, 2)]),
        op_seconds=lambda names: harness.op_seconds(
            SimpleNamespace(per_op=per_op), names))
    k1 = 2 * roofline.bound(*roofline_iwg.k1_work(*X, 3, 1.0, 4, 2))[0]
    k2 = 2 * roofline.bound(*roofline.k2_work(8, 15, 4, 2))[0]
    assert reader("iwg.lattice_pair_roofline")(ctx) == \
        pytest.approx(100 * k1 / 1e-6)
    assert reader("iwg.step_mfu")(ctx) == \
        pytest.approx(100 * (k1 + k2) / 2e-3)
    # a loop without the states (a later loop's) reads nothing
    ctx.loop = SimpleNamespace()
    ctx.__dict__.pop("iwg_bounds")
    assert reader("iwg.lattice_pair_roofline")(ctx) is None
    assert reader("iwg.step_mfu")(ctx) is None


def test_steps_roofline_reader_on_a_trace_made_by_hand():
    """``roofline.k1_work`` on the branching functor at the engine the
    traffic states, over the two kernels' device time."""
    engine = {"grid_size": 4, "capacity": 2, "extras_cap": 16}
    per_op = {"lattice_pair_kernel<BranchingForce>": 2e-6,
              "extras_pair_kernel<BranchingForce>": 1e-6}
    xyz = hand_state()[:3]
    ctx = SimpleNamespace(
        trace=SimpleNamespace(), cfg={"cube_size": 1.0},
        traffic={"engine": engine},
        loop=SimpleNamespace(pass_states=lambda: [(xyz, 3, 11)]),
        op_seconds=lambda names: harness.op_seconds(
            SimpleNamespace(per_op=per_op), names))
    least = 11 * roofline.bound(*roofline.k1_work(*xyz, 3, 1.0, 4, 2,
                                                  16))[0]
    assert reader("steps.lattice_pair_roofline")(ctx) == \
        pytest.approx(100 * least / 3e-6)
