"""The growth_w_wall layers' spans (the step's ``model.step``, and in it
``rewiring.update``, ``gabriel.build``, ``gabriel.pair``, the flags'
``integrator.readback`` and the division count's ``growth.readback``;
the frame writes' ``output.submit`` and ``output.readback``) on one CPU
step of the example at a tiny size (``gww_helpers``): recorded under
``tracing()``, none off it, the step's self time its wall less its
layers' spans.  Beside
them, the benchmark's readers of those spans and of the cell's device
trace, on tables and traces made by hand, and the K5 work that
``perfbench/roofline_gabriel.py`` counts on a state counted by hand."""
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gww_helpers import small_example
from helpers import self_is_total_less
from perfbench import harness, roofline, roofline_gabriel
from yalla_tpu_torch.utils import profiling
from yalla_tpu_torch.vtkio import Vtk_output

REPO = Path(__file__).resolve().parent.parent
SPANS = ("model.step", "rewiring.update", "gabriel.build", "gabriel.pair",
         "output.submit", "integrator.heun_step", "integrator.readback",
         "growth.readback", "output.readback")
# the spans opened directly inside the step's
STEP_CHILDREN = ("rewiring.update", "integrator.heun_step",
                 "integrator.readback", "growth.proliferate")


@pytest.fixture
def one_step(monkeypatch, tmp_path):
    """``fn(traced)``: one step of the example and its frame's three
    writes, under ``tracing()`` where ``traced``; returns the table."""
    torch.set_num_threads(2)
    ex = small_example(monkeypatch)
    cells = ex.setup("cpu", 3)
    cells.engine = dataclasses.replace(cells.engine, lattice=True)
    state = ex.start(cells, seed=3)
    cell_type = ex.cell_types(cells)

    def run(traced):
        profiling.clear()
        with Vtk_output("gww", str(tmp_path), verbose=False) as out:
            if traced:
                with profiling.tracing():
                    ex.step(cells, state)
                    ex.write_frame(out, cells, state, cell_type)
            else:
                ex.step(cells, state)
                ex.write_frame(out, cells, state, cell_type)
        return profiling.spans()
    return run


def test_gww_step_records_its_spans(one_step):
    spans = one_step(True)
    assert set(SPANS) <= set(spans), sorted(spans)
    counts = {k: spans[k][0] for k in SPANS}
    # the frame's writes read back the positions and the links, not the
    # cell types (a property with no device copy)
    assert counts == {"model.step": 1, "rewiring.update": 1,
                      "gabriel.build": 2, "gabriel.pair": 2,
                      "output.submit": 3, "integrator.heun_step": 1,
                      "integrator.readback": 1, "growth.readback": 1,
                      "output.readback": 2}
    assert all(spans[k][1] > 0 for k in SPANS)


def test_gww_step_self_time_is_what_its_layers_leave(one_step):
    spans = one_step(True)
    assert self_is_total_less(spans, "model.step", STEP_CHILDREN)
    assert 0 < spans["model.step"][2] < spans["model.step"][1]


def test_gww_step_records_nothing_off_tracing(one_step):
    assert one_step(False) == {}


def reader(name):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / f"{name}.py").read


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


HOST = {"gabriel.host_ms_per_step": 1e3 * 2 * (0.002 + 0.003) / 2,
        "rewiring.host_ms_per_step": 1e3 * 0.004 / 2}


@pytest.mark.parametrize("name", sorted(HOST))
def test_gww_span_reader_reads_its_ratio(name, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("integrator.heun_step"):
                with profiling.span("gabriel.build"):
                    clock.t += 0.002
                with profiling.span("gabriel.pair"):
                    clock.t += 0.003
        with profiling.span("rewiring.update"):
            clock.t += 0.004
    assert reader(name)(SimpleNamespace(trace=None)) == \
        pytest.approx(HOST[name])
    # a program without the spans (the parent's) reads nothing
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            pass
    assert reader(name)(SimpleNamespace(trace=None)) is None


DEVICE = ("gabriel_pair_roofline", "gww.step_mfu",
          "links.index_add_ms_per_step")


@pytest.mark.parametrize("name", DEVICE)
def test_gww_device_reader_is_none_untraced(name):
    assert reader(name)(SimpleNamespace(trace=None, cfg={
        "kernels": ["gabriel_pair", "pour"]})) is None


def test_gww_index_add_reader_reads_its_kernels():
    per_op = {"void indexFuncLargeIndex<float>": 0.003,
              "void indexFuncSmallIndex<float>": 0.001,
              "gabriel_pair_kernel": 0.5}
    trace = SimpleNamespace(steps=4, per_op=per_op)
    ctx = SimpleNamespace(trace=trace, op_seconds=lambda names: sum(
        v for k, v in per_op.items() if any(n in k for n in names)))
    assert reader("links.index_add_ms_per_step")(ctx) == \
        pytest.approx(1.0)
    per_op.pop("void indexFuncLargeIndex<float>")
    per_op.pop("void indexFuncSmallIndex<float>")
    assert reader("links.index_add_ms_per_step")(ctx) is None


def test_gww_k5_work_on_a_state_counted_by_hand():
    """The wall node and two cells 0.5 apart in one cube, in 128 rows,
    grid 64, C 16: each cell's stencil holds both cells and the wall
    node's (three cubes below) itself alone, so 5 slots are tested for
    reach; each cell has one candidate and keeps it, the wall node
    none."""
    n_pad, n = 128, 3
    x = torch.zeros(n_pad)
    y = torch.zeros(n_pad)
    z = torch.zeros(n_pad)
    z[0] = -2.5
    x[2] = 0.5
    n_bytes, n_ops = roofline_gabriel.k5_work(x, y, z, n, 1.0, 64, 16)
    assert n_ops == (5 * roofline.OPS_DIST
                     + 2 * roofline_gabriel.OPS_MIDPOINT
                     + 2 * roofline_gabriel.OPS_PAIR)
    occupancy = 8 * (64 ** 3 + 3)      # an empty slot ends each cube
    assert n_bytes == occupancy + 4 * 6 * n + 4 * 8 * n_pad
