"""The step's spans: each cell's top-level call for a step (``model.step``
on an example's step, ``integrator.take_steps`` on ``Solution.take_steps``,
the flagship's ``frame``), the slot-order integrator's two eager
``lattice.build`` a step, and the ``<layer>.readback`` spans, each a wait
of the host for a value on the device.

On the CPU: ``take_steps(11)`` on the lattice engine and one flagship
frame of 11 substeps on the settled 600-cell tissue record each span as
often as the call makes it, the step span's self time is its wall less
its children's, and nothing records off tracing; the host mirrors'
one-transfer refresh keeps each field an array of its own; the
benchmark's five readers of these spans (``perfbench/metrics/step.*``,
``steps.build_host_ms_per_step``) on tables timed by hand, and None
without their spans (the examples' steps are in
``test_torch_{gww,iwg,mfsa}_spans.py``).  Marked ``gpu`` (skipped without
a CUDA device; on a machine with one, ``python -m pytest
tests/test_torch_step_spans.py -m gpu --noconftest -q``): over one step of
each of the three examples with its frame, one flagship frame and one
``take_steps(11)``, the ``*.readback`` spans count the synchronizations
``torch.cuda.set_sync_debug_mode("warn")`` reports.
"""
import dataclasses
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from helpers import self_is_total_less
from perfbench import harness
from yalla_tpu_torch.growth import lineage_init
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.links import Links
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.solvers import LatticeEngine, Solution
from yalla_tpu_torch.utils import profiling
from yalla_tpu_torch.vtkio import Vtk_output

REPO = Path(__file__).resolve().parent.parent
SETTLED_600 = REPO / ".bench_cache" / "settled_branching_600_s0_v1.npz"
P = B.Params()
STEPS = 11
ENGINE = LatticeEngine(grid_size=16, capacity=16, z_block=2,
                       extras_cap=256, extras_block_cap=32)


def lattice_cells(device):
    """The settled 600-cell tissue in a ``Solution`` on ``ENGINE``."""
    X, old_v = load_settled(SETTLED_600, B.Cell, device)
    cells = Solution(B.Cell, X.x.shape[0], engine=ENGINE, cube_size=P.r_max,
                     device=device)
    cells.d_X, cells.d_old_v, cells.d_n = X, old_v, 600
    return cells


def take_steps(cells):
    cells.take_steps(STEPS, P.dt, B.make_force(P),
                     pw_friction=friction_w_neighbour,
                     precompute=B.precompute)


def flagship_state(device):
    X, old_v = load_settled(SETTLED_600, B.Cell, device)
    n_pad = X.x.shape[0]
    key = torch.Generator(device=device)
    key.manual_seed(0)
    return B.State(
        X=X, old_v=old_v, n=600,
        lineage=lineage_init(2 * n_pad, n_pad, 600, device=device),
        epi_nbs=torch.zeros(n_pad, device=device),
        mes_nbs=torch.zeros(n_pad, device=device), key=key)


def traced(fn):
    """The table of ``fn()`` under ``tracing()``."""
    profiling.clear()
    with profiling.tracing():
        fn()
    return profiling.spans()


def untraced(fn):
    profiling.clear()
    fn()
    return profiling.spans()


def test_take_steps_records_its_call_builds_and_readback():
    torch.set_num_threads(2)
    cells = lattice_cells("cpu")
    spans = traced(lambda: take_steps(cells))
    assert {k: v[0] for k, v in spans.items()} == {
        "integrator.take_steps": 1, "lattice.build": 2 * STEPS,
        "integrator.readback": 1}
    assert self_is_total_less(spans, "integrator.take_steps",
                              ("lattice.build", "integrator.readback"))
    own = spans["integrator.take_steps"][2]
    assert 0 < own < spans["integrator.take_steps"][1]
    assert untraced(lambda: take_steps(cells)) == {}


def test_frame_records_its_readbacks_and_its_own_time():
    torch.set_num_threads(2)
    frame = B.make_frame(P, ENGINE, substeps=STEPS)
    state = flagship_state("cpu")
    spans = traced(lambda: frame(state, 0.0))
    counts = {k: v[0] for k, v in spans.items()}
    assert counts["frame"] == 1
    for name in ("integrator.heun_step", "growth.proliferate",
                 "growth.readback", "growth.record_divisions"):
        assert counts[name] == STEPS, name
    # the division count is the frame's one readback a substep
    assert [k for k in counts if k.endswith(".readback")] == \
        ["growth.readback"]
    assert self_is_total_less(spans, "frame", (
        "integrator.heun_step", "growth.proliferate",
        "growth.record_divisions"))
    assert 0 < spans["frame"][2] < spans["frame"][1]
    assert untraced(lambda: frame(state, 0.0)) == {}


def test_host_mirrors_come_back_whole_and_apart():
    """``Solution.copy_to_host`` and ``Links.copy_to_host`` pull their
    fields in one transfer (one readback on the card): each field holds
    its device values in an array of its own."""
    cells = lattice_cells("cpu")
    h = cells.copy_to_host()
    for f, a in zip(B.Cell._fields, cells.d_X):
        np.testing.assert_array_equal(getattr(h, f), a.numpy())
        assert getattr(h, f).dtype == np.float32
        assert not np.shares_memory(getattr(h, f), a.numpy())
    assert not np.shares_memory(h.x, h.y)
    links = Links(100, 1.0, device="cpu")
    g = torch.Generator().manual_seed(1)
    links.d_a = torch.randint(0, 600, (links.n_pad,), generator=g)
    links.d_b = torch.randint(0, 600, (links.n_pad,), generator=g)
    links.copy_to_host()
    for host, dev in ((links.h_a, links.d_a), (links.h_b, links.d_b)):
        assert host.dtype == np.int32
        np.testing.assert_array_equal(host, dev.numpy())
    assert not np.shares_memory(links.h_a, links.h_b)


def reader(name):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / f"{name}.py").read


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def ctx(steps):
    return SimpleNamespace(trace=SimpleNamespace(steps=steps))


def example_steps(clock, step="model.step", readback=True):
    """Two steps of ``step``, each 1 ms of its own, a 4-ms Heun step and
    (``readback``) a 2-ms flag readback, then a 3-ms frame readback
    outside the step."""
    for _ in range(2):
        with profiling.span(step):
            clock.t += 0.001
            with profiling.span("integrator.heun_step"):
                clock.t += 0.004
            if readback:
                with profiling.span("integrator.readback"):
                    clock.t += 0.002
    if readback:
        with profiling.span("output.readback"):
            clock.t += 0.003


STEP_READERS = {"step.host_ms_per_step": 7.0,
                "step.unspanned_ms_per_step": 1.0,
                "step.readbacks_per_step": 1.5,
                "step.readback_ms_per_step": 3.5}


@pytest.mark.parametrize("step", ["model.step", "integrator.take_steps"])
@pytest.mark.parametrize("name", sorted(STEP_READERS))
def test_step_readers_read_a_table_timed_by_hand(name, step, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        example_steps(clock, step)
    assert reader(name)(ctx(2)) == pytest.approx(STEP_READERS[name])
    # a program without the step's span (the parent's) reads nothing
    with profiling.tracing():
        with profiling.span("integrator.heun_step"):
            with profiling.span("growth.readback"):
                pass
    assert reader(name)(ctx(2)) is None


def test_step_readers_read_a_frame_and_no_readback(monkeypatch):
    """The frame's own time counts as the step's; a step that reads
    nothing back reads 0 readbacks, not None; the frame is no example
    step, so its wall is no ``step.host_ms_per_step``."""
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        example_steps(clock, "frame", readback=False)
    assert reader("step.unspanned_ms_per_step")(ctx(4)) == \
        pytest.approx(0.5)
    assert reader("step.readbacks_per_step")(ctx(4)) == 0
    assert reader("step.readback_ms_per_step")(ctx(4)) == 0
    assert reader("step.host_ms_per_step")(ctx(4)) is None


def test_build_reader_reads_its_span(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        with profiling.span("integrator.take_steps"):
            for _ in range(2 * STEPS):
                with profiling.span("lattice.build"):
                    clock.t += 0.0015
    assert reader("steps.build_host_ms_per_step")(ctx(STEPS)) == \
        pytest.approx(3.0)
    with profiling.tracing():
        with profiling.span("integrator.take_steps"):
            pass
    assert reader("steps.build_host_ms_per_step")(ctx(STEPS)) is None


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def syncs_and_readbacks(fn):
    """``fn()`` traced under ``set_sync_debug_mode("warn")``: the
    synchronizations reported (each its file and line) and the count of
    ``*.readback`` spans."""
    torch.cuda.synchronize()
    profiling.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profiling.tracing():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            spans = profiling.spans()
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]
    return syncs, sum(v[0] for k, v in spans.items()
                      if k.endswith(".readback"))


def example_calls(module, monkeypatch, tmp_path, device):
    """The example of ``module`` at a tiny size on ``device``: ``fn()``
    writes the next frame and runs the next step."""
    if module == "gww":
        from gww_helpers import small_example
        ex = small_example(monkeypatch)
        cells = ex.setup(device, 7)
        cells.engine = dataclasses.replace(cells.engine, lattice=True)
    elif module == "iwg":
        from iwg_helpers import small_example
        ex = small_example(monkeypatch, tmp_path)[0]
        cells = ex.setup(device, ex.IC_PATH)
    else:
        from mfsa_helpers import small_example
        ex = small_example(monkeypatch)
        cells = ex.setup(device, 5)
    state = ex.start(cells, seed=5)
    cell_type = ex.cell_types(cells)
    out = Vtk_output(module, str(tmp_path / "out"), verbose=False)

    def fn():
        ex.write_frame(out, cells, state, cell_type)
        ex.step(cells, state)
    return state, fn


@pytest.mark.gpu
@pytest.mark.parametrize("module", ["gww", "iwg", "mfsa"])
def test_example_readback_spans_are_its_syncs(cuda, module, monkeypatch,
                                              tmp_path):
    """The third step of the example and its frame, after two (the glue's
    graphs eager, then captured); in the tutorial the third step of each
    part (each part's frame and step differ), none of them a part's last
    step, whose transition copies the state in from the host."""
    state, fn = example_calls(module, monkeypatch, tmp_path, cuda)
    checked = []
    while len(checked) < (5 if module == "mfsa" else 1):
        if state.t % (state.n_steps + 1) == 2:
            syncs, readbacks = syncs_and_readbacks(fn)
            assert readbacks == len(syncs), (module, state.t, syncs)
            checked.append(readbacks)
        else:
            fn()
    # the flags and the positions at least, every time
    assert min(checked) >= 2, checked


@pytest.mark.gpu
def test_frame_readback_spans_are_its_syncs(cuda):
    frame = B.make_frame(P, ENGINE, substeps=STEPS)
    state = flagship_state(cuda)
    for _ in range(2):
        state, _ = frame(state, 0.0)
    syncs, readbacks = syncs_and_readbacks(lambda: frame(state, 0.0))
    assert readbacks == len(syncs) == STEPS, syncs


@pytest.mark.gpu
def test_take_steps_readback_spans_are_its_syncs(cuda):
    cells = lattice_cells(cuda)
    for _ in range(2):
        take_steps(cells)
    syncs, readbacks = syncs_and_readbacks(lambda: take_steps(cells))
    assert readbacks == len(syncs) == 1, syncs
