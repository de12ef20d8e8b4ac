"""The port's spans and counters (``yalla_tpu_torch.utils.profiling``): the
off path, self time, the flagship frame's spans under ``torch.profiler``,
the writer's job on its worker thread, and the set-up spans."""
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from yalla_tpu_torch import _native
from yalla_tpu_torch.growth import lineage_init
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.solvers import LatticeEngine, Solution
from yalla_tpu_torch.utils import profiling
from yalla_tpu_torch.vtkio import Vtk_output

SETTLED_600 = Path(__file__).resolve().parent.parent / ".bench_cache" / \
    "settled_branching_600_s0_v1.npz"


class Clock:
    """A ``time`` module whose ``perf_counter`` reads a value set by
    hand."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


class NoClock:
    def perf_counter(self):
        raise AssertionError("the clock was read")


def test_off_path_records_nothing_and_reads_no_clock(monkeypatch):
    profiling.clear()
    monkeypatch.setattr(profiling, "time", NoClock())
    assert not profiling.enabled()
    off = profiling.span("frame")
    assert profiling.span("integrator.heun_step") is off
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("frame"):
                profiling.count("kernels.pour")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(
        before.filter_traces(only), "filename")
    assert sum(d.size_diff for d in grown) == 0
    assert profiling.spans() == {} and profiling.counters() == {}


def test_self_time_is_total_less_children(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("frame"):
                clock.t += 1.0
                with profiling.span("growth.proliferate"):
                    clock.t += 0.5
                    with profiling.span("growth.readback"):
                        clock.t += 0.25
                with profiling.span("integrator.heun_step"):
                    clock.t += 2.0
        profiling.count("output.bytes", 7)
        profiling.count("output.bytes", 5)
    got = profiling.spans()
    assert got["frame"] == pytest.approx((2, 7.5, 2.0))
    assert got["growth.proliferate"] == pytest.approx((2, 1.5, 1.0))
    assert got["growth.readback"] == pytest.approx((2, 0.5, 0.5))
    assert got["integrator.heun_step"] == pytest.approx((2, 4.0, 4.0))
    assert profiling.counters() == {"output.bytes": 12}
    # the outermost block starts from an empty table, an inner one adds
    with profiling.tracing():
        with profiling.span("frame"):
            pass
        with profiling.tracing():
            with profiling.span("frame"):
                pass
    assert profiling.spans()["frame"][0] == 2
    assert not profiling.enabled()


def test_spanned_keeps_the_function():
    @profiling.spanned("growth.proliferate")
    def f(a, b=2):
        """doc"""
        return a + b
    assert (f.__name__, f.__doc__, f(1, b=3)) == ("f", "doc", 4)
    with profiling.tracing():
        f(1)
    assert profiling.spans()["growth.proliferate"][0] == 1


def small_state():
    X, ov = load_settled(SETTLED_600, B.Cell, "cpu")
    n_pad = X.x.shape[0]
    return B.State(
        X=X, old_v=ov, n=600,
        lineage=lineage_init(2 * n_pad, n_pad, 600, device="cpu"),
        epi_nbs=torch.zeros(n_pad), mes_nbs=torch.zeros(n_pad),
        key=torch.Generator().manual_seed(0))


def test_frame_spans_under_the_profiler():
    """A frame of 2 substeps on the lattice engine: each substep's Heun
    step, division readback, lattice build and pair pass, the frame once,
    every span on the profiler's timeline by name."""
    engine = LatticeEngine(grid_size=16, capacity=16, z_block=2,
                           extras_cap=256, extras_block_cap=32)
    frame = B.make_frame(B.Params(), engine, substeps=2)
    state = small_state()
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        frame(state, 0.0)
    assert not profiling.enabled()
    got = profiling.spans()
    assert got["frame"][0] == 1
    for name in ("integrator.heun_step", "growth.proliferate",
                 "growth.readback", "growth.record_divisions"):
        assert got[name][0] == 2, name
    # two passes a Heun step, each a build and a pair pass
    assert got["lattice.build"][0] == got["lattice.pair"][0] == 4
    step = got["integrator.heun_step"]
    assert step[2] < step[1]
    assert got["lattice.build"][1] + got["lattice.pair"][1] \
        == pytest.approx(step[1] - step[2])
    frame_s = got["frame"]
    children = sum(got[k][1] for k in ("growth.proliferate",
                                       "growth.record_divisions",
                                       "integrator.heun_step"))
    assert frame_s[2] == pytest.approx(frame_s[1] - children)
    host = {e.name for e in prof.events()}
    assert set(got) <= host
    assert profiling.counters() == {}          # no kernel on the CPU


def write_one(out_dir, async_write=True):
    """One frame's file of the 600-cell state on the writer; returns its
    path."""
    X, ov = load_settled(SETTLED_600, B.Cell, "cpu")
    cells = Solution(B.Cell, X.x.shape[0], device="cpu")
    cells.d_X, cells.d_old_v, cells.d_n = X, ov, 600
    writer = Vtk_output("frame", str(out_dir), verbose=False,
                        async_write=async_write)
    path = Path(out_dir) / f"frame_{writer.time_step}.vtk"
    writer.write_frame(cells, polarity=True, fields=("u", "v"),
                       properties=(("type", X.ctype, np.int32),))
    writer.close()
    return path


def test_writer_job_records_on_its_worker_when_traced(tmp_path):
    with profiling.tracing():
        path = write_one(tmp_path / "on")
    got, c = profiling.spans(), profiling.counters()
    assert got["output.submit"][0] == got["output.job"][0] == 1
    job = got["output.job"]
    parts = sum(got[k][1] for k in ("output.transfer", "output.format",
                                    "output.write"))
    assert job[2] == pytest.approx(job[1] - parts)
    assert got["output.drain"][0] >= 1
    assert c["output.bytes"] == path.stat().st_size
    # the same file, written on the main thread
    sync = write_one(tmp_path / "sync", async_write=False)
    assert sync.read_bytes() == path.read_bytes()
    profiling.clear()
    write_one(tmp_path / "off")
    assert profiling.spans() == {} and profiling.counters() == {}


def test_carry_records_on_another_thread_only_when_traced():
    def job():
        with profiling.span("output.job"):
            pass
    profiling.clear()
    runs = []
    with profiling.tracing():
        runs.append(profiling.carry(job))
    runs.append(profiling.carry(job))
    for run in runs:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert profiling.spans()["output.job"][0] == 1


def test_setup_spans_record_without_tracing(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    profiling.clear()
    assert not profiling.enabled()
    lib = _native.get_lib()
    _native.get_lib()
    got = profiling.spans()
    assert got["setup.native"][0] == 1
    assert profiling.counters().get("setup.kernel_builds", 0) == \
        (1 if lib is not None else 0)
    t0 = time.perf_counter()
    with profiling.span("setup.kernels"):
        pass
    assert profiling.spans()["setup.kernels"][1] <= \
        time.perf_counter() - t0
