"""The per-layer readers of the program's spans and counters: None where
the table lacks them (an untraced run, or a program without the table),
and each stated ratio on a table filled by ``tracing()`` around a fake
set of spans timed by a clock set by hand."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import harness
from yalla_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[2]

READERS = ("frame.host_ms_per_step", "growth.host_ms_per_step",
           "growth.readback_ms_per_step", "glue.host_ms_per_step",
           "output.main_ms_per_file", "output.worker_ms_per_file",
           "output.mb_per_file", "setup.kernels_s")
CTX = SimpleNamespace(window=None, trace=None)


def reader(name):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / f"{name}.py").read


class Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def fake_window(clock):
    """Two frames of two substeps each and one file, in the program's
    span names; every span's seconds chosen by hand."""
    span = profiling.span
    with span("setup.kernels"):
        clock.t += 0.125
    with span("setup.native"):
        clock.t += 0.0625
    with span("output.submit"):
        clock.t += 0.001
    with span("output.job"):
        clock.t += 0.4
        profiling.count("output.bytes", 43_000_000)
    for _ in range(2):
        with span("frame"):
            clock.t += 0.002
            for _ in range(2):
                with span("growth.proliferate"):
                    clock.t += 0.003
                    with span("growth.readback"):
                        clock.t += 0.0005
                with span("growth.record_divisions"):
                    clock.t += 0.001
                with span("integrator.heun_step"):
                    clock.t += 0.010
    with span("output.drain"):
        clock.t += 0.003


@pytest.mark.parametrize("name", READERS)
def test_perfbench_span_reader_is_none_without_its_spans(name, monkeypatch):
    with profiling.tracing():
        pass
    assert reader(name)(CTX) is None
    # a program that keeps no such table (the parent of the tracer)
    monkeypatch.delattr(profiling, "spans")
    assert reader(name)(CTX) is None


# per step: 4 Heun steps; frames 2 x (0.002 + 2 x 0.0145) = 0.062 s, of
# which the readbacks 0.002
WANT = {"frame.host_ms_per_step": 1e3 * (0.062 - 0.002) / 4,
        "growth.host_ms_per_step": 1e3 * 4 * (0.003 + 0.001) / 4,
        "growth.readback_ms_per_step": 1e3 * 4 * 0.0005 / 4,
        "glue.host_ms_per_step": 1e3 * 4 * 0.010 / 4,
        "output.main_ms_per_file": 1e3 * (0.001 + 0.003),
        "output.worker_ms_per_file": 400.0,
        "output.mb_per_file": 43.0,
        "setup.kernels_s": 0.1875}


@pytest.mark.parametrize("name", READERS)
def test_perfbench_span_reader_reads_its_ratio(name, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(profiling, "time", clock)
    with profiling.tracing():
        fake_window(clock)
    assert reader(name)(CTX) == pytest.approx(WANT[name])
