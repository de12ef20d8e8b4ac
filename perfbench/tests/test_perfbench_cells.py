"""The frame loop end to end on the CPU's plain paths at a tiny size: a
sound run is correct; the control and each fault the cell can have are
not; a cell, a traffic mix and a metric added as files alone run."""
import json

import pytest
import torch

from perfbench import harness
from perfbench.calibrate import frame_faults

SEED = 2147483999
CELL = "branching.tiny"


def run(root, workload=CELL, seconds=0.0):
    return harness.run(root, workload, SEED, seconds, 0, device="cpu",
                       log=lambda *_: None)


def test_perfbench_cell_runs_correct(bench_root):
    r = run(bench_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 6
    assert set(r["metrics"]) == {"cell_steps_per_s", "interval_ms.p90",
                                 "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) >= {"old_v_share", "handoff_gap", "file_gap"}
    assert r["device"]["platform"] == "cpu"


def broken_heun(kind):
    """``heun_step`` of the program, broken where it produces its state."""
    from yalla_tpu_torch.solvers import heun_step

    def step(*args, **kwargs):
        X, old_v, aux = heun_step(*args, **kwargs)
        X_in, old_v_in, n = args[4], args[5], args[6]
        if kind == "unchanged":
            X, old_v = X_in, old_v_in
        elif kind == "half":
            X = type(X)(*(torch.where(torch.arange(a.shape[0]) % 2 == 0,
                                      a_in, a) for a, a_in in zip(X, X_in)))
        elif kind == "altered":
            x = X.x.clone()
            x[n // 3] += 1.0
            X = X._replace(x=x)
        elif kind == "old_v_zeroed":
            old_v = type(old_v)(*(torch.zeros_like(v) for v in old_v))
        else:
            old_v = old_v_in
        return X, old_v, aux
    return step


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered",
                                  "old_v_zeroed", "old_v_stale"])
def test_perfbench_frames_fault_is_not_correct(bench_root, monkeypatch,
                                               kind):
    from yalla_tpu_torch.models import branching
    monkeypatch.setattr(branching, "heun_step", broken_heun(kind))
    assert not run(bench_root)["correct"]


def judged(root, frame_fault=None):
    """The cell's compared numbers after the window's least run, the
    frame replaced by ``frame_fault`` where given; and its limits."""
    _, cfg, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    if frame_fault is not None:
        loop.frame = frame_faults(loop)[frame_fault]
        loop.restart()
    harness.window(loop, 0.0)
    loop.release()
    try:
        return loop.checks(), cfg["limits"], loop
    finally:
        loop.cleanup()


@pytest.mark.parametrize("fault", ["substep_dropped", "substep_repeated",
                                   "old_v_handed_stale"])
def test_perfbench_frame_handoff_fault_is_not_correct(bench_root, fault):
    checks, limits, _ = judged(bench_root, fault)
    assert checks["handoff_gap"] > limits["handoff_gap"], checks
    assert not harness.is_correct(checks, limits)


def test_perfbench_control_is_not_correct(bench_root):
    """The reference in bfloat16 in the program's place fails a limit, and
    a file of bfloat16 positions fails ``file_gap``."""
    sound, limits, loop = judged(bench_root)
    control = loop.readings(control=True)
    assert harness.is_correct(sound, limits), sound
    assert any(control[k] > limits[k] for k in control)
    assert loop.file_gap(control=True) > limits["file_gap"] \
        > sound["file_gap"]


def test_perfbench_new_cell_traffic_and_metric_from_files(bench_root):
    base = bench_root / "perfbench"
    traffic = json.loads((base / "traffic" / "frames.json").read_text())
    traffic.update(file_every=0)
    (base / "traffic" / "frames_nofiles.json").write_text(
        json.dumps(traffic))
    (base / "metrics" / "interval_ms.p50.py").write_text(
        "from perfbench.harness import quantile\n\n\n"
        "def read(ctx):\n"
        "    return 1e3 * quantile(ctx.window.intervals, 0.5)\n")
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "branching.tiny_nofiles", "config": "branching_tiny",
         "traffic": "frames_nofiles", "chips": 1, "why": "no writer"})
    bench["end_to_end"].append(
        {"name": "interval_ms.p50", "unit": "ms", "better": "lower",
         "bound": 0.1, "source": "host_clock",
         "workloads": ["branching.tiny_nofiles"]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(bench_root, "branching.tiny_nofiles")
    assert r["correct"], r["checks"]
    assert r["metrics"]["interval_ms.p50"]["value"] > 0
    assert "file_gap" not in r["checks"]
