"""The benchmark's intercalation_w_gradient cell
(``perfbench/loops/intercalation_w_gradient.py`` on the configuration
``intercalation_w_gradient_published``) end to end on the CPU at a tiny
size (``iwg_helpers``): a sound run is correct, over one segment through
the harness and over two segments by hand (the first segment's files
deleted when the second starts, the window's first file kept); the
control and each fault ``perfbench/calibrate_iwg.py`` plants are not,
each by at least five times a limit.  On the card, one short run of the
real cell (marked ``gpu``)."""
import json
import subprocess
import sys

import pytest
import torch

from iwg_helpers import CELL, REPO, tiny_checkout
from perfbench import harness
from perfbench.calibrate_iwg import faults
from perfbench.loops.intercalation_w_gradient import COMPARED

SEED = 2147483999
FAULTS = ("links_left_out", "rewiring_shifted", "old_v_stale",
          "division_dropped", "bending_left_out", "decay_left_out")


def fails_by_five(checks, limits):
    """Whether a number is at least five times its limit (above 0 where
    the limit is 0)."""
    return any(v is None or v > 5 * limits[k] or (limits[k] == 0 and v > 0)
               for k, v in checks.items())


def test_iwg_cell_runs_correct(tmp_path, monkeypatch):
    root, ex = tiny_checkout(tmp_path, monkeypatch)
    r = harness.run(root, CELL, SEED, 0.0, 0, device="cpu",
                    log=lambda *_: None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == ex.n_time_steps + 1
    assert set(r["metrics"]) == {"cell_steps_per_s", "interval_ms.p90",
                                 "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(COMPARED) | {"handoff_gap", "file_gap",
                                                "failed"}


def test_iwg_cell_two_segments_are_correct(tmp_path, monkeypatch):
    """Two whole segments: the second starts from the held embryo with
    the run's draws again; at its end the disk holds its files and the
    window's first."""
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    _, cfg, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    try:
        steps = [loop.interval()[1] for _ in range(2 * loop.F)]
        loop.close()
        files = sorted(p.name for p in
                       (tmp_path / "perfbench_iwg").glob("*.vtk"))
        loop.release()
        checks = loop.checks()
    finally:
        loop.cleanup()
    assert harness.is_correct(checks, cfg["limits"]), checks
    assert loop.counts["segments"] == 2 and sum(steps) == 2 * loop.F
    first = int(loop.file_sample[0].rsplit("_", 1)[1][:-4])
    assert files == sorted([f"iwg_{first}.vtk"] + [
        f"iwg_{first + loop.F + k}.vtk" for k in range(loop.F)])
    assert len(loop.samples) == len(loop.picks) == 3


def run_judged(root, fault=None):
    _, cfg, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    try:
        if fault is None:
            harness.window(loop, 0.0)
        else:
            with faults(loop)[fault]():
                harness.window(loop, 0.0)
        loop.release()
        return loop.checks(), cfg["limits"], loop
    finally:
        loop.cleanup()


@pytest.mark.parametrize("fault", FAULTS)
def test_iwg_cell_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    checks, limits, _ = run_judged(root, fault)
    assert not harness.is_correct(checks, limits), checks
    assert fails_by_five(checks, limits), checks


def test_iwg_cell_control_is_not_correct(tmp_path, monkeypatch):
    """The reference in bfloat16 in the program's place fails a limit by
    five times, and a file of bfloat16 values fails ``file_gap``."""
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    sound, limits, loop = run_judged(root)
    control = loop.readings(control=True)
    assert harness.is_correct(sound, limits), sound
    assert fails_by_five(control, limits), control
    assert loop.file_gap(control=True) > limits["file_gap"] \
        > sound["file_gap"]


@pytest.mark.gpu
def test_iwg_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "iwg.published", "--seed", "2147483001",
                        "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r["checks"]
