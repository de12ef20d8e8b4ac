"""The benchmark's tutorial-model cell (``perfbench/loops/model_features.py``
on the configuration ``model_features_published``) end to end on the CPU
at a tiny size (``mfsa_helpers``): the configuration states the example
module's constants; a sound run is correct, over one segment through the
harness and over two segments by hand (the first segment's files deleted
when the second starts, the window's first file kept); the control and
each fault ``perfbench/calibrate_mfsa.py`` plants are not, each by at
least five times a limit.  Beside it, the traffic of
``branching.frames_nofiles``.  On the card, one short run of the real
cell (marked ``gpu``)."""
import json
import subprocess
import sys

import pytest
import torch

from mfsa_helpers import CELL, MODULE, N_PAD, REPO, tiny_checkout
from perfbench import harness
from perfbench.calibrate_mfsa import faults
from perfbench.loops.model_features import COMPARED

SEED = 2147483999
FAULTS = ("links_left_out", "rewiring_shifted", "old_v_stale",
          "division_dropped", "bending_left_out", "decay_left_out",
          "background_friction_lost", "surface_shifted", "source_widened")
CFG = json.loads((REPO / "perfbench" / "configs"
                  / "model_features_published.json").read_text())


def fails_by_five(checks, limits):
    """Whether a number is at least five times its limit (above 0 where
    the limit is 0)."""
    return any(v is None or v > 5 * limits[k] or (limits[k] == 0 and v > 0)
               for k, v in checks.items())


def test_mfsa_configuration_states_the_example():
    """The published constants, the engine, the rows and the seed's
    place are the example module's, and nothing is reduced."""
    import importlib
    from yalla_tpu_torch.solvers import GridEngine, _pad_size
    ex = importlib.import_module(MODULE)
    assert CFG["params"] == dict(
        {k: getattr(ex, k) for k in (
            "r_max", "r_min", "dt", "n_0", "n_max", "prots_per_cell",
            "protrusion_strength", "r_protrusion", "proliferation_rate",
            "part_steps")}, protrusion_grid=ex.PROTRUSION_GRID)
    assert CFG["n_max"] == ex.n_max and CFG["part_steps"] == ex.part_steps
    assert CFG["n_pad"] == _pad_size(ex.n_max) == 4096
    cells = ex.setup("cpu")
    assert cells.engine == GridEngine(**CFG["engine"])
    assert CFG["reduced"] == [] and "seed" in CFG["assumed"]
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (c,) = [c for c in bench["configs"]
            if c["name"] == "model_features_published"]
    assert c["source"] == CFG["source"] and c["reduced"] == []


def test_mfsa_cell_runs_correct(tmp_path, monkeypatch):
    root, ex = tiny_checkout(tmp_path, monkeypatch)
    r = harness.run(root, CELL, SEED, 0.0, 0, device="cpu",
                    log=lambda *_: None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert r["attempted"] == 5 * (ex.part_steps + 1)
    assert set(r["metrics"]) == {"cell_steps_per_s", "interval_ms.p90",
                                 "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["checks"]) == set(COMPARED) | {"handoff_gap", "file_gap",
                                                "failed"}


def test_mfsa_cell_two_segments_are_correct(tmp_path, monkeypatch):
    """Two whole segments: the second starts from the held ball with the
    run's draws again and ends at the same count; at its end the disk
    holds its files and the window's first."""
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    _, cfg, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    try:
        counts = [loop.interval()[0] for _ in range(2 * loop.F)]
        loop.close()
        files = sorted(p.name for p in
                       (tmp_path / "perfbench_mfsa").glob("*.vtk"))
        loop.release()
        checks = loop.checks()
    finally:
        loop.cleanup()
    assert harness.is_correct(checks, cfg["limits"]), checks
    assert loop.counts["segments"] == 2
    assert counts[:loop.F] == counts[loop.F:]
    assert counts[0] == 200 < counts[-1] <= N_PAD
    first = int(loop.file_sample[0].rsplit("_", 1)[1][:-4])
    assert files == sorted([f"mfsa_{first}.vtk"] + [
        f"mfsa_{first + loop.F + k}.vtk" for k in range(loop.F)])
    assert len(loop.samples) == len(loop.picks) == 5
    assert sorted(p for _, p, *_ in loop.samples) == list(range(5))
    assert [t[0] for t in loop.transitions] == ["make_epithelium",
                                                "add_source"]


def test_mfsa_window_ends_with_a_segment(tmp_path, monkeypatch):
    """Past its seconds the window runs on to the end of the segment under
    way, so that it holds whole published runs."""
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    _, _, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    try:
        rec = harness.window(loop, 1.0)
    finally:
        loop.cleanup()
    n = len(rec.intervals)
    assert n >= loop.F and n % loop.F == 0, n
    assert loop.counts["segments"] == n // loop.F


def test_mfsa_window_ends_when_every_segment_flags(tmp_path, monkeypatch):
    """Every segment replays the same draws, so a flag repeats in each: a
    segment cut short ends there, the window ends past its seconds, and
    the run is not correct."""
    from yalla_tpu_torch.solvers import SimulationError
    root, ex = tiny_checkout(tmp_path, monkeypatch)
    _, cfg, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    real = ex.step

    def flagged(cells, state, draws=None):
        if state.t == 7:
            raise SimulationError("in-loop failure detected: grid_overflow")
        return real(cells, state, draws)
    try:
        with monkeypatch.context() as m:
            m.setattr(ex, "step", flagged)
            rec = harness.window(loop, 1.0)
        loop.release()
        checks = loop.checks()
    finally:
        loop.cleanup()
    assert len(rec.intervals) % 8 == 0
    assert checks["failed"] == loop.counts["flagged"] \
        == len(rec.intervals) // 8 >= 1
    assert not harness.is_correct(checks, cfg["limits"])


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
def test_mfsa_cell_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    checks, limits, _ = run_judged(root, fault)
    assert not harness.is_correct(checks, limits), checks
    assert fails_by_five(checks, limits), checks


def test_mfsa_cell_control_is_not_correct(tmp_path, monkeypatch):
    """The reference in bfloat16 in the program's place fails a limit by
    five times, and each of the shares above 0 (the cells off in a
    position or polarity, in w and in old_v) and the transitions' rows by
    themselves; a file of bfloat16 values fails ``file_gap`` by five
    times."""
    root, _ = tiny_checkout(tmp_path, monkeypatch)
    sound, limits, loop = run_judged(root)
    control = loop.readings(control=True)
    assert harness.is_correct(sound, limits), sound
    assert fails_by_five(control, limits), control
    for key in ("off_share", "w_share", "old_v_share", "transition_gap"):
        assert fails_by_five({key: control[key]}, limits), (key, control)
    assert loop.file_gap(control=True) > 5 * limits["file_gap"] \
        > sound["file_gap"]


def test_frames_nofiles_is_frames_without_files():
    """``frames_nofiles.json`` is ``frames.json`` but for ``file_every``
    (0: no file) and ``what``; its cell runs the flagship's
    configuration."""
    traffic = REPO / "perfbench" / "traffic"
    frames = json.loads((traffic / "frames.json").read_text())
    nofiles = json.loads((traffic / "frames_nofiles.json").read_text())
    assert set(frames) == set(nofiles)
    assert {k for k in frames if frames[k] != nofiles[k]} == {"file_every",
                                                              "what"}
    assert nofiles["file_every"] == 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"]
               if w["name"] == "branching.frames_nofiles"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("branching_500k", "frames_nofiles", 1)


@pytest.mark.gpu
def test_mfsa_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "mfsa.published", "--seed", "2147483001",
                        "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r["checks"]
