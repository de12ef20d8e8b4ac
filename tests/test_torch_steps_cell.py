"""The benchmark's slot-order integrator cell (``perfbench/loops/steps.py``
on the configuration ``branching_500k``, traffic ``steps``) end to end on
the CPU at a tiny size: the settled 600-cell branching state in 2,000
rows on a 16-cube lattice with overflow extras, intervals of 3 steps.  A
sound run is correct and its spy sees every build; the bfloat16 control
and an integrator that hands on the predictor's velocity as old_v are
not, each by at least five times a limit.  On the card, one short run of
the real cell (marked ``gpu``)."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness

REPO = Path(__file__).resolve().parent.parent
SEED = 2147483999
CELL = "steps.tiny"
SMALL_STATE = {
    "file": str(REPO / ".bench_cache" / "settled_branching_600_s0_v1.npz"),
    "sha256": ("9204a1cd7e538a10ed8b73a33a145ce2"
               "f9a46e1e72ad97db741458db4d09fa6c"),
    "n": 600}


@pytest.fixture
def root(tmp_path):
    """A checkout with the benchmark and the cell ``CELL``: the
    configuration ``branching_500k`` on the small state, the traffic
    ``steps`` on a small engine and 3 steps an interval."""
    torch.set_num_threads(2)
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = root / "perfbench"
    cfg = json.loads((base / "configs" / "branching_500k.json").read_text())
    cfg.update(n_max=2000, state=SMALL_STATE)
    (base / "configs" / "branching_tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "steps.json").read_text())
    traffic.update(steps_per_interval=3, engine={
        "grid_size": 16, "capacity": 8, "extras_cap": 64,
        "extras_block_cap": 16, "rebuild_every": 1})
    (base / "traffic" / "steps_tiny.json").write_text(json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "branching_tiny",
                               "traffic": "steps_tiny", "chips": 1,
                               "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def fails_by_five(checks, limits):
    return any(v is None or v > 5 * limits[k] or (limits[k] == 0 and v > 0)
               for k, v in checks.items())


def test_steps_cell_runs_correct(root):
    r = harness.run(root, CELL, SEED, 0.0, 0, device="cpu",
                    log=lambda *_: None)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 4
    assert set(r["metrics"]) == {"cell_steps_per_s", "interval_ms.p90",
                                 "setup_s"}
    assert set(r["checks"]) == {"n_gap", "nbs_gap", "off_share",
                                "old_v_share", "pos_gap", "handoff_gap",
                                "failed"}


def judged(root, plant=None):
    _, cfg, _, loop = harness.load_cell(root, CELL, SEED, "cpu")
    if plant is None:
        harness.window(loop, 0.0)
    else:
        with plant:
            harness.window(loop, 0.0)
    loop.release()
    return loop, cfg["limits"]


def test_steps_cell_samples_the_first_and_last_steps(root):
    """Two samples an interval sampled (its first step and its last), and
    every hand-off the spy sees as it should be."""
    loop, limits = judged(root)
    assert len(loop.samples) == 2 * len(loop.picks) == 6
    assert loop.handoff_gap() == 0
    assert harness.is_correct(loop.checks(), limits)


def test_steps_cell_control_is_not_correct(root):
    loop, limits = judged(root)
    control = loop.readings(control=True)
    assert fails_by_five(control, limits), control


def test_steps_cell_stale_velocity_is_not_correct(root):
    """The integrator hands on its predictor's derivative as old_v."""
    from unittest import mock
    from yalla_tpu_torch.dtypes import Float3
    from yalla_tpu_torch.ops import lattice_xla

    def predictor(d1, d2):
        return Float3(d1.x, d1.y, d1.z)
    loop, limits = judged(root, mock.patch.object(lattice_xla, "mean_v",
                                                  predictor))
    checks = loop.checks()
    assert not harness.is_correct(checks, limits), checks
    assert fails_by_five(checks, limits), checks


@pytest.mark.gpu
def test_steps_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "branching.steps", "--seed", "2147483001",
                        "--seconds", "3", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r["checks"]
