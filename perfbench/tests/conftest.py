"""Fixtures of the benchmark's CPU tests: a checkout holding the
benchmark with a tiny cell beside the real ones (the settled 600-cell
branching state in 2,000 rows), built from the benchmark's own files plus
new ones."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SMALL_STATE = {
    "file": str(REPO / ".bench_cache" / "settled_branching_600_s0_v1.npz"),
    "sha256": ("9204a1cd7e538a10ed8b73a33a145ce2"
               "f9a46e1e72ad97db741458db4d09fa6c"),
    "n": 600}
TINY = {"branching.tiny": "branching.frames"}


def write_json(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=1))


@pytest.fixture
def bench_root(tmp_path, monkeypatch):
    """A checkout with the benchmark and its tiny cell; the run's
    temporary files go under ``tmp_path``."""
    import tempfile
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfgs = root / "perfbench" / "configs"
    b = json.loads((cfgs / "branching_500k.json").read_text())
    b.update(n_max=2000, state=SMALL_STATE,
             engine={"grid_size": 16, "capacity": 16, "z_block": 2,
                     "extras_cap": 256, "extras_block_cap": 32})
    write_json(cfgs / "branching_tiny.json", b)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": "branching.tiny", "config": "branching_tiny",
         "traffic": "frames", "chips": 1, "why": "tiny"}]
    for m in bench["per_layer"]:
        m["workloads"] += [t for t, real in TINY.items()
                           if real in m["workloads"]]
    write_json(root / "BENCHMARK.json", bench)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return root
