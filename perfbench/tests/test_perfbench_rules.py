"""The benchmark's own rules: what BENCHMARK.json may hold, what a run may
load, how a run without a card ends, and the roofline arithmetic against
the bounds the port's records give at the same shapes."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, roofline

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PROGRAM = {"yalla_tpu_torch", "yalla_tpu", "jax", "jaxlib", "flax"}


def test_perfbench_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).exists()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert (REPO / "perfbench" / "reference"
                / f"{cfg['model']}.py").exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
        traffic = json.loads((REPO / "perfbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (REPO / "perfbench" / "loops"
                / f"{traffic['loop']}.py").exists()


def test_perfbench_metrics_each_have_a_reader_and_a_cell():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip() == m["layer"]
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in harness.end_to_end(BENCH, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.per_layer(BENCH, w["name"])


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["reference/pairs.py",
                                  "reference/branching.py",
                                  "roofline.py"])
def test_perfbench_reference_imports_nothing_of_the_program(name):
    assert not set(imports_of(REPO / "perfbench" / name)) & PROGRAM
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import perfbench.{name[:-3].replace('/', '.')}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(json.loads(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True).stdout.replace("'", '"')))
    assert not loaded & PROGRAM


def test_perfbench_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "yalla_tpu_torch_x", sys)
    assert "yalla_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "yalla_tpu.models", sys)
    assert "yalla_tpu" in harness.forbidden_modules()


@pytest.mark.parametrize("workload", ["branching.tiny"])
def test_perfbench_dry_run_loads_no_jax(bench_root, workload, tmp_path):
    code = (f"import sys, tempfile; sys.path.insert(0, {str(REPO)!r}); "
            f"tempfile.tempdir = {str(tmp_path)!r}; "
            "from perfbench import harness; "
            f"r = harness.run({str(bench_root)!r}, {workload!r}, 7, 0.0, 0, "
            "'cpu', log=lambda *_: None); "
            "print(r['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["True", "[]"]


def test_perfbench_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "branching.frames", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""


def test_perfbench_bare_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program: the run ends non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path[:0] = ['.']; "
            "from perfbench import harness; "
            "harness.run('.', 'branching.frames', 7, 0.0, 0, 'cpu')")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, env=env)
    assert p.returncode != 0 and p.stdout == ""
    assert "yalla_tpu_torch" in p.stderr


def test_perfbench_roofline_k1_matches_the_500k_pass():
    """K1 on the settled 500k state at ``bench_state.json``
    ``branching_500000``'s grid 64, C 8, 2048 extras: 0.0404 ms, bound
    by its bytes (PERF.md, the kernel table)."""
    with np.load(REPO / ".bench_cache"
                 / "settled_branching_500000_s0_v1.npz") as d:
        x, y, z = (torch.as_tensor(d["X_" + f]) for f in "xyz")
    n_bytes, n_ops = roofline.k1_work(x, y, z, 500_000, 1.0, 64, 8, 2048)
    t, by = roofline.bound(n_bytes, n_ops)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0404
    assert 1.4e9 < n_ops < 1.8e9


def test_perfbench_roofline_k2_matches_the_flagship_build():
    """K2 at the flagship's 901,120 rows on grid 88, C 16: 47 MB read,
    567 MB written, 0.1832 ms (PERF.md, the kernel table)."""
    n_bytes, _ = roofline.k2_work(901_120, 8, 88, 16)
    assert round(roofline.bound(n_bytes, 0)[0] * 1e3, 4) == 0.1832


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["branching.frames"])
def test_perfbench_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        workload, "--seed", "2147483001", "--seconds", "3",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1])["correct"]
