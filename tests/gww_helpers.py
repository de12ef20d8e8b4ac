"""The growth_w_wall example at a tiny size on the CPU, for the tests of
its spans, its benchmark cell and the plain reference: the example's
sizes set small, its engines on a 16-cube grid (the lattice route's
build then covers 65,536 slots, not 4.2 million), and a checkout that
holds the benchmark with a tiny cell of the example beside the real
ones."""
import dataclasses
import importlib
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GRID = 16
CELL = "gww.tiny"


def small_example(monkeypatch, n_0=100, n_max=2000, time_steps=10,
                  relax_steps=20):
    """The example module with its sizes set and its engines on a
    ``GRID``-cube grid (undone by ``monkeypatch``); the relaxation's
    candidates capped at ``n_0``, more than a ball of ``n_0`` cells can
    give one cell."""
    ex = importlib.import_module("yalla_tpu_torch.examples.growth_w_wall")
    for k, v in dict(n_0=n_0, n_max=n_max, n_time_steps=time_steps,
                     relax_steps=relax_steps,
                     RELAX_CANDIDATES=min(ex.RELAX_CANDIDATES, n_0)).items():
        monkeypatch.setattr(ex, k, v)
    engine = ex.GabrielEngine

    def small(**kw):
        return dataclasses.replace(engine(**kw), grid_size=GRID)
    monkeypatch.setattr(ex, "GabrielEngine", small)
    return ex


def tiny_checkout(tmp_path, monkeypatch, **sizes):
    """A checkout with the benchmark and the cell ``CELL``: the published
    configuration at the sizes of :func:`small_example` (which it
    applies); the run's temporary files go under ``tmp_path``."""
    import tempfile
    ex = small_example(monkeypatch, **sizes)
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfgs = root / "perfbench" / "configs"
    cfg = json.loads((cfgs / "growth_w_wall_published.json").read_text())
    cfg.update(n_0=ex.n_0, n_max=ex.n_max, time_steps=ex.n_time_steps,
               relax_steps=ex.relax_steps,
               frame_every=max(1, ex.n_time_steps // 100))
    cfg["engine"]["grid_size"] = GRID
    (cfgs / "growth_w_wall_tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": CELL, "config": "growth_w_wall_tiny",
         "traffic": "published", "chips": 1, "why": "tiny"})
    for m in bench["per_layer"]:
        if "gww.published" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return root, ex
