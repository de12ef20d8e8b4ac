"""The tutorial example (model_features_sequential_addition) at a tiny
size on the CPU, for the tests of its spans, its benchmark cell and the
plain reference: ``PART_STEPS`` + 1 steps a part and ``N_MAX`` cells, so
that the growth of the fourth part fills the table's rows and the last
divisions are dropped, and a checkout that holds the benchmark with a
tiny cell of the example beside the real ones."""
import importlib
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PART_STEPS = 3
N_MAX = 240
N_PAD = 256
CELL = "mfsa.tiny"
MODULE = "yalla_tpu_torch.examples.model_features_sequential_addition"


def small_example(monkeypatch, part_steps=PART_STEPS):
    """The example module with ``N_MAX`` cells and ``part_steps`` + 1
    steps a part (undone by ``monkeypatch``)."""
    ex = importlib.import_module(MODULE)
    monkeypatch.setattr(ex, "n_max", N_MAX)
    monkeypatch.setattr(ex, "part_steps", part_steps)
    return ex


def tiny_checkout(tmp_path, monkeypatch, part_steps=PART_STEPS):
    """A checkout with the benchmark and the cell ``CELL``: the published
    configuration at the sizes of :func:`small_example` (which it
    applies); the run's temporary files go under ``tmp_path``."""
    import tempfile
    ex = small_example(monkeypatch, part_steps)
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfgs = root / "perfbench" / "configs"
    cfg = json.loads((cfgs / "model_features_published.json").read_text())
    cfg.update(n_max=N_MAX, n_pad=N_PAD, part_steps=part_steps)
    cfg["params"].update(n_max=N_MAX, part_steps=part_steps)
    (cfgs / "model_features_tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": CELL, "config": "model_features_tiny",
         "traffic": "mfsa_published", "chips": 1, "why": "tiny"})
    for m in bench["per_layer"]:
        if "mfsa.published" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return root, ex
