"""The intercalation_w_gradient example at a tiny size on the CPU, for the
tests of its spans, its benchmark cell and the plain reference: a ball
of a few hundred cells cut from the embryo of ``examples/sphere_ic.vtk``
where it holds epithelium, mesenchyme, w and f, written as the initial
condition of a small state (``N_MAX`` rows) on a 32-cube lattice, and a
checkout that holds the benchmark with a tiny cell of the example beside
the real ones."""
import hashlib
import importlib
import json
import shutil
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
GRID = 32
N_MAX = 1024
CELL = "iwg.tiny"
# the cut: cells within RADIUS of CENTRE, on the embryo's upper flank
CENTRE = np.array([9.0, 0.0, 2.5])
RADIUS = 3.5


def write_cut(path):
    """The cut of the embryo as a VTK file at ``path`` (positions,
    polarities, cell types); returns its cell count."""
    from yalla_tpu_torch import Property, Solution
    from yalla_tpu_torch.vtkio import Vtk_input, Vtk_output
    ex = importlib.import_module(
        "yalla_tpu_torch.examples.intercalation_w_gradient")
    inp = Vtk_input(str(ex.IC_PATH))
    n_0 = inp.n_points
    full = Solution(ex.Cell, n_0, device="cpu", solver="tile")
    full.h_n = n_0
    inp.read_positions(full)
    inp.read_polarity(full)
    types = Property(full.n_pad, "cell_type", device="cpu")
    inp.read_property(types, "cell_type")
    h = full.h_X
    P = np.stack([h.x[:n_0], h.y[:n_0], h.z[:n_0]], 1)
    keep = np.nonzero(np.linalg.norm(P - CENTRE, axis=1) < RADIUS)[0]
    cut = Solution(ex.Cell, len(keep), device="cpu", solver="tile")
    cut.h_n = len(keep)
    for f in ex.Cell._fields:
        getattr(cut.h_X, f)[:len(keep)] = getattr(h, f)[keep]
    cut_types = Property(cut.n_pad, "cell_type", device="cpu")
    cut_types.h_prop[:len(keep)] = types.h_prop[keep]
    cut.copy_to_device()
    path = Path(path)
    with Vtk_output(path.stem, str(path.parent), verbose=False) as out:
        out.write_positions(cut)
        out.write_polarity(cut)
        out.write_property(cut_types)
    (path.parent / f"{path.stem}_0.vtk").rename(path)
    return len(keep)


def small_example(monkeypatch, tmp_path, time_steps=10):
    """The example module with its initial condition the cut (written
    under ``tmp_path``), ``N_MAX`` rows, a ``GRID``-cube lattice and
    ``time_steps`` steps (undone by ``monkeypatch``); returns (the module,
    the cut's path, its cell count)."""
    ex = importlib.import_module(
        "yalla_tpu_torch.examples.intercalation_w_gradient")
    path = tmp_path / "cut.vtk"
    n = write_cut(path)
    for k, v in dict(IC_PATH=path, n_max=N_MAX, GRID_SIZE=GRID,
                     n_time_steps=time_steps).items():
        monkeypatch.setattr(ex, k, v)
    return ex, path, n


def tiny_checkout(tmp_path, monkeypatch, time_steps=10):
    """A checkout with the benchmark and the cell ``CELL``: the published
    configuration at the sizes of :func:`small_example` (which it
    applies); the run's temporary files go under ``tmp_path``."""
    import tempfile
    ex, path, n = small_example(monkeypatch, tmp_path, time_steps)
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfgs = root / "perfbench" / "configs"
    cfg = json.loads(
        (cfgs / "intercalation_w_gradient_published.json").read_text())
    cfg["ic"].update(file=str(path), n=n,
                     sha256=hashlib.sha256(path.read_bytes()).hexdigest())
    cfg.update(n_max=N_MAX, time_steps=time_steps)
    cfg["params"].update(n_max=N_MAX, time_steps=time_steps)
    cfg["engine"]["grid_size"] = GRID
    (cfgs / "intercalation_w_gradient_tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": CELL, "config": "intercalation_w_gradient_tiny",
         "traffic": "iwg_published", "chips": 1, "why": "tiny"})
    for m in bench["per_layer"]:
        if "iwg.published" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return root, ex
