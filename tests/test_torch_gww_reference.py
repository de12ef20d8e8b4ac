"""The plain reference of the growth_w_wall step
(``perfbench/reference/growth_w_wall.py``) against the port and against a
brute force.

* The port's example ``step`` (at a tiny size, ``gww_helpers``: a relaxed
  ball of 200 cells in 2,048 rows, the Gabriel lattice route's plain
  version on the CPU) with injected draws, step after step from the
  port's own state, the division rate raised to 0.05 on both sides so
  that cells divide every step: the protrusions and the counts equal, the
  positions and old_v within the cell's tolerances.
* The reference's Gabriel pruning against an O(n^3) brute force in
  float64 at 200 cells.
* The reference and the K5 work it counts import nothing of the program
  or of JAX.
The cell's faults and its control: ``test_torch_gww_cell.py``."""
import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gww_helpers import small_example
from perfbench.reference import growth_w_wall as ref

REPO = Path(__file__).resolve().parent.parent
TOL = json.loads((REPO / "perfbench" / "configs"
                  / "growth_w_wall_published.json").read_text())["tolerance"]
N_STEPS = 6
RATE = 0.05
PROGRAM = {"yalla_tpu_torch", "yalla_tpu", "jax", "jaxlib", "flax"}


class Fast(ref.Params):
    prolif_rate = RATE


@pytest.fixture(scope="module")
def steps():
    """(state before, draws, state after) of each of ``N_STEPS`` steps of
    the port's example, in the reference's form."""
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    try:
        ex = small_example(mp, n_0=200, relax_steps=30)
        mp.setattr(ex, "prolif_rate", RATE)
        cells = ex.setup("cpu", 5)
        cells.engine = dataclasses.replace(cells.engine, lattice=True)
        state = ex.start(cells, seed=5)
        g = torch.Generator().manual_seed(9)
        out = []
        for _ in range(N_STEPS):
            links = state.links
            before = {"X": cells.d_X._asdict(), "old_v": list(cells.d_old_v),
                      "n": cells.get_d_n(), "a": links.d_a, "b": links.d_b,
                      "links_max": links.n_max}
            draws = ex.draw(cells, state, g)
            ex.step(cells, state, draws)
            after = {"X": cells.d_X._asdict(), "old_v": list(cells.d_old_v),
                     "n": cells.get_d_n(), "a": links.d_a, "b": links.d_b}
            out.append((before, draws, after))
        return out
    finally:
        mp.undo()


def reference_step(before, draws):
    link_draws, growth_draws = draws
    return ref.step(before, tuple(link_draws),
                    (growth_draws.rnd, tuple(growth_draws.direction)),
                    p=Fast())


@pytest.mark.parametrize("k", range(N_STEPS))
def test_port_step_matches_the_reference(steps, k):
    before, draws, after = steps[k]
    want = reference_step(before, draws)
    assert after["n"] == want["n"]
    assert torch.equal(after["a"], want["a"])
    assert torch.equal(after["b"], want["b"])
    n = want["n"]
    for f in ref.XYZ:
        gap = (after["X"][f][:n] - want["X"][f][:n]).abs()
        assert float(gap.max()) <= TOL["pos"], f
    for a, b in zip(after["old_v"], want["old_v"]):
        gap = (a[:n] - b[:n]).abs()
        assert bool((gap <= TOL["old_v"] * (1 + b[:n].abs())).all())
    assert not want["non_finite"]


def test_the_steps_divide_and_rewire(steps):
    """The steps above are not idle: cells divide in most, and the
    protrusions are set and move."""
    grown = [after["n"] - before["n"] for before, _, after in steps]
    moved = [int(((after["a"] != before["a"])
                  | (after["b"] != before["b"])).sum())
             for before, _, after in steps]
    assert sum(g > 0 for g in grown) >= N_STEPS // 2, grown
    assert all(m > 20 for m in moved), moved
    last = steps[-1][2]
    assert int((last["a"] != last["b"]).sum()) > last["n"] // 2


def brute_gabriel(P, cutoff, coefficient):
    """Kept ordered pairs ``{(i, j)}`` of the Gabriel test in float64,
    every triple tested: ``j`` within ``cutoff`` of ``i`` is kept unless
    another cell within ``cutoff`` of ``i`` lies closer than ``coefficient
    * d_ij / 2`` to their midpoint."""
    n = len(P)
    D2 = ((P[:, None] - P[None]) ** 2).sum(-1)
    near = (D2 < cutoff ** 2) & ~np.eye(n, dtype=bool)
    kept = set()
    for i in range(n):
        js = np.nonzero(near[i])[0]
        for j in js:
            m = (P[i] + P[j]) / 2
            dk2 = ((m - P[js]) ** 2).sum(-1)
            blocked = (dk2 < D2[i, j] * (coefficient / 2) ** 2) & (js != j)
            if not blocked.any():
                kept.add((i, int(j)))
    return kept


def test_reference_gabriel_matches_brute_force():
    """200 cells of a jittered lattice at the seed ball's spacing (0.5)
    in a ball, the wall node below them."""
    rng = np.random.default_rng(4)
    g = np.stack(np.meshgrid(*[np.arange(-4, 5)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) * 0.5
    g = g + rng.uniform(-0.15, 0.15, g.shape)
    g = g[np.argsort((g ** 2).sum(1))][:199]
    P = np.concatenate([[[0.0, 0.0, -2.3]], g]).astype(np.float32)
    n_pad = 256
    X = {f: torch.zeros(n_pad) for f in ref.XYZ}
    for c, f in enumerate(ref.XYZ):
        X[f][:200] = torch.as_tensor(P[:, c])
    p = ref.Params()
    i, j, _ = ref.gabriel_pairs(X, 200, p)
    got = set(zip(i.tolist(), j.tolist()))
    want = brute_gabriel(P.astype(np.float64), p.cutoff,
                         p.gabriel_coefficient)
    assert got == want
    # the test prunes: many pairs in reach are not Gabriel neighbours
    ni, _, _ = ref.near_pairs(X, 200, p.cutoff)
    assert 0.2 * ni.numel() < len(want) < 0.7 * ni.numel()


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["reference/growth_w_wall.py",
                                  "roofline_gabriel.py"])
def test_gww_reference_imports_nothing_of_the_program(name):
    assert not set(imports_of(REPO / "perfbench" / name)) & PROGRAM
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import perfbench.{name[:-3].replace('/', '.')}; "
            "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    loaded = set(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True).stdout.split())
    assert not loaded & PROGRAM
