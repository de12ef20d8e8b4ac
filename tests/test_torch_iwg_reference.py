"""The plain reference of the intercalation_w_gradient step
(``perfbench/reference/intercalation_w_gradient.py``) against the port.

* The port's example ``step`` (at a tiny size, ``iwg_helpers``: a ball
  of 280 cells cut from the embryo in 1,024 rows, the lattice route's
  plain version on the CPU) with injected draws, step after step from
  the port's own state, the division rate raised to 0.2 on both sides so
  that the epithelium divides in most steps: the protrusions, the counts
  of cells and of neighbours equal, positions, w, f, the polarity and
  old_v within the cell's tolerances.
* The reference's pair terms against the example's torch force on pairs
  of the cut's cells, at random distances within reach.
* The reference and the K1 work it counts import nothing of the program
  or of JAX.
The cell's faults and its control: ``test_torch_iwg_cell.py``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from iwg_helpers import small_example
from perfbench.loops.frames import unit
from perfbench.reference import intercalation_w_gradient as ref

REPO = Path(__file__).resolve().parent.parent
TOL = json.loads((REPO / "perfbench" / "configs"
                  / "intercalation_w_gradient_published.json").read_text()
                 )["tolerance"]
N_STEPS = 6
RATE = 0.2
PROGRAM = {"yalla_tpu_torch", "yalla_tpu", "jax", "jaxlib", "flax"}


class Fast(ref.Params):
    mean_proliferation_rate = RATE


def as_state(cells, links):
    return {"X": cells.d_X._asdict(), "old_v": list(cells.d_old_v),
            "n": cells.get_d_n(), "a": links.d_a, "b": links.d_b,
            "links_max": links.n_max}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(state before, draws, state after with the step's counts) of each
    of ``N_STEPS`` steps of the port's example, in the reference's
    form."""
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    try:
        ex, _, _ = small_example(mp, tmp_path_factory.mktemp("iwg"))
        mp.setattr(ex, "mean_proliferation_rate", RATE)
        cells = ex.setup("cpu", ex.IC_PATH)
        state = ex.start(cells, seed=5)
        g = torch.Generator().manual_seed(9)
        out = []
        for _ in range(N_STEPS):
            before = as_state(cells, state.links)
            draws = ex.draw(cells, state, g)
            aux = ex.step(cells, state, draws)
            after = dict(as_state(cells, state.links),
                         epi_nbs=aux["epi_nbs"], mes_nbs=aux["mes_nbs"])
            out.append((before, draws, after))
        return out
    finally:
        mp.undo()


def reference_step(before, draws):
    link_draws, growth_draws = draws
    return ref.step(before, tuple(link_draws),
                    (growth_draws.rnd, tuple(growth_draws.direction)),
                    p=Fast())


def close(a, b, tol):
    return bool(((a - b).abs() <= tol * (1 + b.abs())).all())


@pytest.mark.parametrize("k", range(N_STEPS))
def test_port_step_matches_the_reference(steps, k):
    before, draws, after = steps[k]
    want = reference_step(before, draws)
    assert after["n"] == want["n"]
    assert torch.equal(after["a"], want["a"])
    assert torch.equal(after["b"], want["b"])
    n = want["n"]
    for f in ("epi_nbs", "mes_nbs"):
        assert torch.equal(after[f][:n], want[f][:n]), f
    for f in ref.XYZ:
        gap = (after["X"][f][:n] - want["X"][f][:n]).abs()
        assert float(gap.max()) <= TOL["pos"], f
    for f in ("w", "f"):
        assert close(after["X"][f][:n], want["X"][f][:n], TOL["wf"]), f
    got = unit(after["X"]["theta"][:n], after["X"]["phi"][:n])
    for a, b in zip(got, unit(want["X"]["theta"][:n],
                              want["X"]["phi"][:n])):
        assert float((a - b).abs().max()) <= TOL["polarity"]
    for a, b in zip(after["old_v"], want["old_v"]):
        assert close(a[:n], b[:n], TOL["old_v"])
    assert not want["non_finite"]


def test_the_steps_divide_rewire_and_diffuse(steps):
    """The steps above are not idle: the epithelium divides in most, the
    protrusions are set and move, and w and f move in the mesenchyme."""
    grown = [after["n"] - before["n"] for before, _, after in steps]
    moved = [int(((after["a"] != before["a"])
                  | (after["b"] != before["b"])).sum())
             for before, _, after in steps]
    assert sum(g > 0 for g in grown) >= N_STEPS // 2, grown
    assert all(m > 10 for m in moved), moved
    first, last = steps[0][0], steps[-1][2]
    n = first["n"]
    mes = first["X"]["ctype"][:n] == ref.MESENCHYME
    for f in ("w", "f"):
        assert bool((last["X"][f][:n][mes] != first["X"][f][:n][mes]).any())


def test_reference_pair_terms_match_the_port_force(steps):
    """Every ordered pair of the first state's cells closer than 1, its
    distance from the state: the reference's pair terms and counts
    against the example's torch force (``polarity_precompute``'s
    channels), at the cell's tolerances."""
    import importlib
    from yalla_tpu_torch.ops.common import augment
    from yalla_tpu_torch.polarity import polarity_precompute
    from perfbench.reference.pairs import cell_pairs
    ex = importlib.import_module(
        "yalla_tpu_torch.examples.intercalation_w_gradient")
    before = steps[1][0]
    X = ex.Cell(**before["X"])
    n = before["n"]
    i, j, dist = cell_pairs(X.x, X.y, X.z, n, 1.0)
    assert i.numel() > 5 * n
    Xa = augment(X, n, polarity_precompute)
    Xi = type(Xa)(*(a[i] for a in Xa))
    Xj = type(Xa)(*(a[j] for a in Xa))
    dF, aux = ex.force(Xi, Xi - Xj, dist, i, j)
    X_ref = dict(before["X"])
    P = ref.polarity_trig(X_ref)
    terms, epi, mes = ref.pair_terms(X_ref, P, i, j, dist, ref.Params())
    assert torch.equal(aux["epi_nbs"], epi)
    assert torch.equal(aux["mes_nbs"], mes)
    both = (Xi.ctype == 1) & (Xj.ctype == 1)
    assert int(both.sum()) > 100 and int((Xi.ctype == 0).sum()) > 100
    for f in ("x", "y", "z", "w", "f", "theta", "phi"):
        got, want = getattr(dF, f), terms[f]
        assert bool(((got - want).abs()
                     <= 1e-5 * (1 + want.abs())).all()), f


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name", ["reference/intercalation_w_gradient.py",
                                  "roofline_iwg.py"])
def test_iwg_reference_imports_nothing_of_the_program(name):
    assert not set(imports_of(REPO / "perfbench" / name)) & PROGRAM
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import perfbench.{name[:-3].replace('/', '.')}; "
            "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    loaded = set(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True).stdout.split())
    assert not loaded & PROGRAM
