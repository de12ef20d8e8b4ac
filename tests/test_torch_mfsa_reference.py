"""The plain reference of the tutorial model's steps and transitions
(``perfbench/reference/model_features.py``) against the port.

* The port's example ``step`` (at a tiny size, ``mfsa_helpers``: 200
  cells in 256 rows, four steps a part, the grid engine on the CPU) with
  injected draws, step after step from the port's own state, the division
  rate raised to 0.2 on both sides so that the growth fills the table's
  rows and the last divisions are dropped: the protrusions, the counts of
  cells, the cell types and the neighbour counts equal, positions, w, the
  polarity and old_v within the cell's tolerances.
* The two transitions (``make_epithelium``, ``add_source``) from the
  port's own state: positions, types and w equal, the polarity within
  the cell's ``angle`` tolerance.
* The reference's pair terms against the example's torch force on pairs
  of a state with epithelium, mesenchyme and w.
* The reference and the work ``perfbench/roofline_mfsa.py`` counts
  import nothing of the program or of JAX.
The cell's faults and its control: ``test_torch_mfsa_cell.py``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mfsa_helpers import N_PAD, PART_STEPS, small_example
from perfbench.loops.model_features import polarity_off, transition_gap
from perfbench.reference import model_features as ref

REPO = Path(__file__).resolve().parent.parent
CFG = json.loads((REPO / "perfbench" / "configs"
                  / "model_features_published.json").read_text())
TOL = CFG["tolerance"]
N_STEPS = 5 * (PART_STEPS + 1)
RATE = 0.2
SEED = 2147483647 + 11
PROGRAM = {"yalla_tpu_torch", "yalla_tpu", "jax", "jaxlib", "flax"}


class Fast(ref.Params):
    proliferation_rate = RATE


def fields(X):
    return {f: getattr(X, f) for f in ref.FIELDS}


def as_state(cells, links):
    return {"X": fields(cells.d_X), "old_v": list(cells.d_old_v),
            "n": cells.get_d_n(), "a": links.d_a, "b": links.d_b,
            "links_max": links.n_max}


@pytest.fixture(scope="module")
def run():
    """Every step of the port's example at the tiny size, in the
    reference's form: (part, state before, draws, state after with the
    step's counts) each, and the two transitions: (name, cells before,
    count, arguments, cells after)."""
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    try:
        ex = small_example(mp)
        mp.setattr(ex, "proliferation_rate", RATE)
        cells = ex.setup("cpu", SEED)
        state = ex.start(cells, seed=SEED)
        g = torch.Generator().manual_seed(9)
        transitions, ended = [], []

        def recorded(name, real):
            def transition(cells, *args):
                before = fields(cells.d_X)
                ended.append(before)
                real(cells, *args)
                transitions.append((name, before, cells.get_d_n(), args,
                                    fields(cells.d_X)))
            return transition
        for name in ("make_epithelium", "add_source"):
            mp.setattr(ex, name, recorded(name, getattr(ex, name)))
        steps = []
        for _ in range(N_STEPS):
            part = ex.part_of(state)
            before = as_state(cells, state.links)
            draws = ex.draw(cells, state, g)
            ended.clear()
            ex.step(cells, state, draws)
            after = dict(as_state(cells, state.links),
                         epi_nbs=cells.aux["epi_nbs"],
                         mes_nbs=cells.aux["mes_nbs"])
            if ended:
                after["X"] = ended[0]
            steps.append((part, before, draws, after))
        return steps, transitions
    finally:
        mp.undo()


def reference_step(part, before, draws):
    link_draws = growth_draws = None
    if part == ref.PROTRUSIONS:
        link_draws = tuple(draws)
    if part == ref.GROWTH:
        growth_draws = (draws.rnd, tuple(draws.direction))
    return ref.step(before, part, link_draws, growth_draws, p=Fast())


def padded(state):
    """``state`` in twice its rows, the new ones empty."""
    def pad(v):
        return torch.cat([v, torch.zeros_like(v)])
    return dict(state, X={f: pad(v) for f, v in state["X"].items()},
                old_v=[pad(v) for v in state["old_v"]])


def padded_draws(draws):
    """Growth draws for twice the rows: the new rows draw no division."""
    from yalla_tpu_torch.growth import Draws
    return Draws(torch.cat([draws.rnd, torch.ones_like(draws.rnd)]),
                 type(draws.direction)(*(torch.cat([d, d])
                                         for d in draws.direction)))


def close(a, b, tol):
    return bool(((a - b).abs() <= tol * (1 + b.abs())).all())


@pytest.mark.parametrize("k", range(N_STEPS))
def test_port_step_matches_the_reference(run, k):
    part, before, draws, after = run[0][k]
    want = reference_step(part, before, draws)
    assert after["n"] == want["n"]
    if part == ref.PROTRUSIONS:
        assert torch.equal(after["a"], want["a"])
        assert torch.equal(after["b"], want["b"])
    n = want["n"]
    assert torch.equal(after["X"]["ctype"][:n], want["X"]["ctype"][:n])
    for f in ("epi_nbs", "mes_nbs"):
        assert torch.equal(after[f][:n], want[f][:n]), f
    for f in ref.XYZ:
        gap = (after["X"][f][:n] - want["X"][f][:n]).abs()
        assert float(gap.max()) <= TOL["pos"], f
    assert close(after["X"]["w"][:n], want["X"]["w"][:n], TOL["w"])
    assert not bool(polarity_off(after["X"], want["X"], n,
                                 TOL["polarity"]).any())
    for a, b in zip(after["old_v"], want["old_v"]):
        assert close(a[:n], b[:n], TOL["old_v"])
    assert not want["non_finite"]


def test_the_steps_grow_rewire_and_exchange(run):
    """The steps above are not idle: the growth fills the table's rows
    with divisions left over, the protrusions are set and move, w moves
    in the mesenchyme and the epithelium bends."""
    steps, _ = run
    P = PART_STEPS + 1
    (fill,) = [s for s in steps[3 * P:4 * P]
               if s[1]["n"] < N_PAD == s[3]["n"]]
    part, before, draws, _ = fill
    room = N_PAD - before["n"]
    kept = reference_step(part, before, draws)["parents"]
    wanted = reference_step(part, padded(before), padded_draws(draws))
    assert kept.numel() == room < wanted["parents"].numel()
    assert torch.equal(kept, wanted["parents"][:room])
    moved = [int(((after["a"] != before["a"])
                  | (after["b"] != before["b"])).sum())
             for _, before, _, after in steps[4 * P:]]
    assert all(m > 0 for m in moved) and sum(moved) > 20, moved
    first, end = steps[2 * P][1], steps[3 * P - 1][3]
    mes = first["X"]["ctype"][:first["n"]] == ref.MESENCHYME
    assert bool((end["X"]["w"][:first["n"]][mes]
                 != first["X"]["w"][:first["n"]][mes]).any())
    epi = end["X"]["ctype"] == ref.EPITHELIUM
    assert bool((end["X"]["theta"][epi]
                 != steps[P][1]["X"]["theta"][epi]).any())


@pytest.mark.parametrize("name", ["make_epithelium", "add_source"])
def test_port_transition_matches_the_reference(run, name):
    (got,) = [t for t in run[1] if t[0] == name]
    _, before, n, args, after = got
    if name == "make_epithelium":
        want = ref.make_epithelium(before, args[0])
        changed = after["ctype"] != before["ctype"]
    else:
        want = ref.add_source(before, n)
        changed = after["w"] != before["w"]
    assert int(changed.sum()) > 10
    assert transition_gap(after, want, N_PAD, TOL["angle"]) == 0


def test_reference_pair_terms_match_the_port_force(run):
    """Every ordered pair of a state's cells closer than 1 (the state
    after the source, with epithelium, mesenchyme and w), its distance
    from the state: the reference's pair terms and counts against the
    example's torch force (``polarity_precompute``'s channels)."""
    import importlib
    from mfsa_helpers import MODULE
    from perfbench.reference.intercalation_w_gradient import polarity_trig
    from perfbench.reference.pairs import cell_pairs
    from yalla_tpu_torch.ops.common import augment
    from yalla_tpu_torch.polarity import polarity_precompute
    ex = importlib.import_module(MODULE)
    before = run[0][3 * (PART_STEPS + 1)][1]
    X = ex.Cell(**before["X"])
    n = before["n"]
    i, j, dist = cell_pairs(X.x, X.y, X.z, n, 1.0)
    assert i.numel() > 5 * n
    Xa = augment(X, n, polarity_precompute)
    Xi = type(Xa)(*(a[i] for a in Xa))
    Xj = type(Xa)(*(a[j] for a in Xa))
    dF, aux = ex.force(Xi, Xi - Xj, dist, i, j)
    X_ref = dict(before["X"])
    terms, epi, mes = ref.pair_terms(X_ref, polarity_trig(X_ref), i, j,
                                     dist, ref.Params())
    assert torch.equal(aux["epi_nbs"], epi)
    assert torch.equal(aux["mes_nbs"], mes)
    both = (Xi.ctype == 1) & (Xj.ctype == 1)
    takes = (Xi.ctype == 0) & (Xi.w > 0)
    assert int(both.sum()) > 100 and int(takes.sum()) > 100
    for f in ("x", "y", "z", "w", "theta", "phi"):
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


@pytest.mark.parametrize("name", ["reference/model_features.py",
                                  "roofline_mfsa.py"])
def test_mfsa_reference_imports_nothing_of_the_program(name):
    assert not set(imports_of(REPO / "perfbench" / name)) & PROGRAM
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            f"import perfbench.{name[:-3].replace('/', '.')}; "
            "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    loaded = set(subprocess.run(
        [sys.executable, "-c", code], check=True, capture_output=True,
        text=True).stdout.split())
    assert not loaded & PROGRAM
