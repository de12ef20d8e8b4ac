"""The port's last ten example models (``yalla_tpu_torch/examples``) on
the CPU, mirroring ``tests/test_examples.py``'s cases of these models at
its reduced counts: each runs end to end through ``main`` and writes
ParaView-loadable VTK files (lineage_tracing its tree as well).

Beside them: every example is registered in ``examples.EXAMPLES`` and
defaults to the card; the ``intercalation_w_gradient`` functor's
``PAIR_FUNCTORS`` entry (the declaration the lattice kernel K1 runs the
force by on the card) against the torch force it stands for; the
protrusion rules' draws (``Links.draws``: the grid-sampled rules keep
growth_w_wall's stream, the others draw their uniforms); and
``utils.profiling``.  The states against the JAX package's are in
``test_torch_examples_more_parity.py``, the mesh in
``test_torch_mesh.py``.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

from yalla_tpu_torch import _build, inits
from yalla_tpu_torch.examples import EXAMPLES
from yalla_tpu_torch.links import Draws, Links, cube_draws
from yalla_tpu_torch.ops.common import friction_w_neighbour, \
    split_force_output
from yalla_tpu_torch.ops.functors import (PAIR_FUNCTORS, dF_type,
                                          param_array, unpack_sums)
from yalla_tpu_torch.polarity import polarity_precompute
from yalla_tpu_torch.solvers import augment
from yalla_tpu_torch.utils.profiling import StepTimer, trace

torch.set_num_threads(2)

# name: (module constants to override, main's keyword arguments, the VTK
# base names written), as in tests/test_examples.py, with the initial
# conditions' generator seeded
CASES = {
    "sorting": ({"n_time_steps": 5}, {}, ("sorting",)),
    "sorting_prot": ({"n_time_steps": 5}, {}, ("sorting_prot",)),
    "intercalation": ({"n_time_steps": 5}, {}, ("intercalation",)),
    "passive_growth": ({"n_0": 100, "n_max": 400}, {"n_steps": 4},
                       ("passive_growth",)),
    "lineage_tracing": ({"n_max": 500}, {"n_steps": 120},
                        ("lineage_tracing", "lineage_tree")),
    "model_features_sequential_addition": ({}, {"part_steps": 3},
                                           ("model_features_sequential_"
                                            "addition",)),
    "growth_w_wall": ({"n_0": 100, "n_max": 400}, {"n_steps": 4},
                      ("growth_w_wall",)),
    "intercalation_w_gradient": ({}, {"n_steps": 1},
                                 ("intercalation_w_gradient",)),
    "teapot": ({}, {"n": 4000}, ("teapot",)),
    "write_vtk_w_mask": ({}, {}, ("test_vtk",)),
}


def load(name, **overrides):
    """The port's example module, re-evaluated, with constants set."""
    mod = importlib.reload(
        importlib.import_module(f"yalla_tpu_torch.examples.{name}"))
    for k, v in overrides.items():
        setattr(mod, k, v)
    return mod


@pytest.fixture()
def outdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    inits.set_seed(0)
    return tmp_path


def _check_vtk(outdir, base):
    files = list((outdir / "output").glob(f"{base}_*.vtk"))
    assert files, f"no VTK output for {base}"
    head = files[0].read_text().splitlines()
    assert head[0].startswith("# vtk DataFile")
    assert any("POINTS" in line for line in head[:8])


@pytest.mark.parametrize("name", list(CASES))
def test_more_examples_write_vtk(name, outdir):
    overrides, kwargs, bases = CASES[name]
    load(name, **overrides).main(device="cpu", **kwargs)
    for base in bases:
        _check_vtk(outdir, base)


# the stepping examples at small sizes: name -> (module constants, the
# run's n_steps, the step index to start from)
STEPPING = {
    "sorting": ({}, 5, 0),
    "sorting_prot": ({}, 5, 0),
    "intercalation": ({}, 5, 0),
    "passive_growth": ({"n_0": 100, "n_max": 400}, 5, 101),
    "lineage_tracing": ({"n_max": 500, "prolif_rate": 0.5}, 200, 101),
    "model_features_sequential_addition": ({}, 3, 15),
    "growth_w_wall": ({"n_0": 100, "n_max": 400, "relax_steps": 2}, 5, 0),
    "intercalation_w_gradient": ({}, 1, 0),
}


@pytest.mark.parametrize("name", list(STEPPING))
def test_steps_take_the_draws_they_are_given(name):
    """``start``, ``draw`` and ``step`` (the shape every stepping example
    shares): two steps of two runs from one initial state, given the same
    draws from two generators seeded alike, end in the same state with
    ``t`` advanced by 2; the runs' own generators give the draws of a
    third run that steps without ``draws``."""
    overrides, n_steps, t0 = STEPPING[name]
    m = load(name, **overrides)
    ends = []
    for given in (True, True, False):
        inits.set_seed(0)
        cells = m.setup("cpu")
        state = m.start(cells, n_steps)
        state.t = t0
        g = torch.Generator().manual_seed(4)
        for _ in range(2):
            m.step(cells, state, m.draw(cells, state, g) if given else None)
        assert state.t == t0 + 2
        h = cells.copy_to_host()
        ends.append((cells.get_d_n(), h,
                     getattr(state, "links", None)))
    (n_a, a, la), (n_b, b, lb), (n_c, c, lc) = ends
    assert n_a == n_b and n_c >= 1
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f)[:n_a],
                                      getattr(b, f)[:n_b], err_msg=f)
        assert np.isfinite(getattr(c, f)[:n_c]).all(), f
    if la is not None:
        assert torch.equal(la.d_a, lb.d_a) and torch.equal(la.d_b, lb.d_b)


def test_every_example_is_registered_and_defaults_to_the_card():
    """``EXAMPLES`` names every example module of the JAX package's
    ``examples/``; ``setup`` and ``main`` of the ten take ``device`` and
    default to the card."""
    import pathlib
    here = pathlib.Path(__file__).resolve().parent.parent / "examples"
    assert set(EXAMPLES) == {p.stem for p in here.glob("*.py")}
    for name in CASES:
        m = load(name)
        for fn in (m.setup, m.main):
            assert inspect.signature(fn).parameters["device"].default \
                == "cuda", (name, fn)


def test_ic_file_missing_raises(tmp_path):
    m = load("intercalation_w_gradient")
    with pytest.raises(FileNotFoundError, match="sphere_ic.vtk"):
        m.setup("cpu", tmp_path / "none.vtk")
    t = load("teapot")
    with pytest.raises(FileNotFoundError, match="teapot.vtk"):
        t.setup("cpu", 100, tmp_path / "none.vtk")


def _pair_block(pt_type, g, n=64):
    """A block of pairs of random cells as the engines hand it to a force,
    the precompute channels added: Xi [n, 1], r = Xi - Xj [n, n], dist,
    ids.  Types 0/1, theta in (0, pi), w and f in [0, 1)."""
    def field(f):
        if f == "ctype":
            return g.integers(0, 2, n).astype(np.float32)
        if f == "theta":
            return g.uniform(0.05, 3.0, n).astype(np.float32)
        if f in ("w", "f"):
            return g.uniform(0, 1, n).astype(np.float32)
        return g.uniform(-1.0, 1.0, n).astype(np.float32)
    X = augment(pt_type(*(torch.as_tensor(field(f))
                          for f in pt_type._fields)), n, polarity_precompute)
    Xi = type(X)(*(a[:, None] for a in X))
    r = Xi - type(X)(*(a[None, :] for a in X))
    dist = torch.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    ids = torch.arange(n)
    return X, Xi, r, dist, ids[:, None], ids[None, :]


def test_intercalation_w_gradient_functor_entry_matches_force():
    m = load("intercalation_w_gradient")
    functor, params = m.force.cuda_functor
    spec = PAIR_FUNCTORS[functor]
    # the kernel entry exists, with the C signature of the branching one
    assert set(spec["entries"]) == {"lattice"}
    assert _build.SIGNATURES[spec["entries"]["lattice"]] \
        == _build.SIGNATURES["yalla_lattice_pair_branching"]
    assert spec["friction"] == friction_w_neighbour.cuda_friction
    # its fields: x y z w f ctype and the seven precompute channels (13,
    # 16 channels with old_v), no theta or phi
    AugT = type(augment(m.Cell(*([torch.zeros(1)] * 8)), 1,
                        polarity_precompute))
    assert spec["fields"] == ("x", "y", "z", "w", "f", "ctype", "px", "py",
                              "pz", "pcf", "psf", "pst", "psg")
    assert set(spec["fields"]) <= set(AugT._fields)
    # dF and aux by dF_type: the augmented type, the two neighbour counts
    d_type, aux = dF_type(m.force, AugT)
    assert set(aux) == set(spec["aux"]) == {"epi_nbs", "mes_nbs"}
    assert set(spec["dF"]) <= set(d_type._fields)
    assert len(spec["dF"]) + len(spec["aux"]) + 4 == 13
    assert list(param_array(spec, params)) == [m.r_max]
    # on a random pair block: the fields outside dF are zero, every dF
    # field moves, and unpack_sums puts the kernel's rows where the plain
    # sums are
    X, Xi, r, dist, i, j = _pair_block(m.Cell, np.random.default_rng(5))
    dF, aux_v = split_force_output(m.force(Xi, r, dist, i, j))
    for f in d_type._fields:
        moved = bool(getattr(dF, f).any())
        assert moved == (f in spec["dF"]), f
    rows = torch.stack([getattr(dF, f).sum(1) for f in spec["dF"]]
                       + [aux_v[a].sum(1) for a in spec["aux"]]
                       + [torch.zeros(len(X.x))] * 4)
    F, _, _, aux_k = unpack_sums(rows, spec, m.force, AugT)
    for f in d_type._fields:
        assert torch.equal(getattr(F, f), getattr(dF, f).sum(1)), f
    for a in spec["aux"]:
        assert torch.equal(aux_k[a], aux_v[a].sum(1)), a


def test_growth_w_wall_draws_stream_unchanged():
    """A rule without a draws factory (growth_w_wall's) gets a ``Draws``
    from ``cube_draws``: the cube, the pick and the noise, in that order
    from the generator, as ``Links.draws`` always drew them."""
    from yalla_tpu_torch.models import growth_w_wall as W
    links = Links(100, seed=7, device="cpu")
    got = links.draws(W.update_protrusions_wall)
    g = torch.Generator().manual_seed(7)
    want = Draws(torch.randint(0, 27, (links.n_pad,), generator=g),
                 torch.rand(links.n_pad, generator=g),
                 torch.rand(links.n_pad, generator=g))
    assert isinstance(got, Draws)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the next update's draws continue the same stream
    nxt = Links(100, seed=7, device="cpu")
    nxt.draws()
    again = nxt.draws(W.update_protrusions_wall)
    for a, b in zip(again, cube_draws(g, links.n_pad, "cpu")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,count", [("sorting_prot", 3),
                                        ("intercalation", 1)])
def test_rules_draw_their_uniforms(name, count):
    m = load(name)
    links = Links(50, seed=3, device="cpu")
    got = links.draws(m.update_protrusions)
    g = torch.Generator().manual_seed(3)
    assert len(got) == count
    for a in got:
        assert torch.equal(a, torch.rand(links.n_pad, generator=g))


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer(n_cells=10)
    a = torch.ones(100)
    with trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            a = a * 2
            timer.tick()
    assert prof is not None
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert timer.steps == 3 and timer.elapsed > 0
    assert "3 steps" in timer.report() and "cell-steps/s" in timer.report()
