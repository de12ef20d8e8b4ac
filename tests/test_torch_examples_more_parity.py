"""The port's last ten example models against the JAX package's
``examples/*.py`` on the CPU: from one initial state, one to five steps
of each model in each package, every field within the reference's
``isclose`` (atol 1e-6 + rtol 1e-2, ``tests/helpers.py``; old_v within
atol 1e-5 + rtol 1e-2) and every count, link and lineage entry equal.

The state is the port's ``setup`` on the CPU (its numpy generators
seeded), copied into a JAX ``Solution`` of the example's point type,
rows and engine settings, and carried from there into a port
``Solution`` by ``interop.solution_from``: both packages start from the
same numbers.  Each step is the JAX example's loop body, called in both
packages, with the JAX key's draws injected into the port: the protrusion
rewiring's (``links.Draws`` for the grid-sampled rules, the rules' tuples
of uniforms for sorting_prot and intercalation) and the divisions'
(``growth.Draws``).  intercalation_w_gradient's JAX step is the
example's step fused under ``jax.jit``, the port's its ``step``: the same
calls made eagerly.

lineage_tracing divides at its published rate only after step 100 and
then rarely among 5 cells; its steps here run at a rate of 0.5 in both
packages (a module constant set in both), so that the lineage records
divisions.  The teapot's cut is the mesh test of ``test_torch_mesh.py``
applied to the example's points; write_vtk_w_mask writes the same bytes
as the JAX example.
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from test_torch_growth import jax_draws as growth_draws
from test_torch_links import jax_draws as cube_draws
from yalla_tpu import Solution as JSolution
from yalla_tpu import dtypes as jdt
from yalla_tpu.growth import lineage_init as j_lineage_init
from yalla_tpu.growth import proliferate as j_proliferate
from yalla_tpu.growth import record_divisions as j_record_divisions
from yalla_tpu.links import Links as JLinks
from yalla_tpu.links import link_forces as j_link_forces
from yalla_tpu.links import link_wall_forces as j_link_wall_forces
from yalla_tpu.links import wall_forces as j_wall_forces
from yalla_tpu.mesh import Mesh as JMesh
from yalla_tpu.ops.common import friction_on_background as j_background
from yalla_tpu.polarity import polarity_precompute as j_precompute
from yalla_tpu.solvers import GabrielEngine as JGabrielEngine
from yalla_tpu_torch import inits
from yalla_tpu_torch.interop import links_from, solution_from

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

torch.set_num_threads(2)

# a cell whose |sin theta| is below this sits on a pole of its polarity,
# where phi is undefined and its bending term divides by sin theta
POLE_SINE = 1e-6
# old_v, the mean velocity of a step's two passes, is a sum of terms of
# order 0.1 that can cancel to 1e-5: it is held to this atol (and the
# rtol 1e-2 of isclose)
OLD_V_ATOL = 1e-5


def _modules(name, **overrides):
    """(the port's example module, the JAX package's), re-evaluated, the
    same constants set in both."""
    tm = importlib.reload(
        importlib.import_module(f"yalla_tpu_torch.examples.{name}"))
    jm = importlib.reload(importlib.import_module(name))
    for k, v in overrides.items():
        setattr(tm, k, v)
        setattr(jm, k, v)
    return tm, jm


def _carry(tsol, **solution_kwargs):
    """(a JAX ``Solution`` with ``solution_kwargs`` holding the port
    Solution's state, active count and old_v included; the port Solution
    carried back from it by ``solution_from``)."""
    h = tsol.copy_to_host()
    Pt = jdt.make_pt(tsol.pt_type.__name__, *tsol.pt_type._fields[3:])
    js = JSolution(Pt, tsol.n_max, n_pad=tsol.n_pad, **solution_kwargs)
    for f in Pt._fields:
        getattr(js.h_X, f)[:] = getattr(h, f)
    js.h_n = tsol.get_d_n()
    js.copy_to_device()
    js.d_old_v = jdt.Float3(*(jnp.asarray(a.numpy()) for a in tsol.d_old_v))
    ts = solution_from(js, device="cpu")
    for f in ts.pt_type._fields:
        np.testing.assert_array_equal(getattr(ts.h_X, f), getattr(h, f))
    return js, ts


def _carry_links(tlinks_n, n_max, strength, jseed):
    """(a JAX ``Links`` seeded ``jseed`` with ``tlinks_n`` active rows, the
    port's carried from it)."""
    jl = JLinks(n_max, strength, seed=jseed)
    jl.set_d_n(tlinks_n)
    return jl, links_from(jl, device="cpu")


def _next_key(jlinks):
    """The key ``jlinks.update`` will use next."""
    return jax.random.split(jlinks.key)[1]


def _uniforms(key, count, m):
    """The ``count`` uniforms of ``m`` rows a JAX rule draws from ``key``
    (split in ``count`` when more than one), as the port's tuple."""
    keys = jax.random.split(key, count) if count > 1 else [key]
    return tuple(torch.as_tensor(np.array(jax.random.uniform(k, (m,))))
                 for k in keys)


def _same_links(jl, tl):
    np.testing.assert_array_equal(np.asarray(jl.d_a), tl.d_a.numpy())
    np.testing.assert_array_equal(np.asarray(jl.d_b), tl.d_b.numpy())


def _same_state(js, ts, skip_poles=False):
    """Equal counts; every field of every active cell within ``isclose``
    (phi left out on a pole cell where ``skip_poles``); the state moved
    from nothing is not asked."""
    n = ts.get_d_n()
    assert n == int(js.d_n)
    jh, th = js.copy_to_host(), ts.copy_to_host()
    for f in ts.pt_type._fields:
        a, b = getattr(th, f)[:n], getattr(jh, f)[:n]
        keep = np.ones(n, bool)
        if skip_poles and f == "phi":
            keep = np.abs(np.sin(th.theta[:n].astype(np.float64))) \
                >= POLE_SINE
        assert np.isfinite(a).all(), f
        assert isclose(a[keep], b[keep]), \
            (f, float(np.abs(a - b)[keep].max()))
    for a, b in zip(ts.d_old_v, js.d_old_v):
        a, b = a.numpy()[:n], np.asarray(b)[:n]
        assert (np.abs(a - b) <= OLD_V_ATOL + 1e-2 * np.abs(b)).all(), \
            float(np.abs(a - b).max())


def _proliferate_both(jm, tm, js, ts, key, props_j, props_t):
    """One division pass of the example's want_fn and child_fn in both
    packages, the JAX key's draws injected into the port.  Returns the
    port's DivisionInfo and the JAX one."""
    js.d_X, js.d_old_v, js.d_n, _, jinfo = j_proliferate(
        jm.want_fn, jm.child_fn, js.d_X, js.d_old_v, js.d_n, key,
        props=props_j)
    ts.d_X, ts.d_old_v, ts.d_n, _, tinfo = tm.proliferate(
        tm.want_fn, tm.child_fn, ts.d_X, ts.d_old_v, ts.d_n,
        props=props_t, draws=growth_draws(key, ts.n_pad))
    assert tinfo.n_divided == int(jinfo.n_divided)
    np.testing.assert_array_equal(tinfo.ok.numpy(), np.asarray(jinfo.ok))
    return tinfo, jinfo


def _seeded_setup(tm, seed=0, **kw):
    inits.set_seed(seed)
    return tm.setup("cpu", **kw)


def test_sorting_matches_jax():
    tm, jm = _modules("sorting")
    js, ts = _carry(_seeded_setup(tm), solver="grid")
    for _ in range(3):
        js.take_step(jm.dt, jm.differential_adhesion)
        ts.take_step(tm.dt, tm.differential_adhesion)
    _same_state(js, ts)


@pytest.mark.parametrize("name", ["sorting_prot", "intercalation"])
def test_protrusion_rewiring_matches_jax(name):
    """Two steps of rewiring (the JAX rule's uniforms injected: links
    equal) and a Heun step with the link forces (the state within
    isclose), from a state whose links were set by a first rewiring."""
    tm, jm = _modules(name)
    # intercalation's row_cap is the JAX example's, sorting_prot's the
    # port's (the JAX example's default overflows; the module says why)
    kw = {"solver": "grid", "row_cap": 64}
    if name == "intercalation":
        n_links, count = tm.n_cells * tm.prots_per_cell, 1
    else:
        n_links, count = tm.n_protrusions, 3
    js, ts = _carry(_seeded_setup(tm), **kw)
    jl, tl = _carry_links(n_links, n_links, 1.0 / 5, jseed=3)
    for _ in range(2):
        draws = _uniforms(_next_key(jl), count, jl.n_pad)
        jl.update(jm.update_protrusions, js)
        tl.update(tm.update_protrusions, ts, draws=draws)
        _same_links(jl, tl)
        js.take_step(jm.dt, jm.clipped_cubic, gen_forces=j_link_forces(jl))
        ts.take_step(tm.dt, tm.clipped_cubic,
                     gen_forces=tm.link_forces(tl))
    assert int((tl.d_a != tl.d_b).sum()) > 0
    _same_state(js, ts)


def test_passive_growth_matches_jax():
    """From the transitioned ball (the port's ``setup``: the relaxation,
    a first step and the surface made epithelium), two steps at t = 101
    and 102 (the mesenchyme dividing at ``prolif_rate``, the epithelium
    where it has no more epithelial than mesenchymal neighbours), the
    JAX key's division draws injected."""
    tm, jm = _modules("passive_growth", n_0=100, n_max=400)
    start = _seeded_setup(tm)
    js, ts = _carry(start, solver="grid")
    assert 0 < int((start.h_X.ctype == 1).sum()) < tm.n_0
    key = jax.random.PRNGKey(13)
    divided = 0
    for t in (101, 102):
        jaux = js.take_step(jm.dt, jm.relu_w_epithelium)
        taux = ts.take_step(tm.dt, tm.relu_w_epithelium)
        for k in ("mes_nbs", "epi_nbs"):
            np.testing.assert_array_equal(taux[k].numpy(),
                                          np.asarray(jaux[k]))
        key, sub = jax.random.split(key)
        rate = jm.prolif_rate * (t > 100)
        tinfo, _ = _proliferate_both(
            jm, tm, js, ts, sub,
            (jnp.float32(rate), jaux["mes_nbs"], jaux["epi_nbs"]),
            (rate, taux["mes_nbs"], taux["epi_nbs"]))
        divided += tinfo.n_divided
    assert divided > 0
    _same_state(js, ts, skip_poles=True)


def test_lineage_tracing_matches_jax():
    """Three steps with divisions recorded (at rate 0.5 in both packages),
    the lineages equal entry for entry, and the tree the port assembles
    equal to the JAX example's assembly of the JAX lineage."""
    tm, jm = _modules("lineage_tracing", n_max=200, prolif_rate=0.5)
    js, ts = _carry(_seeded_setup(tm), solver="grid")
    jlin = j_lineage_init(2 * js.n_pad, js.n_pad, tm.n_0)
    n_steps = 200
    state = tm.start(ts, n_steps)
    state.t = 101
    key = jax.random.PRNGKey(21)
    for t in (101, 102, 103):
        js.take_step(jm.dt, jm.relaxation_force)
        key, sub = jax.random.split(key)
        js.d_X, js.d_old_v, js.d_n, _, jinfo = j_proliferate(
            jm.want_fn, jm.child_fn, js.d_X, js.d_old_v, js.d_n, sub,
            props=(jnp.float32(jm.prolif_rate * (t > 100)),))
        jlin = j_record_divisions(jlin, jinfo, js.d_X,
                                  jnp.zeros(js.n_pad, jnp.int32),
                                  t / n_steps)
        tm.step(ts, state, growth_draws(sub, ts.n_pad))
    tlin = state.lin
    assert state.t == 104
    assert tlin.n_nodes == int(jlin.n_nodes) > 0
    for f in tlin._fields[1:]:
        a, b = getattr(tlin, f).numpy(), np.asarray(getattr(jlin, f))
        if a.dtype.kind == "f":
            assert isclose(a, b), f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    _same_state(js, ts)
    # the tree: nodes then leaves, each linked to its parent node
    points, branches, node_clone = tm.tree(ts, tlin)
    n_tree, m = tlin.n_nodes, ts.get_d_n()
    assert points.h_n == branches.h_n == n_tree + m
    nparent = np.asarray(jlin.node_parent)[:n_tree]
    cparent = np.asarray(jlin.cell_parent)[:m]
    want_a = np.concatenate([np.where(nparent >= 0, np.arange(n_tree), 0),
                             np.where(cparent >= 0,
                                      n_tree + np.arange(m), 0)])
    want_b = np.concatenate([np.where(nparent >= 0, nparent, 0),
                             np.where(cparent >= 0, cparent, 0)])
    np.testing.assert_array_equal(branches.h_a[:n_tree + m], want_a)
    np.testing.assert_array_equal(branches.h_b[:n_tree + m], want_b)
    np.testing.assert_array_equal(
        node_clone.h_prop[:n_tree + m],
        np.concatenate([np.asarray(jlin.node_clone)[:n_tree],
                        np.asarray(jlin.cell_clone)[:m]]))
    jh = js.copy_to_host()
    assert isclose(points.h_X.x[:n_tree + m],
                   np.concatenate([np.asarray(jlin.node_x)[:n_tree],
                                   jh.x[:m]]))


def test_model_features_sequential_addition_matches_jax():
    """One step of each part, as the JAX example's loop makes it: part 1
    against the background, the surface made epithelium, part 2, the
    source, part 3, part 4 with divisions and part 5 with its protrusions
    (the JAX draws injected into both)."""
    tm, jm = _modules("model_features_sequential_addition")
    js, ts = _carry(_seeded_setup(tm), solver="grid", grid_size=50)
    pre_j, pre_t = j_precompute, tm.polarity_precompute
    # part 1
    jaux = js.take_step(jm.dt, jm.force, pw_friction=j_background,
                        precompute=pre_j)
    taux = ts.take_step(tm.dt, tm.force,
                        pw_friction=tm.friction_on_background,
                        precompute=pre_t)
    np.testing.assert_array_equal(taux["mes_nbs"].numpy(),
                                  np.asarray(jaux["mes_nbs"]))
    # part 2: the JAX example's transition, on both
    tm.make_epithelium(ts, taux["mes_nbs"])
    h = js.copy_to_host()
    mes = np.asarray(jaux["mes_nbs"])
    surf = (mes < 20) & (np.arange(js.n_pad) < jm.n_0)
    d = np.maximum(np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2), 1e-6)
    h.ctype[surf] = jm.EPITHELIUM
    h.theta[surf] = np.arccos(np.clip(h.z / d, -1, 1))[surf]
    h.phi[surf] = np.arctan2(h.y, h.x)[surf]
    js.copy_to_device()
    assert 0 < surf.sum() < jm.n_0
    js.take_step(jm.dt, jm.force, precompute=pre_j)
    ts.take_step(tm.dt, tm.force, precompute=pre_t)
    # part 3
    tm.add_source(ts)
    h = js.copy_to_host()
    h.w[(h.x > 1.0) & (np.arange(js.n_pad) < js.h_n)] = 1.0
    js.copy_to_device()
    js.take_step(jm.dt, jm.force, precompute=pre_j)
    ts.take_step(tm.dt, tm.force, precompute=pre_t)
    # part 4
    key = jax.random.split(jax.random.PRNGKey(16))[1]
    jaux = js.take_step(jm.dt, jm.force, precompute=pre_j)
    js.d_X, js.d_old_v, js.d_n, _, jinfo = j_proliferate(
        jm.want_fn, jm.child_fn, js.d_X, js.d_old_v, js.d_n, key,
        props=(jaux["epi_nbs"], jaux["mes_nbs"]))
    tm.proliferation_step(ts, draws=growth_draws(key, ts.n_pad))
    assert int(jinfo.n_divided) > 0
    # part 5
    jl = JLinks(jm.n_max * jm.prots_per_cell, jm.protrusion_strength,
                seed=16)
    tl = links_from(jl, device="cpu")
    jl.set_d_n(min(int(js.d_n) * jm.prots_per_cell, jl.n_max))
    draws = cube_draws(_next_key(jl), jl.n_pad)
    jl.update(jm.update_protrusions, js)
    js.take_step(jm.dt, jm.force, gen_forces=j_link_forces(jl),
                 precompute=pre_j)
    tm.intercalation_step(ts, tl, draws=draws)
    _same_links(jl, tl)
    assert int((tl.d_a != tl.d_b).sum()) > 0
    _same_state(js, ts, skip_poles=True)


def test_growth_w_wall_matches_jax():
    """From the seed ball (wall node and ball above it), two steps of the
    relaxation on the gather Gabriel engine with the wall force, then two
    growth steps (rewiring, the Heun step with the wall and the links,
    divisions), the JAX draws injected."""
    tm, jm = _modules("growth_w_wall", n_0=100, n_max=400)
    start = tm.seed_ball("cpu")
    relax_engine = JGabrielEngine(grid_size=64, row_cap=128, lattice=False)
    jr, tr = _carry(start, engine=relax_engine)
    assert type(tr.engine).__name__ == "GabrielEngine" \
        and tr.engine.lattice is False
    for _ in range(2):
        jr.take_step(jm.dt, jm.relu_force, pw_friction=j_background,
                     gen_forces=j_wall_forces(jm.WALL))
        tr.take_step(tm.dt, tm.relu_force,
                     pw_friction=tm.friction_on_background,
                     gen_forces=tm.wall_forces(tm.WALL))
    _same_state(jr, tr)
    js, ts = _carry(tr, solver="gabriel", grid_size=64, row_cap=64)
    jl = JLinks(jm.n_max, jm.protrusion_strength, seed=15)
    state = tm.start(ts)
    state.links = tl = links_from(jl, device="cpu")
    key = jax.random.PRNGKey(15)
    for _ in range(2):
        n = int(js.d_n)
        jl.set_d_n(min(n * jm.prots_per_cell, jl.n_max))
        tl.set_d_n(min(n * tm.prots_per_cell, tl.n_max))
        link_draws = cube_draws(_next_key(jl), jl.n_pad)
        jl.update(jm.update_protrusions_wall, js)
        js.take_step(jm.dt, jm.relu_force, pw_friction=jm.wall_friction,
                     gen_forces=j_link_wall_forces(jl, jm.WALL))
        key, sub = jax.random.split(key)
        js.d_X, js.d_old_v, js.d_n, _, _ = j_proliferate(
            jm.want_fn, jm.child_fn, js.d_X, js.d_old_v, js.d_n, sub)
        tm.step(ts, state, (link_draws, growth_draws(sub, ts.n_pad)))
        _same_links(jl, tl)
    _same_state(js, ts)


def test_intercalation_w_gradient_matches_jax():
    """One step of the 11,557-cell embryo from ``sphere_ic.vtk`` on the
    lattice engine ``solver="auto"`` picks (151,552 rows): the rewiring,
    the Heun step with the link forces and the polarity precompute, and
    the divisions of the epithelium, as the JAX example's fused step
    computes them, with its draws injected.  Links, the neighbour counts,
    the divisions and the flags equal; the fields within isclose (phi
    left out on pole cells)."""
    tm, jm = _modules("intercalation_w_gradient")
    ts0 = tm.setup("cpu")
    # the JAX example's own setup, as its main makes it
    inp = jm.Vtk_input(os.path.join(jm.HERE, "sphere_ic.vtk"))
    n_0 = inp.n_points
    js = JSolution(jm.Cell, jm.n_max, solver="auto")
    js.h_n = n_0
    inp.read_positions(js)
    inp.read_polarity(js)
    intype = jm.Property(js.n_pad, "cell_type")
    inp.read_property(intype, "cell_type")
    h = js.h_X
    h.ctype[:n_0] = (intype.h_prop[:n_0] == 1).astype(np.float32)
    epi_top = (h.ctype == 1.0) & (h.z > 0)
    h.w[epi_top] = 1.0
    h.f[epi_top & (h.x > 0) & (np.abs(h.y) < 2.5) & (h.z < 3.0)] = 1.0
    js.copy_to_device()
    js._ensure_device()
    for f in tm.Cell._fields:   # the two setups agree
        np.testing.assert_array_equal(getattr(ts0.h_X, f),
                                      getattr(js.h_X, f))
    ts = solution_from(js, device="cpu")
    ts._ensure_device()
    assert (ts.engine.grid_size, ts.engine.capacity) == \
        (js.engine.grid_size, js.engine.capacity)
    assert ts.n_pad == 151_552 and ts.get_d_n() == n_0 == 11_557

    # the JAX example's fused step, unfused
    from yalla_tpu.links import _link_gen_fn, linear_force
    from yalla_tpu.ops.common import friction_w_neighbour
    from yalla_tpu.solvers import GenericForce, heun_step
    gen_static = GenericForce(fn=_link_gen_fn(linear_force),
                              fields=("x", "y", "z"))
    update_j = jm.make_update_protrusions(js.n_pad)
    jl = JLinks(jm.n_max * jm.prots_per_cell, jm.protrusion_strength, seed=9)
    state = tm.start(ts)
    state.links = tl = links_from(jl, device="cpu")
    key = jax.random.split(jax.random.PRNGKey(9))[1]
    k1, k2 = jax.random.split(key)

    @jax.jit
    def fused_step(X, old_v, n, a, b):
        n_links = jnp.minimum(n * jm.prots_per_cell, a.shape[0])
        live = jnp.arange(a.shape[0], dtype=jnp.int32) < n_links
        a2, b2 = update_j(a, b, X, n, k1)
        a, b = jnp.where(live, a2, a), jnp.where(live, b2, b)
        X, old_v, aux = heun_step(
            js.engine, jm.force, friction_w_neighbour, gen_static, "com",
            X, old_v, n, jnp.float32(jm.dt), jnp.float32(jm.r_max),
            jnp.int32(0),
            (a, b, n_links, jnp.float32(jm.protrusion_strength)),
            j_precompute)
        X, old_v, n, _, info = j_proliferate(
            jm.want_fn, jm.child_fn, X, old_v, n, k2,
            props=(aux["epi_nbs"], aux["mes_nbs"]))
        return X, old_v, n, a, b, aux, info.n_divided
    (js.d_X, js.d_old_v, js.d_n, jl.d_a, jl.d_b, jaux,
     n_divided) = fused_step(js.d_X, js.d_old_v, js.d_n, jl.d_a, jl.d_b)

    taux = tm.step(ts, state, (cube_draws(k1, tl.n_pad),
                               growth_draws(k2, ts.n_pad)))
    _same_links(jl, tl)
    assert int((tl.d_a != tl.d_b).sum()) > 0
    for k in ("epi_nbs", "mes_nbs"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    for k, v in jaux.items():
        if k.startswith("__err_"):
            assert float(np.max(np.asarray(v))) == 0.0, k
    assert 0 < ts.get_d_n() - n_0 == int(n_divided)
    _same_state(js, ts, skip_poles=True)


def test_teapot_cut_matches_jax():
    """The example's 4,000 points (its seeded cuboid), cut by the port's
    mesh and by the JAX package's: the same points kept, in order."""
    tm, _ = _modules("teapot")
    points, mesh = _seeded_setup(tm, n=4000)
    m = points.h_n
    pts = np.stack([points.h_X.x[:m], points.h_X.y[:m],
                    points.h_X.z[:m]], 1).astype(np.float64)
    outside = JMesh(str(tm.MESH_PATH)).test_exclusion_many(pts)
    kept = tm.cut(points, mesh)
    assert 0 < kept == int((~outside).sum()) < m
    np.testing.assert_array_equal(points.d_X.x[:kept].numpy(),
                                  pts[~outside, 0].astype(np.float32))


def test_write_vtk_w_mask_writes_the_jax_bytes(tmp_path, monkeypatch):
    tm, jm = _modules("write_vtk_w_mask")
    files = {}
    for tag, run in (("port", lambda: tm.main(device="cpu")),
                     ("jax", jm.main)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        run()
        import gc
        gc.collect()   # the JAX example leaves its writer to close
        files[tag] = sorted((d / "output").glob("test_vtk_*.vtk"))
    assert [p.name for p in files["port"]] == [p.name for p in files["jax"]]
    for a, b in zip(files["port"], files["jax"]):
        assert a.read_bytes() == b.read_bytes()
