"""The emergent statistics of ``tests/test_physics_stats.py`` on the port's
models, on the CPU, each beside the JAX package's on the same seeded
initial state: differential-adhesion sorting, a Turing pattern emerging,
the branching model's engines agreeing, epithelium polarity,
intercalation elongation.

Same sizes, steps, seeds of the initial conditions and thresholds as the
JAX tests; the port's value must reach JAX's threshold and sit beside
JAX's value:

* Turing and epithelium polarity: within ``isclose`` (atol 1e-6 + rtol
  1e-2, ``tests/helpers.py``);
* sorting: the separation within ``BAND`` (10 %) of JAX's -- the two
  packages sum the neighbours in another order, and 300 steps carry that
  f32 rounding into the positions;
* intercalation: the aspect ratio within ``BAND`` of JAX's -- the
  protrusions draw from each package's own generator, so the two runs
  are two samples of one statistic;
* the engine agreement: the port's ``GridEngine`` and its
  ``lattice_heun_steps`` (rebuilt per pass) against each other with JAX's
  tolerance (atol 1e-4 + rtol 1e-3, aux counts equal), and each against
  JAX's ``heun_steps`` on ``GridEngine`` and JAX's ``lattice_heun_steps``
  (its default XLA route) from the same state within the same tolerance.
"""
import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
from helpers import isclose

import yalla_tpu
import yalla_tpu.inits
import yalla_tpu.links
import yalla_tpu_torch
import yalla_tpu_torch.inits
import yalla_tpu_torch.links
from test_physics_stats import differential_adhesion as j_adhesion
from yalla_tpu_torch import Float3

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
r_max = 1.0
r_min = 0.5
n_cells = 100
BAND = 0.1


def differential_adhesion(Xi, r, dist, i, j):
    """ref examples/sorting.cu:17-29 (type = index < n/2)."""
    valid = (i != j) & (dist <= r_max)
    strength = (1 + 2 * (j < n_cells // 2)) * (1 + 2 * (i < n_cells // 2))
    F = 2 * (r_min - dist) * (r_max - dist) + (r_max - dist) ** 2
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(valid, strength * F / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


# each package: its package, inits, the keywords of a CPU Solution, and
# its example module of a name (the JAX ones loaded fresh from
# examples/, so their constants are the literal reference config)
PKGS = {"jax": (yalla_tpu, yalla_tpu.inits, {}),
        "port": (yalla_tpu_torch, yalla_tpu_torch.inits, {"device": "cpu"})}


def example(pkg, name):
    if pkg == "port":
        return importlib.reload(
            importlib.import_module(f"yalla_tpu_torch.examples.{name}"))
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _radii(h, n):
    com = np.array([h.x[:n].mean(), h.y[:n].mean(), h.z[:n].mean()])
    return np.sqrt((h.x[:n] - com[0]) ** 2 + (h.y[:n] - com[1]) ** 2
                   + (h.z[:n] - com[2]) ** 2)


def sorting(pkg):
    """(separation at t0, separation, sticky radius, loose radius)."""
    lib, inits, kw = PKGS[pkg]
    cells = lib.Solution(lib.Float3, n_cells, solver="grid", **kw)
    inits.random_sphere(r_min, cells, rng=np.random.default_rng(2718))
    r0 = _radii(cells.copy_to_host(), n_cells)
    sep0 = r0[n_cells // 2:].mean() - r0[:n_cells // 2].mean()
    force = differential_adhesion if pkg == "port" else j_adhesion
    cells.take_steps(300, 0.05, force)
    r = _radii(cells.copy_to_host(), n_cells)
    sticky, loose = r[:n_cells // 2].mean(), r[n_cells // 2:].mean()
    return sep0, loose - sticky, sticky, loose


def test_port_sorting_statistics():
    """After 300 steps the sticky half sits significantly closer to the
    centre of mass than the loose half (cell sorting), as in JAX."""
    sep0, sep, sticky, loose = sorting("port")
    assert sep > 0.15 and sep > sep0 + 0.05, \
        f"no sorting: sticky {sticky:.2f} vs loose {loose:.2f} (t0 {sep0:.2f})"
    j_sep0, j_sep = sorting("jax")[:2]
    assert sep0 == j_sep0
    assert abs(sep - j_sep) <= BAND * j_sep, \
        f"separation {sep:.4f}, JAX's {j_sep:.4f}"


def turing(pkg):
    """(u at t0, u after 2,000 steps) of 200 cells."""
    lib, inits, kw = PKGS[pkg]
    t = example(pkg, "turing")
    rng = np.random.default_rng(5)
    cells = lib.Solution(t.Epi_cell, 200, solver="grid", **kw)
    cells.h_X.theta[:200] = np.pi / 2
    cells.h_X.u[:200] = rng.random(200) / 5 - 0.1
    cells.h_X.v[:200] = rng.random(200) / 5 - 0.1
    inits.random_disk(0.5, cells, rng=np.random.default_rng(2719))
    u0 = np.array(cells.copy_to_host().u[:200])
    cells.take_steps(2000, t.dt, t.epithelium_w_turing)
    return u0, cells.copy_to_host().u[:200]


def test_port_turing_pattern_emerges():
    """Meinhardt kinetics amplify noise into high-contrast u spots
    (ref examples/turing.cu), 2,000 steps of 200 cells; the peak and the
    contrast within ``isclose`` of JAX's."""
    u0, u = turing("port")
    assert np.isfinite(u).all()
    assert u.max() > 1.0, f"no activator peaks: max u = {u.max():.3f}"
    assert u.std() > 10 * max(u0.std(), 1e-3), "no contrast amplification"
    _, ju = turing("jax")
    assert isclose(u.max(), ju.max()), (u.max(), ju.max())
    assert isclose(u.std(), ju.std()), (u.std(), ju.std())


def test_port_branching_engines_agree():
    """Flagship force: the gather grid and the dense lattice (rebuilt per
    pass) produce the same 3-step trajectory, aux counts included, and
    each the trajectory of its JAX counterpart from the same state."""
    from test_torch_common import jax_pt

    from yalla_tpu.models import branching as JB
    from yalla_tpu.ops.common import friction_w_neighbour as j_friction
    from yalla_tpu.ops.lattice_xla import lattice_heun_steps as j_lattice
    from yalla_tpu.polarity import polarity_precompute as j_pre
    from yalla_tpu.solvers import GridEngine as JGridEngine
    from yalla_tpu.solvers import heun_steps as j_heun
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_xla import lattice_heun_steps
    from yalla_tpu_torch.polarity import polarity_precompute
    from yalla_tpu_torch.solvers import GridEngine, heun_steps

    p = B.Params()
    state, _, _ = B.init_state(100, 120, p,
                               engine=GridEngine(grid_size=16, row_cap=64),
                               seed=8, device="cpu")
    force = B.make_force(p)
    X0, ov0, n = state.X, state.old_v, state.n

    Xg, _, auxg = heun_steps(
        3, GridEngine(grid_size=16, row_cap=64), force, friction_w_neighbour,
        "com", X0, ov0, n, p.dt, p.r_max, 0, polarity_precompute)
    Xl, _, auxl = lattice_heun_steps(
        3, 1, force, friction_w_neighbour, "com", 16, 16, 4, X0, ov0, n,
        p.dt, p.r_max, 0, polarity_precompute)

    jp = JB.Params()
    jforce = JB.make_force(jp)
    jX0 = jax_pt(JB.Cell, {f: getattr(X0, f).numpy()
                           for f in JB.Cell._fields})
    jov0 = jax_pt(yalla_tpu.Float3, {f: getattr(ov0, f).numpy()
                                     for f in "xyz"})
    jargs = (jnp.float32(jp.dt), jnp.float32(jp.r_max), jnp.int32(0))
    jXg, _, jauxg = j_heun(
        3, JGridEngine(grid_size=16, row_cap=64), jforce, j_friction, None,
        "com", jX0, jov0, jnp.int32(n), *jargs, None, j_pre)
    jXl, _, jauxl = j_lattice(
        3, 1, jforce, j_friction, "com", 16, 16, 4, jX0, jov0,
        jnp.int32(n), *jargs, j_pre)

    runs = {"grid": (Xg, auxg), "lattice": (Xl, auxl),
            "JAX grid": (jXg, jauxg), "JAX lattice": (jXl, jauxl)}
    for a, b in (("grid", "lattice"), ("grid", "JAX grid"),
                 ("lattice", "JAX lattice")):
        (Xa, auxa), (Xb, auxb) = runs[a], runs[b]
        for f in ("x", "u", "v", "theta"):
            fa = np.asarray(getattr(Xa, f))[:n]
            fb = np.asarray(getattr(Xb, f))[:n]
            assert np.allclose(fa, fb, atol=1e-4, rtol=1e-3), \
                f"{a} and {b} disagree in {f}: {np.abs(fa - fb).max()}"
        assert np.array_equal(np.asarray(auxa["epi_nbs"])[:n],
                              np.asarray(auxb["epi_nbs"])[:n]), \
            f"{a} and {b}: aux disagrees"
    for k in auxl:
        if k.startswith("__err_"):
            assert float(auxl[k].max()) == 0.0, k


def polarity(pkg):
    """((radial alignment, shell spread) at t0, the same after 100
    steps) on a relaxed ball of 250 cells with noisy radial polarity."""
    lib, inits, kw = PKGS[pkg]
    E = example(pkg, "epithelium")
    rng = np.random.default_rng(2)
    cells = lib.Solution(lib.Po_cell, 250, solver="grid", **kw)
    inits.relaxed_sphere(0.8, cells, rng=rng)
    h = cells.h_X
    d = np.sqrt(h.x ** 2 + h.y ** 2 + h.z ** 2)
    d = np.where(d > 0, d, 1.0)
    n = cells.h_n
    h.theta[:n] = (np.arccos(np.clip(h.z / d, -1, 1))
                   + rng.random(cells.n_pad) * 0.5)[:n]
    h.phi[:n] = (np.arctan2(h.y, h.x) + rng.random(cells.n_pad) * 0.5)[:n]
    cells.copy_to_device()

    def stats(c):
        hh = c.copy_to_host()
        m = c.h_n
        px = np.sin(hh.theta[:m]) * np.cos(hh.phi[:m])
        py = np.sin(hh.theta[:m]) * np.sin(hh.phi[:m])
        pz = np.cos(hh.theta[:m])
        r = np.stack([hh.x[:m], hh.y[:m], hh.z[:m]])
        r = r - r.mean(1, keepdims=True)
        rn = np.linalg.norm(r, axis=0)
        rn = np.where(rn > 0, rn, 1)
        radial_align = np.mean((px * r[0] + py * r[1] + pz * r[2]) / rn)
        return radial_align, rn.max() - rn.mean()

    before = stats(cells)
    cells.take_steps(100, 0.05, E.layer_force,
                     pw_friction=lib.friction_on_background)
    return before, stats(cells)


def test_port_epithelium_polarity_statistics():
    """ref examples/epithelium.cu: on a relaxed ball with noisy radial
    polarity, bending stiffness (a) relaxes every polarity to the local
    layer normal (radially outward) and (b) sharpens the ball into a
    shell; both statistics within ``isclose`` of JAX's."""
    (align0, spread0), (align1, spread1) = polarity("port")
    assert align1 > 0.98, f"polarity not radial: {align1:.3f}"
    assert align1 > align0 + 0.02, "noise did not relax"
    assert spread1 < spread0, "ball did not sharpen into a shell"
    _, (j_align1, j_spread1) = polarity("jax")
    assert isclose(align1, j_align1), (align1, j_align1)
    assert isclose(spread1, j_spread1), (spread1, j_spread1)


def intercalation(pkg):
    """(aspect ratio at t0, after 60 steps) of 500 cells with protrusion
    links."""
    lib, inits, kw = PKGS[pkg]
    I = example(pkg, "intercalation")
    cells = lib.Solution(lib.Float3, I.n_cells, solver="grid", row_cap=64,
                         **kw)
    inits.random_sphere(I.r_min, cells, rng=np.random.default_rng(4))
    prot = lib.links.Links(I.n_cells, seed=11, **kw)

    def aspect(c):
        hh = c.copy_to_host()
        m = c.h_n
        return hh.x[:m].std() / ((hh.y[:m].std() + hh.z[:m].std()) / 2)

    a0 = aspect(cells)
    for _ in range(60):
        prot.update(I.update_protrusions, cells)
        cells.take_step(I.dt, I.clipped_cubic,
                        gen_forces=lib.links.link_forces(prot))
    return a0, aspect(cells)


def test_port_intercalation_elongation_statistics():
    """ref examples/intercalation.cu: protrusion links constrained nearly
    perpendicular to x drive convergent extension -- the tissue elongates
    along x (60 steps of 500 cells), within ``BAND`` of JAX's."""
    a0, a1 = intercalation("port")
    assert a0 < 1.3, "initial ball not isotropic"
    assert a1 > 3.0, f"no convergent extension: aspect {a0:.2f} -> {a1:.2f}"
    j_a0, j_a1 = intercalation("jax")
    assert a0 == j_a0
    assert abs(a1 - j_a1) <= BAND * j_a1, f"aspect {a1:.3f}, JAX's {j_a1:.3f}"
