"""Links and walls of the port against the JAX package.

Mirrors of ``tests/test_links.py`` (ref test_links.cu) and
``tests/test_walls.py`` on the port, with the same assertions and the
reference's ``isclose`` (atol 1e-6 + rtol 1e-2); the grid-sampled
protrusion proposals and the growth_w_wall rule with the JAX package's
``jax.random`` draws injected, which must give equal links, exactly.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers import center_of_mass, isclose
from yalla_tpu import Float3 as JFloat3
from yalla_tpu.links import Links as JLinks
from yalla_tpu.links import random_cube_neighbours as j_random_cube_nbs
from yalla_tpu_torch.dtypes import Float3, make_pt, pt_zeros_like
from yalla_tpu_torch.interop import links_from
from yalla_tpu_torch.links import (Draws, Links, link_forces,
                                   link_wall_forces, random_cube_neighbours,
                                   wall_forces)
from yalla_tpu_torch.models import growth_w_wall as W
from yalla_tpu_torch.ops.common import friction_on_background
from yalla_tpu_torch.solvers import Solution

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
Float4 = make_pt("Float4", "w")


def jax_example():
    """``examples/growth_w_wall.py`` as a module (the JAX model)."""
    spec = importlib.util.spec_from_file_location(
        "growth_w_wall_jax", REPO / "examples" / "growth_w_wall.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_draws(key, m):
    """The draws a JAX protrusion rule makes from ``key``
    (``examples/growth_w_wall.py:55-71`` with ``links.py:128-135``), as a
    port ``Draws``."""
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    return Draws(
        torch.as_tensor(np.array(jax.random.randint(ka, (m,), 0, 27)),
                        dtype=torch.int64),
        torch.as_tensor(np.array(jax.random.uniform(kb, (m,)))),
        torch.as_tensor(np.array(jax.random.uniform(k2, (m,)))))


def next_draws(jlinks):
    """The draws ``jlinks.update`` will make next."""
    return jax_draws(jax.random.split(jlinks.key)[1], jlinks.n_pad)


def no_pw(Xi, r, dist, i, j):
    return type(Xi)(*(torch.zeros_like(dist) for _ in Xi))


# ---- tests/test_links.py -------------------------------------------------

def test_square_of_four():
    pts = Solution(Float3, 4, solver="tile", device="cpu")
    links = Links(4, device="cpu")
    pts.h_X.x[:4] = [1, 1, -1, -1]
    pts.h_X.y[:4] = [1, -1, -1, 1]
    pts.h_X.z[:4] = 0
    pts.copy_to_device()
    links.h_a[:4] = [0, 1, 2, 3]
    links.h_b[:4] = [1, 2, 3, 0]
    links.copy_to_device()
    com_i = center_of_mass(pts)
    for _ in range(500):
        pts.take_step(0.1, no_pw, gen_forces=link_forces(links))
    h = pts.copy_to_host()
    com_f = center_of_mass(pts)
    assert all(isclose(a, b) for a, b in zip(com_i, com_f))
    assert isclose(h.x[0], h.x[1])
    assert isclose(h.y[1], h.y[2])
    assert isclose(h.z[2], h.z[3])


def custom_force(Xa, Xb, r, dist, strength):
    """Transfers w from a to b (ref test_links.cu custom_force)."""
    dFa = pt_zeros_like(Xa).replace(w=torch.full_like(dist, -1.0))
    dFb = pt_zeros_like(Xb).replace(w=torch.full_like(dist, 1.0))
    return dFa, dFb


def test_custom_force():
    pts = Solution(Float4, 2, solver="tile", device="cpu")
    links = Links(1, device="cpu")
    pts.h_X.x[:2] = [1, 1]
    pts.h_X.y[:2] = [1, -1]
    pts.h_X.z[:2] = 0
    pts.h_X.w[:2] = [1, -1]
    links.h_a[0], links.h_b[0] = 0, 1
    pts.copy_to_device()
    links.copy_to_device()
    dt = 0.1
    pts.take_step(dt, no_pw, gen_forces=link_forces(links))
    pts.take_step(dt, no_pw, gen_forces=link_forces(links, custom_force))
    h = pts.copy_to_host()
    assert isclose(h.x[0] - h.x[1], 0)
    assert isclose(h.y[0] - h.y[1], 2 - 2 * dt * links.strength)
    assert isclose(h.z[0] - h.z[1], 0)
    assert isclose(h.w[0] - h.w[1], 2 - 2 * dt)


# ---- tests/test_walls.py -------------------------------------------------

def test_wall_repels_cell():
    pts = Solution(Float3, 2, solver="tile", device="cpu")
    pts.h_X.z[0] = 0.0
    pts.h_X.z[1] = 0.3
    pts.copy_to_device()
    pts.set_fixed(0)
    for _ in range(200):
        pts.take_step(0.05, no_pw, pw_friction=friction_on_background,
                      gen_forces=wall_forces(0))
    h = pts.copy_to_host()
    assert isclose(h.z[1] - h.z[0], 0.8)


def test_wall_reaction_on_node():
    pts = Solution(Float3, 3, solver="tile", device="cpu")
    pts.h_X.z[:3] = [0.0, 0.3, 0.4]
    pts.copy_to_device()
    pts.set_fixed()
    pts.take_step(0.05, no_pw, pw_friction=friction_on_background,
                  gen_forces=wall_forces(0))
    h = pts.copy_to_host()
    assert h.z[1] > 0.3 and h.z[2] > 0.4
    assert h.z[0] < 0.0


def test_link_wall_combined():
    pts = Solution(Float3, 3, solver="tile", device="cpu")
    pts.h_X.x[:3] = [0.0, 0.0, 3.0]
    pts.h_X.z[:3] = [0.0, 2.0, 2.0]
    pts.copy_to_device()
    links = Links(1, strength=0.5, device="cpu")
    links.h_a[0], links.h_b[0] = 1, 2
    links.copy_to_device()
    pts.set_fixed(0)
    pts.take_step(0.1, no_pw, pw_friction=friction_on_background,
                  gen_forces=link_wall_forces(links, 0))
    h = pts.copy_to_host()
    assert h.x[1] > 0.0 and h.x[2] < 3.0
    assert isclose(h.z[1], 2.0) and isclose(h.z[2], 2.0)


def test_links_reset_predicate():
    links = Links(4, device="cpu")
    links.h_a[:4] = [1, 2, 3, 4]
    links.h_b[:4] = [5, 6, 7, 8]
    links.copy_to_device()
    links.reset(lambda a, b: a % 2 == 0)
    assert list(links.h_a[:4]) == [1, 0, 3, 0]
    assert list(links.h_b[:4]) == [5, 0, 7, 0]
    links.reset()
    assert links.h_a[:4].sum() == 0


# ---- against the JAX package ----------------------------------------------

def _half_space(n_cells, n_pad):
    h, n = W.half_space_tissue(n_cells, n_pad)
    return (h, n, JFloat3(*(jnp.asarray(h[f]) for f in "xyz")),
            Float3(*(torch.as_tensor(h[f]) for f in "xyz")))


def test_random_cube_neighbours_with_jax_draws():
    h, n, jX, tX = _half_space(1000, 1024)
    src = np.arange(1024) % n
    key = jax.random.PRNGKey(3)
    jc, jf = j_random_cube_nbs(jX, jnp.int32(n), jnp.float32(1.0), 50,
                               jnp.asarray(src, jnp.int32), key)
    ka, kb = jax.random.split(key)
    tc, tf = random_cube_neighbours(
        tX, n, 1.0, 50, torch.as_tensor(src),
        torch.as_tensor(np.array(jax.random.randint(ka, (1024,), 0, 27)),
                        dtype=torch.int64),
        torch.as_tensor(np.array(jax.random.uniform(kb, (1024,)))))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tf.float().mean() > 0.5


def test_update_protrusions_wall_with_jax_draws():
    """Two rewiring rounds of the growth_w_wall rule through
    ``Links.update`` on both packages (the second round moves set links
    with probability ``update_prob``): equal ``(a, b)``."""
    G = jax_example()
    h, n, jX, tX = _half_space(1000, 1024)

    class Cells:    # the two attributes Links.update reads
        pass
    jcells, tcells = Cells(), Cells()
    jcells.d_X, jcells.d_n = jX, jnp.int32(n)
    tcells.d_X, tcells.d_n = tX, n
    jl = JLinks(n, G.protrusion_strength, seed=15)
    jl.set_d_n(n)
    tl = Links(n, W.protrusion_strength, seed=15, device="cpu")
    tl.set_d_n(n)
    for _ in range(2):
        draws = next_draws(jl)
        jl.update(G.update_protrusions_wall, jcells)
        tl.update(W.update_protrusions_wall, tcells, draws=draws)
        np.testing.assert_array_equal(tl.d_a.numpy(), np.asarray(jl.d_a))
        np.testing.assert_array_equal(tl.d_b.numpy(), np.asarray(jl.d_b))
    live = (tl.d_a != tl.d_b)[:n]
    assert live.float().mean() > 0.1
    assert not bool((tl.d_a[:n][live] == W.WALL).any())


def test_links_from_jax_and_own_draws():
    jl = JLinks(100, 0.3, seed=1)
    jl.h_a[:3] = [4, 5, 6]
    jl.h_b[:3] = [7, 8, 9]
    jl.copy_to_device()
    jl.set_d_n(40)
    tl = links_from(jl, device="cpu")
    assert (tl.n_max, tl.n_pad, tl.d_n, tl.strength) == \
        (jl.n_max, jl.n_pad, 40, np.float32(0.3))
    np.testing.assert_array_equal(tl.d_a.numpy(), np.asarray(jl.d_a))
    np.testing.assert_array_equal(tl.d_b.numpy(), np.asarray(jl.d_b))
    d = tl.draws()
    assert d.pick_cube.shape == d.u.shape == d.noise.shape == (tl.n_pad,)
    assert 0 <= int(d.pick_cube.min()) and int(d.pick_cube.max()) < 27
    assert 0 <= float(d.u.min()) and float(d.noise.max()) < 1
    again = Links(100, seed=7, device="cpu").draws()
    assert torch.equal(again.u, Links(100, seed=7, device="cpu").draws().u)
