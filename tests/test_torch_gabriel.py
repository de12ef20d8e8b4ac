"""The Gabriel lattice pass (kernel K5) on the CPU: the port's plain
version against the JAX package's gather form and its Pallas kernel (in
interpret mode), the stable ids it hands the force, and its wrapper's
refusals.

Tolerances: friction sums (counts) and ``__err_*`` flags exact; forces and
``sum_v`` within atol 1e-5, as ``tests/test_solvers.py:347-384`` holds the
JAX kernel against the gather form (f32 rounding and summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_grid import (assert_sums_match, both, j_spring,
                             random_tissue, spring)
from yalla_tpu import Float3 as JFloat3
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.gabriel_pallas import \
    gabriel_lattice_pallas as j_gabriel_lattice
from yalla_tpu.ops.grid_xla import gabriel_pairwise as j_gabriel
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.models import growth_w_wall as W
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops.functors import pair_functor
from yalla_tpu_torch.ops.gabriel_pallas import (gabriel_lattice_pallas,
                                                gabriel_lattice_plain)
from yalla_tpu_torch.utils import profiling

torch.set_num_threads(2)

FLAGS = ("__err_gabriel_candidates", "__err_lattice_dropped",
         "__err_out_of_grid")


def _flags_zero(aux):
    for k in FLAGS:
        assert float(aux[k].max()) == 0.0, k


def _without(aux, keys):
    return {k: v for k, v in aux.items() if k not in keys}


def test_plain_matches_jax_gather_form():
    """The 700-point tissue of ``test_solvers.py:347-384``: the plain K5
    (gs 16, C 8, NC 20) against JAX's gather form (row_cap 48, NC 64)."""
    n, pos, ov = random_tissue()
    jX, jov, tX, tov = both(pos, ov)
    j = j_gabriel(j_spring, j_friction, jX, jov, jnp.int32(n),
                  jnp.float32(1.0), grid_size=16, row_cap=48,
                  max_candidates=64)
    t = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n, 1.0,
                              grid_size=16, capacity=8, max_candidates=20)
    _flags_zero(t[3])
    assert_sums_match(t[:3] + (_without(t[3], FLAGS),),
                      j[:3] + ({},), n, "plain K5 vs gather")


def test_plain_matches_jax_lattice_kernel_interpret():
    """The plain K5 against JAX's ``gabriel_lattice_pallas`` in interpret
    mode at gs 16, C 8, NC 20 on the 700-point tissue: every output,
    flags included, in stable order."""
    n, pos, ov = random_tissue()
    jX, jov, tX, tov = both(pos, ov)
    j = j_gabriel_lattice(j_spring, j_friction, jX, jov, jnp.int32(n),
                          jnp.float32(1.0), grid_size=16, capacity=8,
                          max_candidates=20)
    t = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n, 1.0,
                              grid_size=16, capacity=8, max_candidates=20)
    assert set(t[3]) == set(j[3])
    assert_sums_match(t, j, n, "plain K5 vs Pallas K5")


def test_stable_ids_reach_the_force_as_in_the_gather_form():
    """``test_solvers.py::test_gabriel_stable_id_semantics`` on the port:
    point 0 sits mid-tissue and the force excludes it by id, so a slot-id
    mixup would move its force to another cell."""
    def j_wall_spring(Xi, r, dist, i, j):
        near = (i != j) & (i != 0) & (j != 0) & (dist < 1.0)
        w = jnp.where(near, (0.8 - dist), 0.0)
        safe = jnp.where(dist > 0, dist, 1.0)
        return JFloat3(x=r.x * w / safe, y=r.y * w / safe, z=r.z * w / safe)

    def wall_spring(Xi, r, dist, i, j):
        near = (i != j) & (i != 0) & (j != 0) & (dist < 1.0)
        w = torch.where(near, (0.8 - dist), 0.0)
        safe = torch.where(dist > 0, dist, 1.0)
        return Float3(x=r.x * w / safe, y=r.y * w / safe, z=r.z * w / safe)

    rng = np.random.default_rng(23)
    n, n_pad = 500, 512
    pos = rng.uniform(-3.5, 3.5, (n_pad, 3)).astype(np.float32)
    pos[0] = [0.3, 0.2, 0.1]
    jX, jov, tX, tov = both(pos, np.zeros((3, n_pad), np.float32))
    j = j_gabriel(j_wall_spring, j_friction, jX, jov, jnp.int32(n),
                  jnp.float32(1.0), grid_size=16, row_cap=48,
                  max_candidates=64)
    t = gabriel_lattice_plain(wall_spring, friction_w_neighbour, tX, tov, n,
                              1.0, grid_size=16, capacity=8,
                              max_candidates=20)
    assert float(np.abs(np.asarray(j[0].x)[0])) == 0.0
    assert float(t[0].x[0]) == 0.0
    _flags_zero(t[3])
    for f in range(3):
        np.testing.assert_allclose(t[0][f].numpy()[:n],
                                   np.asarray(j[0][f])[:n], atol=1e-5)


def test_growth_w_wall_force_on_the_half_space_matches_gather():
    """The model's own force and friction (wall node 0 at the origin, among
    the bottom layer) on the ~1,000-cell half-space tissue: the plain K5
    against the port's gather form, which the grid tests hold to JAX's.
    The wall node stays a geometric blocker: the kept sets agree."""
    from yalla_tpu_torch.ops.grid_xla import gabriel_pairwise
    h, n = W.half_space_tissue(1000, 1024)
    X = Float3(*(torch.as_tensor(h[f]) for f in "xyz"))
    ov = Float3(*(0.01 * torch.ones(1024) for _ in range(3)))
    t = gabriel_lattice_plain(W.relu_force, W.wall_friction, X, ov, n, 1.0,
                              grid_size=16, capacity=8, max_candidates=20)
    g = gabriel_pairwise(W.relu_force, W.wall_friction, X, ov, n, 1.0,
                         grid_size=16, row_cap=48, max_candidates=64)
    _flags_zero(t[3])
    assert torch.equal(t[1], g[1])
    assert float(t[1][0]) == 0.0 and float(t[1][1:n].min()) > 0
    for a, b in zip(t[0], g[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_candidate_overflow_and_capacity_flags():
    """NC below the real count sets ``__err_gabriel_candidates`` on the
    same points as JAX's kernel; a capacity below the occupancy sets
    ``__err_lattice_dropped``; a grid too small ``__err_out_of_grid``."""
    n, pos, ov = random_tissue()
    jX, jov, tX, tov = both(pos, ov)
    j = j_gabriel(j_spring, j_friction, jX, jov, jnp.int32(n),
                  jnp.float32(1.0), grid_size=16, row_cap=48,
                  max_candidates=5)
    t = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n, 1.0,
                              grid_size=16, capacity=8, max_candidates=4)
    # the gather form counts the point itself among its candidates
    np.testing.assert_array_equal(t[3]["__err_gabriel_candidates"].numpy(),
                                  np.asarray(j[3]["__err_gabriel_candidates"]))
    t = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n, 1.0,
                              grid_size=16, capacity=1, max_candidates=20)
    assert float(t[3]["__err_lattice_dropped"]) > 0
    t = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n, 1.0,
                              grid_size=6, capacity=8, max_candidates=20)
    assert float(t[3]["__err_out_of_grid"]) > 0


def test_wrapper_runs_plain_on_cpu_and_refuses_the_rest():
    n, pos, ov = random_tissue(n=300, n_pad=384, half=3.0)
    _, _, tX, tov = both(pos, ov)
    kw = dict(grid_size=16, capacity=8, max_candidates=20)
    with profiling.tracing():
        got = gabriel_lattice_pallas(spring, friction_w_neighbour, tX, tov,
                                     n, 1.0, **kw)
        assert "kernels.gabriel_pair" not in profiling.counters()
    want = gabriel_lattice_plain(spring, friction_w_neighbour, tX, tov, n,
                                 1.0, **kw)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    meta = Float3(*(torch.zeros(16, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="unsupported device"):
        gabriel_lattice_pallas(spring, friction_w_neighbour, meta, meta, 8,
                               1.0, **kw)
    # the functor checks the GPU path makes before any launch
    plain = "the plain path"
    with pytest.raises(ValueError, match="no CUDA functor"):
        pair_functor(spring, W.wall_friction, "gabriel", plain)
    with pytest.raises(ValueError, match="friction"):
        pair_functor(W.relu_force, friction_w_neighbour, "gabriel", plain)
    with pytest.raises(ValueError, match="not built into"):
        pair_functor(W.relu_force, W.wall_friction, "lattice", plain)
    spec, params = pair_functor(W.relu_force, W.wall_friction, "gabriel",
                                plain)
    assert spec["entries"]["gabriel"] == "yalla_gabriel_pair_wall_relu"
    assert params == W.Params(r_max=1.0, wall=0)
