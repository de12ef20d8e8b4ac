"""The port's main path as a whole: ``Solution.take_steps`` on a
``LatticeEngine`` with overflow extras (the kernel-wrapper path, which
runs the plain kernel versions on the CPU), against the JAX integrator.

Reference: JAX ``lattice_heun_steps(2, 1, ..., pallas=False)`` at full
capacity (C 8, no extras) on the settled 600-cell branching state; the
port runs gs 32, C 4 with 9 cells in the extras list.  tests/test_extras.py
pins extras == full capacity inside the JAX package.  Tolerance: every
Cell field within tests/helpers.py ``isclose`` (atol 1e-6 + rtol 1e-2, the
reference's own); neighbour counters and every ``__err_*`` flag exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
from test_torch_common import jax_pt, settled_600
from yalla_tpu import dtypes as jdt
from yalla_tpu.models import branching as JB
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.lattice_xla import lattice_heun_steps as j_steps
from yalla_tpu.polarity import polarity_precompute3 as j_pre3
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.models import branching as TB
from yalla_tpu_torch.solvers import LatticeEngine, SimulationError, Solution

torch.set_num_threads(2)

N, STEPS = 600, 2


def solution_600(engine):
    X, ov = settled_600()
    sol = Solution(TB.Cell, N, engine=engine, cube_size=1.0, device="cpu")
    sol.h_X = TB.Cell(**X)
    sol.copy_to_device()
    sol.d_old_v = pt_from_numpy(tdt.Float3, ov, device="cpu")
    return sol


@pytest.fixture(scope="module")
def runs():
    X, ov = settled_600()
    p = JB.Params()
    jX, _, jaux = j_steps(
        STEPS, 1, JB.make_force(p), j_friction, "com", 32, 8, 2,
        jax_pt(JB.Cell, X), jax_pt(jdt.Float3, ov), jnp.int32(N),
        jnp.float32(p.dt), jnp.float32(1.0), jnp.int32(0), j_pre3, False)
    sol = solution_600(LatticeEngine(grid_size=32, capacity=4, z_block=2,
                                     extras_cap=64, extras_block_cap=16))
    aux = sol.take_steps(STEPS, TB.Params().dt, TB.make_force(TB.Params()),
                         precompute=TB.precompute)
    return (jX, jaux), (sol, aux)


@pytest.mark.parametrize("field", TB.Cell._fields)
def test_slice_matches_jax(runs, field):
    (jX, _), (sol, _) = runs
    h = sol.copy_to_host()
    assert isclose(getattr(h, field)[:N], np.asarray(getattr(jX, field))[:N])


def test_slice_counters_and_flags_match_jax(runs):
    (_, jaux), (_, aux) = runs
    for k in ("epi_nbs", "mes_nbs"):
        np.testing.assert_array_equal(aux[k].numpy()[:N],
                                      np.asarray(jaux[k])[:N], err_msg=k)
    flags = {k: float(v) for k, v in aux.items() if k.startswith("__err_")}
    jflags = {k: float(v) for k, v in jaux.items() if k.startswith("__err_")}
    # the port adds the extras block flag of its extras path
    assert flags.pop("__err_extras_block") == 0.0
    assert flags == jflags == {k: 0.0 for k in jflags}


def test_slice_raises_on_capacity_drop():
    """C 2 without extras drops cells: the flag must raise."""
    sol = solution_600(LatticeEngine(grid_size=32, capacity=2))
    with pytest.raises(SimulationError, match="lattice_dropped"):
        sol.take_steps(1, 0.2, TB.make_force(TB.Params()),
                       precompute=TB.precompute)
