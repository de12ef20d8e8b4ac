"""The lattice path's edges, on the CPU: the extras block-table overflow
flag on grids the JAX kernel refuses, and the integrator's refusals: of
the combinations the JAX integrator asserts against, and of its XLA pass
(``pallas=False``), which the port does not implement.

``extras_block_overflow`` is counting, so it is exact: against a numpy
count of the same tables on every grid, and against the JAX kernel's own
tables (plain jnp) wherever that kernel accepts the grid.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_pt
from yalla_tpu import dtypes as jdt
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.ops.lattice_pallas import _extras_tables
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops.lattice_pallas import (_y_block,
                                                extras_block_overflow)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N, N_PAD, E_CAP = 1500, 1536, 2048


def _points(grid, seed):
    """``N`` points in ``N_PAD`` rows, uniform over the cubes of ``grid``
    (cube size 1) within 4 cubes of its centre, so that cubes of capacity
    1 overflow into hundreds of extras."""
    rng = np.random.default_rng(seed)
    h = {}
    for f, g in zip("xyz", grid):
        lo, hi = max(-(g // 2), -4), min(g - g // 2, 4)
        h[f] = np.zeros(N_PAD, np.float32)
        h[f][:N] = rng.uniform(lo, hi, N)
    return h


def _table_overflow(lay, grid, zb, yb, cap):
    """Entries past ``cap`` in the per-(z, y)-block tables of the live
    extras, each tabled in every block its +-1-cube reach meets; the last
    block of an axis is ragged where the block does not divide it."""
    _, gy, gz = grid
    nz, ny = -(-gz // zb), -(-gy // yb)
    live = (lay.epid < lay.slot_of.shape[0]).numpy()
    cz = np.clip(np.floor(lay.E.z.numpy()).astype(int) + gz // 2, 0, gz - 1)
    cy = np.clip(np.floor(lay.E.y.numpy()).astype(int) + gy // 2, 0, gy - 1)
    counts = np.zeros((nz, ny), int)
    for z, y in zip(cz[live], cy[live]):
        for bz in {min(max((z + d) // zb, 0), nz - 1) for d in (-1, 1)}:
            for by in {min(max((y + d) // yb, 0), ny - 1) for d in (-1, 1)}:
                counts[bz, by] += 1
    return int(np.maximum(counts - cap, 0).sum())


# (grid, z_block, the y block the flag must take, whether JAX accepts it)
FLAG_GRIDS = [((11, 11, 11), 2, 16, False),     # nothing divides 11
              ((16, 24, 8), 2, 8, True),        # gy % 8 == 0: JAX's 8 rows
              ((12, 32, 6), 3, 16, True),       # JAX's default 16 rows
              ((8, 20, 8), 2, 16, False)]       # gy % 8 != 0, z divides


@pytest.mark.parametrize("grid,zb,yb,jax_accepts", FLAG_GRIDS)
@pytest.mark.parametrize("block_cap", [8, 24, 2048])
def test_extras_block_overflow_on_any_grid(grid, zb, yb, jax_accepts,
                                           block_cap):
    h = _points(grid, seed=4)
    tX = pt_from_numpy(tdt.Float3, h, device="cpu")
    lay = TL.lattice_build(tX, tX, N, 1.0, grid, 1, E_CAP)
    assert int(lay.n_extras) > 300 and int(lay.n_dropped) == 0
    assert _y_block(grid[1]) == yb
    cap = max(block_cap // 8 * 8, 8)
    got = float(extras_block_overflow(lay, 1.0, grid, zb, block_cap))
    assert got == _table_overflow(lay, grid, zb, yb, cap)
    if block_cap != 24:      # 8 entries overflow, 2048 hold every extra
        assert (got > 0) == (block_cap == 8)
    if jax_accepts:
        jX = jax_pt(jdt.Float3, h)
        ref = JL.lattice_build(jX, jX, jnp.int32(N), jnp.float32(1.0), grid,
                               1, E_CAP)
        _, _, j_over = _extras_tables(ref, [0, 1, 2], False, grid[2] // zb,
                                      grid[1] // yb, zb, yb,
                                      jnp.float32(1.0), grid, cap)
        assert got == float(j_over)


# the option the port refuses: its pair pass always runs through the
# kernel wrapper (the JAX package's XLA pass has no separate port)
REFUSED = {"pallas": dict(pallas=False)}


def _heun(**options):
    X = pt_from_numpy(tdt.Float3, _points((8, 8, 8), seed=0), device="cpu")
    kw = dict(rebuild_every=1, n_steps=1)
    kw.update(options)
    rebuild_every, n_steps = kw.pop("rebuild_every"), kw.pop("n_steps")

    def force(Xi, r, dist, i, j):
        return r
    return TL.lattice_heun_steps(n_steps, rebuild_every, force,
                                 friction_w_neighbour, "com", 8, 8, 2, X, X,
                                 N, 0.1, 1.0, 0, **kw)


@pytest.mark.parametrize("option", list(REFUSED))
def test_lattice_heun_steps_refuses_unported_option(option):
    with pytest.raises(NotImplementedError, match=option):
        _heun(**REFUSED[option])


def _j_gen(X, n, args):
    return X


# the combinations the JAX integrator asserts against
# (yalla_tpu/ops/lattice_xla.py:745, :757-760, :763-764, :1142), with
# words of the port's message
JAX_ASSERTS = {
    "n_steps_not_a_multiple": (dict(n_steps=3, rebuild_every=2),
                               "multiple of rebuild_every"),
    "x_split_resident": (dict(n_steps=2, rebuild_every=2, x_split=2),
                         "x_split"),
    "x_split_rebin_per_step": (dict(x_split=2, rebin_m_cap=64), "x_split"),
    "extras_with_generic_forces": (dict(extras_cap=64, gen=_j_gen),
                                   "generic forces"),
    "rebin_per_pass_resident": (dict(n_steps=2, rebuild_every=2,
                                     rebin_m_cap=64, rebin_per_pass=True),
                                "rebin_per_pass"),
}


@pytest.mark.parametrize("case", list(JAX_ASSERTS))
def test_lattice_heun_steps_raises_where_jax_asserts(case):
    """The port raises ``ValueError`` on exactly the combinations the JAX
    integrator asserts against (it asserts while tracing, so the JAX call
    stops before any work)."""
    options, words = JAX_ASSERTS[case]
    with pytest.raises(ValueError, match=words):
        _heun(**options)
    kw = dict(options)
    rebuild_every, n_steps = kw.pop("rebuild_every", 1), kw.pop("n_steps", 1)
    if "gen" in kw:
        from yalla_tpu.solvers import GenericForce
        kw["gen"] = GenericForce(kw["gen"])
    jX = jdt.Float3(*(jnp.zeros(128) for _ in range(3)))
    with pytest.raises(AssertionError):
        JL.lattice_heun_steps(n_steps, rebuild_every, lambda *a: a[1],
                              None, "com", 8, 8, 2, jX, jX, jnp.int32(1),
                              jnp.float32(0.1), jnp.float32(1.0),
                              jnp.int32(0), pallas=True, **kw)


def test_lattice_heun_steps_refuses_without_asserts():
    """The refusals are raised, not asserted: they hold under ``python -O``,
    which strips asserts."""
    code = (
        "import torch\n"
        "from yalla_tpu_torch.ops.lattice_xla import lattice_heun_steps\n"
        "assert False, 'asserts are stripped'\n"
        "cases = [(1, 4, {}), (2, 2, dict(x_split=2)),\n"
        "         (1, 1, dict(x_split=2, rebin_m_cap=64)),\n"
        "         (1, 1, dict(extras_cap=64, gen=print)),\n"
        "         (2, 2, dict(rebin_m_cap=64, rebin_per_pass=True)),\n"
        "         (1, 1, dict(pallas=False))]\n"
        "for steps, every, kw in cases:\n"
        "    try:\n"
        "        lattice_heun_steps(steps, every, None, None, 'com', 8, 8,\n"
        "                           2, None, None, 0, 0.1, 1.0, 0, **kw)\n"
        "    except (ValueError, NotImplementedError) as e:\n"
        "        print('refused:', type(e).__name__, e)\n")
    run = subprocess.run([sys.executable, "-O", "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("refused:")]
    assert len(lines) == 6 and "rebuild_every" in lines[0]
    assert "NotImplementedError" in lines[-1]
