"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``gpu``: without a CUDA device every test skips.  On a machine
with one (which need not have JAX), run

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: the pour is exact; the pair kernel's counters (epi_nbs, sum
of friction) and flags are exact, its other sums within rtol 1e-4 /
atol 1e-5 of the plain version (f32 rounding of FMA-contracted force
arithmetic and another summation order); the slice within the
reference's ``isclose`` of the same steps on the CPU.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.ops.common import friction_w_neighbour
from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                lattice_pairwise_plain)
from yalla_tpu_torch.ops.lattice_pour import (DST_SENTINEL, pour_pallas,
                                              pour_plain)
from yalla_tpu_torch.ops.lattice_xla import lattice_build
from yalla_tpu_torch.solvers import LatticeEngine, Solution, augment

pytestmark = pytest.mark.gpu

SETTLED_600 = Path(__file__).resolve().parent.parent / ".bench_cache" / \
    "settled_branching_600_s0_v1.npz"
N, GS, C, EXTRAS = 600, 32, 4, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_pour_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    n_pad, n_slots = 8192, 16 ** 3 * 8
    S = rng.random((5, n_pad), np.float32)
    dst = rng.permutation(n_slots)[:n_pad].astype(np.float32)
    dst[rng.random(n_pad) < 0.2] = DST_SENTINEL
    S[-1] = dst
    S = torch.as_tensor(S, device=cuda)
    before = pour_pallas.launches
    got = pour_pallas(S, n_slots)
    assert pour_pallas.launches == before + 1
    for a, b in zip(got, pour_plain(S, n_slots)):
        assert torch.equal(a, b)


def _layout(device):
    X, ov = load_settled(SETTLED_600, B.Cell, device)
    lay = lattice_build(X, ov, N, 1.0, GS, C, EXTRAS)
    return lay._replace(T=augment(lay.T, N, B.precompute),
                        E=augment(lay.E, N, B.precompute))


def test_pair_kernel_matches_plain(cuda):
    lay = _layout(cuda)
    force = B.make_force(B.Params())
    kw = dict(grid_size=GS, capacity=C, z_block=2, extras_block_cap=16)
    before = lattice_pairwise_pallas.launches
    got = lattice_pairwise_pallas(force, friction_w_neighbour, lay, N, 1.0,
                                  **kw)
    want = lattice_pairwise_plain(force, friction_w_neighbour, lay, N, 1.0,
                                  **kw)
    assert lattice_pairwise_pallas.launches == before + 1
    for g, w in ((got[:4], want[:4]), (got[4], want[4])):
        for a, b in zip(g[0], w[0]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        assert torch.equal(g[1], w[1])                     # sum of friction
        for a, b in zip(g[2], w[2]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        for k in w[3]:
            if k in ("epi_nbs", "__err_extras_block"):
                assert torch.equal(g[3][k], w[3][k]), k
            else:
                torch.testing.assert_close(g[3][k], w[3][k], rtol=1e-4,
                                           atol=1e-5)


def test_pair_kernel_refuses_force_without_functor(cuda):
    lay = _layout(cuda)

    def plain_force(Xi, r, dist, i, j):
        return Xi
    with pytest.raises(ValueError, match="no CUDA functor"):
        lattice_pairwise_pallas(plain_force, friction_w_neighbour, lay, N,
                                1.0, grid_size=GS, capacity=C, z_block=2)


def test_slice_on_gpu_matches_cpu(cuda):
    force = B.make_force(B.Params())
    engine = LatticeEngine(grid_size=GS, capacity=C, z_block=2,
                           extras_cap=EXTRAS, extras_block_cap=16)
    out = {}
    for dev in ("cpu", cuda):
        X, ov = load_settled(SETTLED_600, B.Cell)
        sol = Solution(B.Cell, N, engine=engine, device=dev)
        sol.h_X = B.Cell(*(a.numpy() for a in X))
        sol.copy_to_device()
        sol.d_old_v = Float3(*(a.to(dev) for a in ov))
        pour_pallas.launches = lattice_pairwise_pallas.launches = 0
        sol.take_steps(2, 0.2, force, precompute=B.precompute)
        out[str(dev)] = (sol.copy_to_host(), pour_pallas.launches,
                         lattice_pairwise_pallas.launches)
    h_cpu, *cpu_launches = out["cpu"]
    h_gpu, *gpu_launches = out[str(cuda)]
    assert cpu_launches == [0, 0] and gpu_launches == [4, 4]
    for f in B.Cell._fields:
        assert isclose(getattr(h_gpu, f)[:N], getattr(h_cpu, f)[:N]), f
