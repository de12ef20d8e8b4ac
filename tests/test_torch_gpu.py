"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``gpu``: without a CUDA device every test skips.  On a machine
with one (which need not have JAX), run

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: the pour is exact; the pair kernels' counters (epi_nbs, sum
of friction) and flags are exact, their other sums within rtol 1e-4 /
atol 1e-5 of the plain version (f32 rounding of FMA-contracted force
arithmetic and another summation order; 1e-4 for the central kernel's
forces, whose factored form cancels two sums of size |x| * sum|w|); the
slices within the reference's ``isclose`` of the same steps on the CPU.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import isclose
from yalla_tpu_torch.dtypes import Float3
from yalla_tpu_torch.interop import load_settled
from yalla_tpu_torch.models import branching as B
from yalla_tpu_torch.models import sorting as S
from yalla_tpu_torch.ops.central_mxu import (central_pairwise_mxu,
                                             central_pairwise_plain)
from yalla_tpu_torch.ops.common import (friction_on_background,
                                        friction_w_neighbour)
from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                lattice_pairwise_plain)
from yalla_tpu_torch.ops.lattice_pour import (DST_SENTINEL, pour_pallas,
                                              pour_plain)
from yalla_tpu_torch.ops.lattice_xla import lattice_build
from yalla_tpu_torch.ops.tile_pallas import (tile_pairwise_pallas,
                                             tile_pairwise_plain)
from yalla_tpu_torch.solvers import (LatticeEngine, Solution, TileEngine,
                                     augment)

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


def _rows(out, n):
    """The first ``n`` rows of a pair pass's ``(F, sum_f, sum_v, aux)``
    (rows past the active count are don't-care)."""
    F, sum_f, sum_v, aux = out
    return (type(F)(*(a[:n] for a in F)), sum_f[:n],
            tuple(a[:n] for a in sum_v), {k: a[:n] for k, a in aux.items()})


def _assert_sums(got, want, exact_aux=(), atol=1e-5):
    for a, b in zip(got[0], want[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)
    assert torch.equal(got[1], want[1])                    # sum of friction
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        if k in exact_aux:
            assert torch.equal(got[3][k], want[3][k]), k
        else:
            torch.testing.assert_close(got[3][k], want[3][k], rtol=1e-4,
                                       atol=1e-5)


def _sorting_ball(device, n=900, n_pad=1000):
    X = S.Cell(*(torch.as_tensor(a, device=device)
                 for a in S.initial_ball(n, n_pad, seed=1).values()))
    g = torch.Generator().manual_seed(0)
    ov = Float3(*(0.01 * torch.randn(n_pad, generator=g).to(device)
                  for _ in range(3)))
    return X, ov, n


def test_tile_kernel_matches_plain(cuda):
    """K3 on the sorting ball (n_pad 1000: the kernel takes any n_pad) and
    on the 600-cell branching state with its polarity channels (diagonal,
    aux and non-xyz channels)."""
    X, ov, n = _sorting_ball(cuda)
    force = S.make_adhesion(S.Params())
    before = tile_pairwise_pallas.launches
    got = tile_pairwise_pallas(force, friction_w_neighbour, X, ov, n)
    want = tile_pairwise_plain(force, friction_w_neighbour, X, ov, n)
    assert tile_pairwise_pallas.launches == before + 1
    _assert_sums(_rows(got, n), _rows(want, n))

    Xb, ovb = load_settled(SETTLED_600, B.Cell, cuda)
    Xb = augment(Xb, N, B.precompute)
    bforce = B.make_force(B.Params())
    got = tile_pairwise_pallas(bforce, friction_w_neighbour, Xb, ovb, N)
    want = tile_pairwise_plain(bforce, friction_w_neighbour, Xb, ovb, N)
    _assert_sums(_rows(got, N), _rows(want, N), exact_aux=("epi_nbs",))


@pytest.mark.parametrize("friction", [friction_w_neighbour,
                                      friction_on_background])
def test_central_kernel_matches_plain(cuda, friction):
    X, ov, n = _sorting_ball(cuda)
    force = S.make_adhesion_central(S.Params())
    before = central_pairwise_mxu.launches
    got = central_pairwise_mxu(force, friction, X, ov, n)
    want = central_pairwise_plain(force, friction, X, ov, n)
    assert central_pairwise_mxu.launches == before + 1
    _assert_sums(_rows(got, n), _rows(want, n), atol=1e-4)


def test_all_pairs_kernels_refuse_force_without_functor(cuda):
    X, ov, n = _sorting_ball(cuda)

    def plain_force(Xi, r, dist, i, j):
        return Xi
    with pytest.raises(ValueError, match="no CUDA functor"):
        tile_pairwise_pallas(plain_force, friction_w_neighbour, X, ov, n)
    central = S.make_adhesion_central(S.Params())
    del central.cuda_functor
    with pytest.raises(ValueError, match="no CUDA functor"):
        central_pairwise_mxu(central, friction_w_neighbour, X, ov, n)
    # TileEngine() resolves to the kernels on CUDA tensors: no silent
    # plain path
    with pytest.raises(ValueError, match="no CUDA functor"):
        TileEngine().pairwise(plain_force, friction_w_neighbour, X, ov, n,
                              1.0)
    with pytest.raises(ValueError, match="friction"):
        tile_pairwise_pallas(S.make_adhesion(S.Params()),
                             friction_on_background, X, ov, n)


@pytest.mark.parametrize("mxu", [True, False])
def test_sorting_slice_on_gpu_matches_cpu(cuda, mxu):
    p = S.Params()
    force = S.make_adhesion_central(p) if mxu else S.make_adhesion(p)
    engine = TileEngine(mxu=True) if mxu else TileEngine(pallas=True)
    counter = central_pairwise_mxu if mxu else tile_pairwise_pallas
    out = {}
    for dev in ("cpu", cuda):
        sol = Solution(S.Cell, 900, engine=engine, device=dev, n_pad=1000)
        sol.h_X = S.Cell(**S.initial_ball(900, 1000, seed=1))
        counter.launches = 0
        sol.take_steps(2, p.dt, force)
        out[str(dev)] = (sol.copy_to_host(), counter.launches)
    (h_cpu, l_cpu), (h_gpu, l_gpu) = out["cpu"], out[str(cuda)]
    assert (l_cpu, l_gpu) == (0, 4)
    for f in S.Cell._fields:
        assert isclose(getattr(h_gpu, f)[:900], getattr(h_cpu, f)[:900]), f
