"""yalla_tpu_torch against yalla_tpu: the lattice pair pass (kernel K1's
plain version) with overflow extras, against ONE ``lattice_pairwise_pallas``
pass in interpret mode, on the settled 600-cell branching state at
gs 32, C 4 (9 cells spill into the extras list there).

Tolerance: sums agree to rtol 1e-5 / atol 1e-5 (f32 rounding and a
different summation order over up to ~30 partners); the neighbour
counters (epi_nbs, sum of friction) and ``__err_extras_block`` exactly.
The lattice outputs are compared on occupied slots (the JAX kernel leaves
garbage in empty ones), the extras outputs on live entries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_pt, settled_600
from yalla_tpu import dtypes as jdt
from yalla_tpu.models import branching as JB
from yalla_tpu.ops import lattice_xla as JL
from yalla_tpu.ops.common import friction_w_neighbour as j_friction
from yalla_tpu.ops.lattice_pallas import lattice_pairwise_pallas as j_pass
from yalla_tpu.polarity import polarity_precompute3 as j_pre3
from yalla_tpu.solvers import augment as j_augment
from yalla_tpu_torch import dtypes as tdt
from yalla_tpu_torch.interop import pt_from_numpy
from yalla_tpu_torch.models import branching as TB
from yalla_tpu_torch.ops import lattice_xla as TL
from yalla_tpu_torch.ops.common import friction_w_neighbour as t_friction
from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                lattice_pairwise_plain)
from yalla_tpu_torch.solvers import augment as t_augment

torch.set_num_threads(2)

N, GS, C, EXTRAS, ZB, BLOCK_CAP = 600, 32, 4, 64, 4, 16
RTOL, ATOL = 1e-5, 1e-5
COUNTERS = ("sum_f", "epi_nbs", "__err_extras_block")


def _named(outs):
    F, sum_f, sum_v, aux = outs
    d = {f"F.{f}": a for f, a in zip(F._fields, F)}
    d["sum_f"] = sum_f
    d.update({f"sum_v{c}": a for c, a in enumerate(sum_v)})
    d.update(aux)
    return {k: np.asarray(v) if not torch.is_tensor(v) else v.numpy()
            for k, v in d.items()}


@pytest.fixture(scope="module")
def passes():
    X, ov = settled_600()
    jlay = JL.lattice_build(jax_pt(JB.Cell, X), jax_pt(jdt.Float3, ov),
                            jnp.int32(N), jnp.float32(1.0), GS, C, EXTRAS)
    jlay = jlay._replace(T=j_augment(jlay.T, N, j_pre3),
                         E=j_augment(jlay.E, N, j_pre3))
    ref = j_pass(JB.make_force(JB.Params()), j_friction, jlay, jnp.int32(N),
                 jnp.float32(1.0), grid_size=GS, capacity=C, z_block=ZB,
                 extras_block_cap=BLOCK_CAP)
    tlay = TL.lattice_build(pt_from_numpy(TB.Cell, X, device="cpu"),
                            pt_from_numpy(tdt.Float3, ov, device="cpu"), N,
                            1.0, GS, C, EXTRAS)
    tlay = tlay._replace(T=t_augment(tlay.T, N, TB.precompute),
                         E=t_augment(tlay.E, N, TB.precompute))
    kw = dict(grid_size=GS, capacity=C, z_block=ZB,
              extras_block_cap=BLOCK_CAP)
    force = TB.make_force(TB.Params())
    got = lattice_pairwise_plain(force, t_friction, tlay, N, 1.0, **kw)
    wrapped = lattice_pairwise_pallas(force, t_friction, tlay, N, 1.0, **kw)
    n_pad = tlay.slot_of.shape[0]
    occ = tlay.pid.numpy() < n_pad
    live = tlay.epid.numpy() < n_pad
    return ref, got, wrapped, occ, live


def _compare(port, ref, mask):
    assert set(port) == set(ref)
    for k in ref:
        a, b = port[k], ref[k]
        if a.ndim:
            a, b = a[mask], b[mask]
        if k in COUNTERS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_lattice_sums_match_pallas(passes):
    ref, got, _, occ, _ = passes
    assert occ.sum() == N - 9
    _compare(_named(got[:4]), _named(ref[:4]), occ)


def test_extras_sums_match_pallas(passes):
    ref, got, _, _, live = passes
    assert live.sum() == 9
    _compare(_named(got[4]), _named(ref[4]), live)


def test_cpu_wrapper_is_the_plain_version(passes):
    _, got, wrapped, _, _ = passes
    for part_got, part_wrapped in ((got[:4], wrapped[:4]),
                                   (got[4], wrapped[4])):
        a, b = _named(part_got), _named(part_wrapped)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
