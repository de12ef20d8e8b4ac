"""A z-slab of the lattice pass against the JAX package: K1's plain version
with ``z_halo`` and ``pairwise_on_padded``, on one slab.

The settled 600-cell branching state at gs 16, C 8 (the polarity
precompute's channels, the branching force): a slab of the whole lattice
with its two neighbouring planes taken from that lattice
(``parallel.lattice_spmd.slab_of``).  Against JAX's
``lattice_pairwise_pallas(..., z_halo=...)`` in interpret mode and JAX's
``pairwise_on_padded``: the counters (the friction sum, ``epi_nbs``)
exact, the other sums within the reference's ``isclose``
(``tests/helpers.py``), on the slab's occupied slots (the JAX kernel
leaves garbage in empty ones).  Within the port, each slab's sums equal
the whole lattice's pass on that slab bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import isclose
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
from yalla_tpu_torch.parallel.lattice_spmd import slab_of
from yalla_tpu_torch.solvers import augment as t_augment

torch.set_num_threads(2)

N, GS, C, ZB = 600, 16, 8, 2
COUNTERS = ("sum_f", "epi_nbs")


@pytest.fixture(scope="module")
def lattices():
    """The JAX and the port's whole-lattice layouts, augmented."""
    X, ov = settled_600()
    jlay = JL.lattice_build(jax_pt(JB.Cell, X), jax_pt(jdt.Float3, ov),
                            jnp.int32(N), jnp.float32(1.0), GS, C)
    jlay = jlay._replace(T=j_augment(jlay.T, N, j_pre3))
    tlay = TL.lattice_build(pt_from_numpy(TB.Cell, X, device="cpu"),
                            pt_from_numpy(tdt.Float3, ov, device="cpu"), N,
                            1.0, GS, C)
    assert int(tlay.n_dropped) == 0
    tlay = tlay._replace(T=t_augment(tlay.T, N, TB.precompute))
    return jlay, tlay


def _named(outs):
    F, sum_f, sum_v, aux = outs
    d = {f"F.{f}": a for f, a in zip(F._fields, F)}
    d["sum_f"] = sum_f
    d.update({f"sum_v{c}": a for c, a in enumerate(sum_v)})
    d.update(aux)
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in d.items()}


def _compare(port, ref, mask):
    port, ref = _named(port), _named(ref)
    assert set(port) == set(ref)
    for k in ref:
        a, b = port[k][mask], ref[k][mask]
        if k in COUNTERS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert isclose(a, b), (k, np.abs(a - b).max())


def _jax_slab(jlay, n_slabs, k):
    """The JAX package's shim and z_halo of slab ``k`` (its
    ``_pallas_local_pairwise``'s, the planes from the whole lattice)."""
    plane = GS * GS * C
    n_local = GS // n_slabs * plane
    off = k * n_local
    n_pad = jlay.slot_of.shape[0]

    def planes(a):
        lo = a[off - plane:off] if k > 0 else jnp.zeros_like(a[:plane])
        hi = a[off + n_local:off + n_local + plane] \
            if k < n_slabs - 1 else jnp.zeros_like(a[:plane])
        return lo, hi
    leaves = list(jlay.T)
    lo_l, hi_l = zip(*(planes(a) for a in leaves))
    lo_ov, hi_ov = zip(*(planes(a) for a in jlay.Tov))
    lo_occ, hi_occ = planes(jlay.pid < n_pad)
    sl = slice(off, off + n_local)
    pid = jlay.pid[sl]
    shim = JL.LatticeLayout(T=type(jlay.T)(*(a[sl] for a in leaves)),
                            Tov=jdt.Float3(*(a[sl] for a in jlay.Tov)),
                            pid=pid, slot_of=pid, n_dropped=jnp.int32(0),
                            n_oob=jnp.int32(0))
    return shim, (list(lo_l), list(hi_l), list(lo_ov), list(hi_ov), lo_occ,
                  hi_occ), n_pad


def test_zhalo_plain_matches_jax_kernel(lattices):
    """K1's plain version with ``z_halo`` on the lower slab of two (its
    cells in planes 4-7, the upper halo plane 8 full of cells) against
    JAX's ``lattice_pairwise_pallas(z_halo=...)`` in interpret mode."""
    jlay, tlay = lattices
    force = TB.make_force(TB.Params())
    jshim, jhalo, n_pad = _jax_slab(jlay, 2, 0)
    ref = j_pass(JB.make_force(JB.Params()), j_friction, jshim, jnp.int32(N),
                 jnp.float32(1.0), grid_size=GS, capacity=C, z_block=ZB,
                 grid_z=GS // 2, n_pad=n_pad, z_halo=jhalo)
    shim, halo, gz = slab_of(tlay, GS, C, 2, 0)
    got = lattice_pairwise_pallas(force, t_friction, shim, N, 1.0,
                                  grid_size=GS, capacity=C, z_block=ZB,
                                  grid_z=gz, n_pad=n_pad, z_halo=halo)
    occ = shim.pid.numpy() < n_pad
    assert occ.sum() > 200 and halo[5].sum() > 50
    _compare(got, ref, occ)


def _padded(leaves, n_slabs, k, plane_fill):
    """Slab ``k``'s channels with the whole lattice's neighbouring planes
    and empty y rows, ``[gz + 2, gy + 2, W]``, as numpy."""
    gz, W = GS // n_slabs, GS * C
    out = []
    for a, fill in zip(leaves, plane_fill):
        a = np.asarray(a).reshape(GS, GS, W)
        a = np.concatenate([np.full((1, GS, W), fill, a.dtype), a,
                            np.full((1, GS, W), fill, a.dtype)])
        a = a[k * gz:k * gz + gz + 2]
        out.append(np.pad(a, ((0, 0), (1, 1), (0, 0)),
                          constant_values=fill))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_pairwise_on_padded_matches_jax(lattices, k):
    """``pairwise_on_padded`` on each slab of two, the planes and ids from
    the whole lattice (stable ids in the halo planes), against JAX's."""
    jlay, tlay = lattices
    n_pad = tlay.slot_of.shape[0]
    T = tlay.T
    nT = len(T)
    chans = list(T) + list(tlay.Tov) + [tlay.pid < n_pad, tlay.pid]
    padded = _padded([a.numpy() for a in chans], 2, k,
                     [0.0] * (nT + 3) + [False, n_pad])
    tP = type(T)(*(torch.as_tensor(a) for a in padded[:nT]))
    tov = tdt.Float3(*(torch.as_tensor(a) for a in padded[nT:nT + 3]))
    got = TL.pairwise_on_padded(
        TB.make_force(TB.Params()), t_friction, tP, tov,
        torch.as_tensor(padded[nT + 3]), torch.as_tensor(padded[nT + 4]),
        1.0, grid_size=GS, capacity=C, z_block=ZB)
    jP = type(jlay.T)(*(jnp.asarray(a) for a in padded[:nT]))
    ref = JL.pairwise_on_padded(
        JB.make_force(JB.Params()), j_friction, jP,
        jdt.Float3(*(jnp.asarray(a) for a in padded[nT:nT + 3])),
        jnp.asarray(padded[nT + 3]),
        jnp.asarray(padded[nT + 4].astype(np.int32)), jnp.float32(1.0),
        grid_size=GS, capacity=C, z_block=ZB)
    occ = padded[nT + 3][1:-1, 1:-1].reshape(-1)
    assert occ.sum() > 200
    _compare(got, ref, occ)


@pytest.mark.parametrize("n_slabs", [1, 2, 4])
def test_slab_equals_whole_lattice(lattices, n_slabs):
    """Each slab's pass (the plain K1 with ``z_halo``) equals the whole
    lattice's pass on that slab, every sum bit for bit; one slab of all
    planes with empty ``z_halo`` planes past its faces too."""
    _, tlay = lattices
    force = TB.make_force(TB.Params())
    n_pad = tlay.slot_of.shape[0]
    whole = lattice_pairwise_plain(force, t_friction, tlay, N, 1.0,
                                   grid_size=GS, capacity=C, z_block=ZB)
    n_local = GS // n_slabs * GS * GS * C
    for k in range(n_slabs):
        shim, halo, gz = slab_of(tlay, GS, C, n_slabs, k)
        got = lattice_pairwise_pallas(force, t_friction, shim, N, 1.0,
                                      grid_size=GS, capacity=C, z_block=ZB,
                                      grid_z=gz, n_pad=n_pad,
                                      z_halo=halo)
        sl = slice(k * n_local, (k + 1) * n_local)
        for name, a in _named(got).items():
            np.testing.assert_array_equal(a, _named(whole)[name][sl],
                                          err_msg=f"slab {k} {name}")


@pytest.mark.parametrize("given", ["grid_z", "z_halo"])
def test_slab_needs_grid_z_and_z_halo(lattices, given):
    """A z-slab names its planes and its halo together: ``grid_z``
    without ``z_halo``, or ``z_halo`` without ``grid_z``, is refused."""
    _, tlay = lattices
    shim, halo, gz = slab_of(tlay, GS, C, 2, 0)
    slab = {"grid_z": gz} if given == "grid_z" else {"z_halo": halo}
    with pytest.raises(ValueError, match="together"):
        lattice_pairwise_pallas(TB.make_force(TB.Params()), t_friction,
                                shim, N, 1.0, grid_size=GS, capacity=C,
                                z_block=ZB, n_pad=tlay.slot_of.shape[0],
                                **slab)


def test_zhalo_refuses_extras(lattices):
    """A layout with overflow extras and ``z_halo`` is refused (the JAX
    package's slab shim carries no extras)."""
    _, tlay = lattices
    X, ov = settled_600()
    elay = TL.lattice_build(pt_from_numpy(TB.Cell, X, device="cpu"),
                            pt_from_numpy(tdt.Float3, ov, device="cpu"), N,
                            1.0, GS, 4, 64)
    shim, halo, gz = slab_of(tlay, GS, C, 2, 0)
    with pytest.raises(ValueError, match="extras"):
        lattice_pairwise_pallas(TB.make_force(TB.Params()), t_friction,
                                elay, N, 1.0, grid_size=GS, capacity=4,
                                z_block=ZB, grid_z=gz, n_pad=640,
                                z_halo=halo)
