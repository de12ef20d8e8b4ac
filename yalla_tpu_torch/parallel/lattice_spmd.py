"""Multi-device lattice integration: the z-slab decomposition.

Counterpart of ``yalla_tpu/parallel/lattice_spmd.py``.  The dense cube
lattice (``ops/lattice_xla.py``) splits into one z-slab of
``gz = grid_z / D`` planes per rank of a 1-D ring: slot ids are z-major,
so a rank's slab is one contiguous run of ``n_local`` slots.

* The build runs on the full state on every rank (replicated), and each
  rank keeps its slab of every slot channel.
* The pair pass runs on the slab with one plane of halo exchanged with
  each z-neighbour (``_comm.plane_exchange``; zeros, so no occupancy, at
  the ring's ends), always through the lattice kernel's wrapper with its
  ``z_halo`` (``ops/lattice_pallas.lattice_pairwise_pallas``: K1 on CUDA
  tensors; on CPU tensors its plain version, ``pairwise_on_padded`` on
  channels padded with the exchanged planes).  ``pallas`` keeps the JAX
  package's name, where it picks K1 (``True``) or the XLA stencil pass
  (``False``, JAX's default); the two compute the same function, a slab
  carries no overflow extras, so here ``pallas`` selects nothing.  On
  the card a force with no CUDA functor raises (``pair_functor``'s
  message names the plain path on CPU tensors); there is no fallback.
* The integration is local; the COM fix divides a sum over the ranks by
  the occupancy summed over the ranks; the in-loop failure flags reduce
  with a maximum over them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..dtypes import Float3
from ..ops.common import (augment, derivative, fold_pair, fold_steps,
                          grid_dims, mean_v, momentum_fix, nonfinite)
from ..ops.lattice_pallas import lattice_pairwise_pallas
from ..ops.lattice_xla import (LatticeLayout, add_at_slots, lattice_build,
                               lattice_unbuild, slot_to_stable)
from ._comm import plane_exchange, pmax, psum
from .spmd import gather_pt, make_cells_mesh

__all__ = ["make_z_mesh", "lattice_sharded_heun_steps",
           "ShardedLatticeEngine", "slab_of"]

def make_z_mesh(device="cuda", group=None):
    """This process's rank of the z ring (as ``spmd.make_cells_mesh``)."""
    return make_cells_mesh(device, group)


def _slab_dims(mesh, grid_size, z_block):
    """``(gx, gy, gz)`` of this rank's slab; the JAX package's asserts as
    ``ValueError``."""
    gx, gy, gz_full = grid_dims(grid_size)
    if gz_full % mesh.size:
        raise ValueError(f"grid z extent {gz_full} does not divide over "
                         f"{mesh.size} ranks")
    gz = gz_full // mesh.size
    if gz % z_block:
        raise ValueError(f"z_block {z_block} does not divide the local "
                         f"slab of {gz} planes")
    return gx, gy, gz


def _local_pairwise(mesh, pw_int, pw_friction, Taug, Tov, pid, n, cube_size,
                    *, dims, C, z_block, n_pad):
    """The pair pass of this rank's slab, one exchange of its edge planes
    (channels, old_v, occupancy) with its z-neighbours; sums ``[n_local]``
    in slot order.  K1 with ``z_halo`` (``lattice_pairwise_pallas``: the
    kernel on CUDA tensors, its plain version on CPU tensors)."""
    gx, gy, gz = dims
    nT = len(Taug)
    chans = list(Taug) + list(Tov) + [(pid < n_pad).to(torch.float32)]
    A = torch.stack([c.reshape(gz, gy * gx * C) for c in chans])
    lo, hi = plane_exchange(mesh, A[:, 0].contiguous(), A[:, -1].contiguous())
    z_halo = (list(lo[:nT]), list(hi[:nT]), list(lo[nT:nT + 3]),
              list(hi[nT:nT + 3]), lo[nT + 3] > 0.5, hi[nT + 3] > 0.5)
    return lattice_pairwise_pallas(
        pw_int, pw_friction, _shim(Taug, Tov, pid), n, cube_size,
        grid_size=dims, capacity=C, z_block=z_block, grid_z=gz, n_pad=n_pad,
        z_halo=z_halo)


def _shim(T, Tov, pid):
    """A slab as the pair pass takes it, the JAX package's shim: no
    ``slot_of`` table (``pid`` stands in), no extras."""
    zero = torch.zeros((), dtype=torch.int64, device=pid.device)
    return LatticeLayout(T=T, Tov=Tov, pid=pid, slot_of=pid, n_dropped=zero,
                         n_oob=zero)


def _slab(lay, offset, n_local):
    """This rank's run of slots of the layout's T, Tov and pid."""
    def part(pt):
        return type(pt)(*(a[offset:offset + n_local] for a in pt))
    return part(lay.T), part(lay.Tov), lay.pid[offset:offset + n_local]


def slab_of(layout, grid_size, capacity, n_slabs, k):
    """Slab ``k`` of ``n_slabs`` of a whole-lattice layout (no extras) as
    the z-slab pass takes it: ``(shim, z_halo, grid_z)``, the shim's T,
    Tov and pid the slab's slots (``slot_of`` is ``pid``, as in the JAX
    package's shim) and ``z_halo`` the planes next to the slab from the
    whole lattice (empty past its faces), for
    ``lattice_pairwise_pallas(..., grid_z=grid_z, n_pad=n_pad,
    z_halo=z_halo)`` with ``n_pad`` the layout's."""
    gx, gy, gz_full = grid_dims(grid_size)
    gz = gz_full // n_slabs
    plane = gx * gy * capacity
    n_local = gz * plane
    off = k * n_local
    T, Tov, pid = _slab(layout, off, n_local)

    def planes(a):
        lo = a[off - plane:off] if k > 0 else torch.zeros_like(a[:plane])
        hi = a[off + n_local:off + n_local + plane] if k < n_slabs - 1 \
            else torch.zeros_like(a[:plane])
        return lo, hi
    lo_l, hi_l = zip(*(planes(a) for a in layout.T))
    lo_ov, hi_ov = zip(*(planes(a) for a in layout.Tov))
    lo_occ, hi_occ = planes(layout.pid < layout.slot_of.shape[0])
    return _shim(T, Tov, pid), (list(lo_l), list(hi_l), list(lo_ov),
                                list(hi_ov), lo_occ, hi_occ), gz


def _gather_sums(mesh, F, sum_f, sum_v, aux):
    """Every rank's slot-order sums as the whole lattice's, one
    all-gather."""
    full = gather_pt(mesh, list(F) + [sum_f] + list(sum_v)
                     + list(aux.values()))
    nF = len(F)
    return (type(F)(*full[:nF]), full[nF], tuple(full[nF + 1:nF + 4]),
            dict(zip(aux, full[nF + 4:])))


@dataclass(frozen=True)
class ShardedLatticeEngine:
    """Neighbour engine running the lattice pass z-slab-sharded over a ring
    of ranks: a drop-in ``engine`` for ``heun_step`` and ``Solution``, so
    generic forces (links, walls) and every integrator feature compose with
    the multi-device path unchanged.  Every rank holds the full state;
    the build runs on it, the pass on the rank's slab with exchanged
    halos, and the sums return to every rank in stable-id order.  Unlike
    :func:`lattice_sharded_heun_steps` it rebuilds per pass, the
    reference's own cadence (solvers.cuh:494).  The pass is K1 with
    ``z_halo`` on CUDA tensors and its plain version on CPU tensors;
    ``pallas`` is the JAX engine's, and selects nothing here (the module
    docstring says why), so a force with no CUDA functor raises on the
    card whatever it says."""
    mesh: object
    grid_size: int | tuple = 64
    capacity: int = 8
    z_block: int = 2
    pallas: bool | None = None

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        if i_offset != 0 or i_size is not None:
            raise ValueError("ShardedLatticeEngine.pairwise takes no "
                             "(i_offset, i_size) window")
        mesh, C = self.mesh, self.capacity
        dims = _slab_dims(mesh, self.grid_size, self.z_block)
        n_local = dims[0] * dims[1] * dims[2] * C
        n_pad = X.x.shape[0]
        lay = lattice_build(X, old_v, n, cube_size, self.grid_size, C)
        T, Tov, pid = _slab(lay, mesh.rank * n_local, n_local)
        F, sum_f, sum_v, aux = _gather_sums(mesh, *_local_pairwise(
            mesh, pw_int, pw_friction, T, Tov, pid, n, cube_size,
            dims=dims, C=C, z_block=self.z_block, n_pad=n_pad))
        back = lambda t: slot_to_stable(lay, t)  # noqa: E731
        aux = back(aux)
        aux["__err_lattice_dropped"] = lay.n_dropped.to(torch.float32)
        aux["__err_out_of_grid"] = lay.n_oob.to(torch.float32)
        return back(F), back(sum_f), back(sum_v), aux


def lattice_sharded_heun_steps(mesh, n_steps, rebuild_every,
                               pw_int, pw_friction, fix_mode,
                               grid_size, capacity, z_block,
                               X, old_v, n, dt, cube_size, fix_point,
                               precompute=None, pallas=None,
                               gen=None, gen_args=None):
    """``n_steps`` Heun steps, the lattice's z-slabs over the ranks of
    ``mesh``: the semantics of the single-device ``lattice_heun_steps``
    (COM and point fixes, friction mixing, the in-loop failure flags).
    ``X`` and ``old_v`` are the full stable-order state, the same on every
    rank, and so are the results; ``n`` is a Python int.  ``pallas`` as
    :class:`ShardedLatticeEngine`'s: JAX's name, which selects nothing
    here; the pass is K1 with ``z_halo`` on CUDA tensors and its plain
    version on CPU tensors.

    Each chunk of ``rebuild_every`` steps bins the state once (the whole
    lattice on every rank), runs the chunk on the rank's slab, then
    gathers the slabs and unbuilds them to stable ids.  ``gen`` (a
    ``GenericForce``) + ``gen_args`` run the generic forces inside the
    chunk: per pass the slot channels are gathered to stable order, the
    hook runs on every rank alike, and each rank adds the rows whose slot
    lies in its slab.

    Held on purpose, as in the JAX package: at ``rebuild_every == 1`` the
    state is binned once per step (both Heun passes share the step's
    binning), where the single-device integrator rebuilds per pass; use
    :class:`ShardedLatticeEngine` with ``heun_step`` for per-pass
    binning."""
    if rebuild_every < 1 or n_steps % rebuild_every:
        raise ValueError(f"lattice_sharded_heun_steps: n_steps {n_steps} "
                         f"is not a multiple of rebuild_every "
                         f"{rebuild_every}")
    C = capacity
    dims = _slab_dims(mesh, grid_size, z_block)
    n_local = dims[0] * dims[1] * dims[2] * C
    offset = mesh.rank * n_local
    n_pad = X.x.shape[0]
    dev = X.x.device

    def local_chunk(lay):
        """``rebuild_every`` steps on this rank's slab of ``lay``."""
        T, Tov, pid = _slab(lay, offset, n_local)
        occ = pid < n_pad
        n_occ = psum(mesh, occ.sum())

        def deriv(T, Tov):
            Taug = augment(T, n, precompute)
            out = _local_pairwise(
                mesh, pw_int, pw_friction, Taug, Tov, pid, n, cube_size,
                dims=dims, C=C, z_block=z_block, n_pad=n_pad)
            add_gen = None
            if gen is not None:
                def add_gen(F):
                    # the hook on the whole state in stable order, alike
                    # on every rank; each adds the rows of its slab
                    dXg = gen.fn(slot_to_stable(lay, gather_pt(mesh, T)), n,
                                 gen_args)
                    return add_at_slots(F, dXg, lay.slot_of, offset,
                                        offset + n_local, gen.fields)
            dX, aux = derivative(pw_int, out, Taug, type(T), occ, add_gen)
            dX, = momentum_fix([(dX, occ, pid)], n_occ, fix_mode, fix_point,
                               lambda t: psum(mesh, t))
            return dX, aux

        acc = None
        for _ in range(rebuild_every):
            d1, aux1 = deriv(T, Tov)
            T1 = T + d1 * dt
            d2, aux = deriv(T1, Tov)
            acc = fold_steps(acc, fold_pair(aux, aux1))
            T = T + (d1 + d2) * (0.5 * dt)
            Tov = mean_v(d1, d2)
        bad = nonfinite([torch.where(occ, a, 0.0) for a in (*T, *Tov)])
        bad = pmax(mesh, bad.to(torch.int32)) > 0
        return T, Tov, acc, bad

    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    dropped, oob = zero_i, zero_i
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    auxs = None
    for _ in range(n_steps // rebuild_every):
        lay = lattice_build(X, old_v, n, cube_size, grid_size, C)
        dropped = torch.maximum(dropped, lay.n_dropped)
        oob = torch.maximum(oob, lay.n_oob)
        T, Tov, aux, bad_c = local_chunk(lay)
        # the slabs (state and sums) back to the whole lattice, one
        # all-gather, then to stable ids
        nT = len(T)
        full = gather_pt(mesh, list(T) + list(Tov) + list(aux.values()))
        lay = lay._replace(T=type(T)(*full[:nT]),
                           Tov=Float3(*full[nT:nT + 3]))
        X, old_v = lattice_unbuild(lay, X, old_v)
        aux_st = slot_to_stable(lay, dict(zip(aux, full[nT + 3:])))
        bad = bad | bad_c | nonfinite(X)
        auxs = fold_steps(auxs, aux_st)
    aux = dict(auxs)
    aux["__err_lattice_dropped"] = dropped
    aux["__err_out_of_grid"] = oob
    aux["__err_non_finite"] = bad
    return X, old_v, aux
