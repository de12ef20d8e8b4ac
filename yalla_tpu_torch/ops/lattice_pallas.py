"""Lattice pair pass (kernel K1) and its plain version.

Counterpart of ``yalla_tpu/ops/lattice_pallas.py::lattice_pairwise_pallas``.
Same layout contract and returns as the JAX function: per-slot sums
``(F, sum_friction, sum_v, aux)``, all ``[n_slots]``, plus the same 4-tuple
in extras order when the layout carries overflow extras (with the scalar
``__err_extras_block`` in its aux).

* ``lattice_pairwise_pallas`` is the kernel wrapper: a CUDA tensor goes to
  ``csrc/lattice_pair.cu``, a CPU tensor to ``lattice_pairwise_plain``.
  The kernel runs forces that declare a device functor
  (``ops/functors.py``) and refuses the rest on the GPU.
* ``lattice_pairwise_plain`` is generic over any torch force: the
  stencil lattice pass of ``lattice_xla`` plus an extras pass built on
  ``evaluate_pairs``.
"""
from __future__ import annotations

import torch

from .common import cube_coord, cube_ids, evaluate_pairs, grid_dims
from .functors import pair_functor, param_array, require, unpack_sums
from .lattice_xla import lattice_pairwise_resident, stencil_slots

__all__ = ["lattice_pairwise_pallas", "lattice_pairwise_plain",
           "extras_block_overflow", "DEFAULT_Y_BLOCK"]

# y-block height of the JAX kernel's (z, y) blocks; its extras sidecar
# tables are per block, and ``__err_extras_block`` counts their overflow
DEFAULT_Y_BLOCK = 16


def _y_block(gy):
    yb = max((DEFAULT_Y_BLOCK // 8) * 8, 8)
    while gy % yb:
        yb -= 8
    assert yb >= 8, "grid y extent must be a multiple of 8"
    return yb


def extras_block_overflow(layout, cube_size, grid_size, z_block,
                          extras_block_cap):
    """``__err_extras_block`` of the JAX kernel, in plain torch.

    The JAX kernel tables each live extra in every (z_block, y_block)
    block whose cube range meets the extra's +-1-cube reach in z and y
    (at most 2 x 2 blocks), with at most ``max(cap // 8 * 8, 8)`` extras
    per block (``lattice_pallas._extras_tables``).  This counts the table
    entries past that cap, so both packages raise on the same states."""
    gx, gy, gz = grid_dims(grid_size)
    zb, yb = z_block, _y_block(gy)
    nz, ny = gz // zb, gy // yb
    cap = max((extras_block_cap // 8) * 8, 8)
    live = layout.epid < layout.slot_of.shape[0]
    cz = cube_coord(layout.E.z, cube_size, gz)
    cy = cube_coord(layout.E.y, cube_size, gy)

    def blk(c, b, n_b):
        return torch.clamp(torch.div(c, b, rounding_mode="floor"), 0, n_b - 1)
    z_lo, z_hi = blk(cz - 1, zb, nz), blk(cz + 1, zb, nz)
    y_lo, y_hi = blk(cy - 1, yb, ny), blk(cy + 1, yb, ny)
    bids, valid = [], []
    for a, zi in ((0, z_lo), (1, z_hi)):
        for b, yi in ((0, y_lo), (1, y_hi)):
            dup = torch.zeros_like(live)
            if a:
                dup = dup | (z_hi == z_lo)
            if b:
                dup = dup | (y_hi == y_lo)
            bids.append(zi * ny + yi)
            valid.append(live & ~dup)
    # count table entries per block; invalid entries go to a dump block
    n_blocks = nz * ny
    bid = torch.where(torch.cat(valid), torch.cat(bids), n_blocks)
    counts = torch.zeros(n_blocks + 1, dtype=torch.int64,
                         device=bid.device).index_add_(
        0, bid, torch.ones_like(bid))[:n_blocks]
    return torch.clamp(counts - cap, min=0).sum().to(torch.float32)


def lattice_pairwise_plain(pw_int, pw_friction, layout, n, cube_size, *,
                           grid_size, capacity, z_block,
                           extras_block_cap=16):
    """Plain torch version of the pair pass, generic over the force.

    The lattice-lattice sums are ``lattice_pairwise_resident``'s; with
    overflow extras, each extra's 27-cube stencil of lattice slots is
    evaluated both ways (the lattice sides scatter-added into the slot
    sums) and the extras pair all-against-all, diagonal included, as in
    the JAX kernel's merge."""
    F, sum_f, sum_v, aux = lattice_pairwise_resident(
        pw_int, pw_friction, layout, n, cube_size, grid_size=grid_size,
        capacity=capacity)
    if layout.E is None:
        return F, sum_f, sum_v, aux

    pw_off = getattr(pw_int, "offdiag", None) or pw_int
    n_pad = layout.slot_of.shape[0]
    E, T = layout.E, layout.T
    gx, gy, gz = grid_dims(grid_size)
    live = layout.epid < n_pad
    slots, ok = stencil_slots(cube_coord(E.x, cube_size, gx),
                              cube_coord(E.y, cube_size, gy),
                              cube_coord(E.z, cube_size, gz), grid_size,
                              capacity)
    valid = ok & (layout.pid[slots] < n_pad) & live[:, None]
    Xe = type(E)(*(a[:, None] for a in E))
    XL = type(T)(*(a[slots] for a in T))
    ov_l = [a[slots] for a in layout.Tov]
    ov_e = [a[:, None] for a in layout.Eov]
    pid_l, epid = layout.pid[slots], layout.epid[:, None]

    # extra i <- lattice j
    Fe, sum_fe, sum_ve, aux_e = evaluate_pairs(
        pw_off, pw_friction, Xe, XL, ov_l, epid, pid_l, valid,
        sum_axes=(1,), cutoff=cube_size)
    # lattice i <- extra j, scattered into the slot sums
    Fl, sfl, svl, auxl = evaluate_pairs(
        pw_off, pw_friction, XL, Xe, ov_e, pid_l, epid, valid,
        sum_axes=(), cutoff=cube_size)
    flat = slots.reshape(-1)

    def scatter(acc, v):
        return acc.index_add(0, flat, v.reshape(-1))
    F = type(F)(*(scatter(a, v) for a, v in zip(F, Fl)))
    sum_f = scatter(sum_f, sfl)
    sum_v = tuple(scatter(a, v) for a, v in zip(sum_v, svl))
    aux = {k: scatter(aux[k], auxl[k]) for k in aux}

    # extras-extras pairs, including the diagonal (full force)
    F2, sf2, sv2, aux2 = evaluate_pairs(
        pw_int, pw_friction, Xe, type(E)(*(a[None, :] for a in E)),
        [a[None, :] for a in layout.Eov], epid, layout.epid[None, :],
        live[:, None] & live[None, :], sum_axes=(1,), cutoff=cube_size)
    Fe = Fe + F2
    sum_fe = sum_fe + sf2
    sum_ve = tuple(a + b for a, b in zip(sum_ve, sv2))
    aux_e = {k: aux_e[k] + aux2[k] for k in aux_e}
    aux_e["__err_extras_block"] = extras_block_overflow(
        layout, cube_size, grid_size, z_block, extras_block_cap)
    return F, sum_f, sum_v, aux, (Fe, sum_fe, sum_ve, aux_e)


def _force_spec(pw_int, pw_friction):
    """``(spec, params)`` of the force's functor in the lattice kernel."""
    return pair_functor(pw_int, pw_friction, "lattice",
                        "the plain lattice path on CPU tensors")


def lattice_pairwise_pallas(pw_int, pw_friction, layout, n, cube_size, *,
                            grid_size, capacity, z_block,
                            extras_block_cap=16):
    """Lattice pair-pass wrapper: launches ``csrc/lattice_pair.cu`` for
    CUDA tensors, runs :func:`lattice_pairwise_plain` for CPU tensors,
    raises for anything else.  ``lattice_pairwise_pallas.launches`` counts
    kernel launches.  ``z_block`` is the JAX kernel's block height, which
    sets the blocks of ``__err_extras_block``."""
    dev = layout.pid.device
    if dev.type == "cpu":
        return lattice_pairwise_plain(
            pw_int, pw_friction, layout, n, cube_size, grid_size=grid_size,
            capacity=capacity, z_block=z_block,
            extras_block_cap=extras_block_cap)
    if dev.type != "cuda":
        raise ValueError(f"lattice pair kernel: unsupported device {dev}")
    from .. import _build
    spec, params = _force_spec(pw_int, pw_friction)
    gx, gy, gz = grid_dims(grid_size)
    C = capacity
    n_cubes = gx * gy * gz
    n_slots = n_cubes * C
    n_pad = layout.slot_of.shape[0]
    f32 = torch.float32

    def channels(P, ov, size, what):
        what = f"lattice pair kernel: {what}"
        return [require(getattr(P, f), (size,), f32, dev, f"{what}.{f}")
                for f in spec["fields"]] + \
            [require(a, (size,), f32, dev, f"{what} old_v") for a in ov]

    chans = channels(layout.T, layout.Tov, n_slots, "T")
    occ = (layout.pid < n_pad).to(torch.uint8)
    M = len(spec["dF"]) + len(spec["aux"]) + 4
    out = torch.empty((M, n_slots), dtype=f32, device=dev)
    has_e = layout.E is not None
    if has_e:
        E_cap = layout.epid.shape[0]
        echans = channels(layout.E, layout.Eov, E_cap, "E")
        ecube = torch.where(layout.epid < n_pad,
                            cube_ids(layout.E, E_cap, cube_size, grid_size),
                            n_cubes)
        ecube_sorted, eorder = torch.sort(ecube)
        estart = torch.searchsorted(
            ecube_sorted, torch.arange(n_cubes + 1, device=dev))
        ecube, eorder, estart = (a.to(torch.int32).contiguous()
                                 for a in (ecube, eorder, estart))
        eout = torch.empty((M, E_cap), dtype=f32, device=dev)
        e_ptrs = _build.pointers(echans)
        e_args = (e_ptrs, ecube.data_ptr(), eorder.data_ptr(),
                  estart.data_ptr(), E_cap)
    else:
        eout = None
        e_args = (None, None, None, None, 0)
    lib = _build.library()
    lattice_pairwise_pallas.launches += 1
    _build.check(getattr(lib, spec["entries"]["lattice"])(
        _build.pointers(chans), occ.data_ptr(), *e_args, gx, gy, gz, C,
        float(cube_size), param_array(spec, params), out.data_ptr(),
        eout.data_ptr() if has_e else None, _build.stream_handle(dev)),
        "lattice pair kernel")

    F, sum_f, sum_v, aux = unpack_sums(out, spec, pw_int, type(layout.T))
    if not has_e:
        return F, sum_f, sum_v, aux
    Fe, sum_fe, sum_ve, aux_e = unpack_sums(eout, spec, pw_int,
                                            type(layout.T))
    aux_e["__err_extras_block"] = extras_block_overflow(
        layout, cube_size, grid_size, z_block, extras_block_cap)
    return F, sum_f, sum_v, aux, (Fe, sum_fe, sum_ve, aux_e)


lattice_pairwise_pallas.launches = 0
