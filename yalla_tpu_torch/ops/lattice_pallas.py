"""Lattice pair pass (kernel K1) and its plain version.

Counterpart of ``yalla_tpu/ops/lattice_pallas.py::lattice_pairwise_pallas``.
Same layout contract and returns as the JAX function: per-slot sums
``(F, sum_friction, sum_v, aux)``, all ``[n_slots]``, plus the same 4-tuple
in extras order when the layout carries overflow extras (with the scalar
``__err_extras_block`` in its aux).

* ``lattice_pairwise_pallas`` is the kernel wrapper: a CUDA tensor goes to
  ``csrc/lattice_pair.cu``, a CPU tensor to ``lattice_pairwise_plain``.
  The JAX kernel is force-generic because it traces any jnp force; a CUDA
  kernel is compiled, so a force declares the device functor that
  implements it (``force.cuda_functor``), and a force without one is
  refused on the GPU.
* ``lattice_pairwise_plain`` is generic over any torch force: the
  stencil lattice pass of ``lattice_xla`` plus an extras pass built on
  ``evaluate_pairs``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .common import (cube_coord, cube_ids, evaluate_pairs,
                     friction_w_neighbour, grid_dims, split_force_output)
from .lattice_xla import lattice_pairwise_resident, stencil_slots

__all__ = ["lattice_pairwise_pallas", "lattice_pairwise_plain",
           "extras_block_overflow", "DEFAULT_Y_BLOCK"]

# y-block height of the JAX kernel's (z, y) blocks; its extras sidecar
# tables are per block, and ``__err_extras_block`` counts their overflow
DEFAULT_Y_BLOCK = 16

# CUDA functors of csrc/lattice_pair.cu: C entry point, the Pt fields the
# kernel reads (then old_v x y z), the dF fields and aux channels it sums
# (then sum_f and sum_v x y z), and the parameter values it takes.
_FUNCTORS = {
    "branching": dict(
        entry="yalla_lattice_pair_branching",
        fields=("x", "y", "z", "u", "v", "ctype", "px", "py", "pz"),
        dF=("x", "y", "z", "u", "v"),
        aux=("epi_nbs", "pg_x", "pg_y", "pg_z"),
        params=("r_max", "lam", "D_u", "D_v", "f_v", "f_u", "g_u", "m_u",
                "m_v", "s_u")),
}


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


def _require(t, shape, dtype, device, what):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"lattice pair kernel: {what} must be a contiguous "
                         f"{dtype} {shape} tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def _force_spec(pw_int, pw_friction):
    functor = getattr(pw_int, "cuda_functor", None)
    if functor is None or functor[0] not in _FUNCTORS:
        raise ValueError(
            "lattice pair kernel: the force declares no CUDA functor "
            "(force.cuda_functor); only forces with a device functor in "
            "csrc/lattice_pair.cu run on the GPU")
    if pw_friction is not friction_w_neighbour:
        raise ValueError("lattice pair kernel: only friction_w_neighbour "
                         "is implemented on the GPU")
    spec, params = _FUNCTORS[functor[0]], functor[1]
    if getattr(params, "r_max", 1.0) != 1.0:
        raise ValueError("lattice pair kernel: the branching functor "
                         "derives mes_nbs from the friction sum, which "
                         "needs r_max == 1")
    return spec, params


@functools.lru_cache(maxsize=16)
def _dF_type(pw_int, pt_type):
    """The force's dF point type and aux keys, from one scalar probe on
    the CPU (memoised: the probe costs ~0.5 ms of host time per pass)."""
    one = torch.ones(1)
    Xi = pt_type(*([one] * len(pt_type._fields)))
    dF, aux = split_force_output(pw_int(Xi, Xi - Xi, one, one, one))
    return type(dF), tuple(aux)


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
        return [_require(getattr(P, f), (size,), f32, dev, f"{what}.{f}")
                for f in spec["fields"]] + \
            [_require(a, (size,), f32, dev, f"{what} old_v") for a in ov]

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
    pvals = (ctypes.c_float * len(spec["params"]))(
        *[float(getattr(params, k)) for k in spec["params"]])
    lib = _build.library()
    lattice_pairwise_pallas.launches += 1
    _build.check(getattr(lib, spec["entry"])(
        _build.pointers(chans), occ.data_ptr(), *e_args, gx, gy, gz, C,
        float(cube_size), pvals, out.data_ptr(),
        eout.data_ptr() if has_e else None, _build.stream_handle(dev)),
        "lattice pair kernel")

    dF_type, aux_keys = _dF_type(pw_int, type(layout.T))
    assert set(aux_keys) == set(spec["aux"]), aux_keys

    def unpack(rows):
        zero = torch.zeros_like(rows[0])
        k = len(spec["dF"])
        F = dF_type(**{f: rows[spec["dF"].index(f)] if f in spec["dF"]
                       else zero for f in dF_type._fields})
        aux = {a: rows[k + i] for i, a in enumerate(spec["aux"])}
        m = k + len(spec["aux"])
        return F, rows[m], (rows[m + 1], rows[m + 2], rows[m + 3]), aux

    F, sum_f, sum_v, aux = unpack(out)
    if not has_e:
        return F, sum_f, sum_v, aux
    Fe, sum_fe, sum_ve, aux_e = unpack(eout)
    aux_e["__err_extras_block"] = extras_block_overflow(
        layout, cube_size, grid_size, z_block, extras_block_cap)
    return F, sum_f, sum_v, aux, (Fe, sum_fe, sum_ve, aux_e)


lattice_pairwise_pallas.launches = 0
