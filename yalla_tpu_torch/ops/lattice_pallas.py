"""Lattice pair pass (kernel K1) and its plain version.

Counterpart of ``yalla_tpu/ops/lattice_pallas.py::lattice_pairwise_pallas``.
Same layout contract and returns as the JAX function: per-slot sums
``(F, sum_friction, sum_v, aux)``, all ``[n_slots]``, plus the same 4-tuple
in extras order when the layout carries overflow extras (with the scalar
``__err_extras_block`` in its aux).

* ``lattice_pairwise_pallas`` is the kernel wrapper: a CUDA tensor goes to
  ``csrc/lattice_pair.cu``, a CPU tensor to ``lattice_pairwise_plain``.
  The kernel runs forces that declare a device functor
  (``ops/functors.py``: ``branching``, ``intercalation_w_gradient``) and
  refuses the rest on the GPU; :func:`lattice_plan` sizes its bricks of
  cubes and their shared memory from the functor's channel count and the
  x reach.
* ``lattice_pairwise_plain`` is generic over any torch force: the
  stencil lattice pass of ``lattice_xla`` plus an extras pass built on
  ``evaluate_pairs``.

Thin x-cubes (``x_split = k > 1``, the JAX package's option): x is binned
at ``cube_size / k``, ``gx`` counts the thin cubes, and every pass reaches
+-k cubes in x (+-1 in y and z); the cutoff stays ``cube_size``.

A z-slab (the multi-device path, ``parallel/lattice_spmd.py``): the layout
holds the slab's ``grid_z`` planes, ``n_pad`` is the empty-slot sentinel,
and ``z_halo`` the neighbours' exchanged planes, as in the JAX function.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils.profiling import count
from .common import cube_coord, cube_ids, evaluate_pairs, grid_dims
from .functors import pair_functor, param_array, require, unpack_sums
from .lattice_xla import (_pad_axis, lattice_pairwise_resident,
                          pairwise_on_padded, stencil_slots)

__all__ = ["lattice_pairwise_pallas", "lattice_pairwise_plain",
           "extras_block_overflow", "lattice_plan", "LatticePlan",
           "DEFAULT_Y_BLOCK"]

# y-block height of the JAX kernel's (z, y) blocks; its extras sidecar
# tables are per block, and ``__err_extras_block`` counts their overflow
DEFAULT_Y_BLOCK = 16


# csrc/lattice_pair.cu: threads per block, the in-reach partners a lane
# lists, and the shared memory a block may take on the H100 (227 KB; above
# 48 KB only by opting in).  A functor's channels are its fields and old_v
# x y z: 12 for branching, 16 for intercalation_w_gradient.
LATTICE_THREADS = 256
LATTICE_LIST = 8
SMEM_MAX = 232_448
# bricks (bz, by, bx) of cubes per block, largest first; the plan takes the
# first whose shared memory fits SMEM_BUDGET (two blocks per SM, each with
# 1 KB reserved)
BRICKS = ((2, 4, 8), (2, 2, 8), (1, 2, 8), (1, 1, 8), (1, 1, 4), (1, 1, 2),
          (1, 1, 1))
SMEM_BUDGET = 112 * 1024


class LatticePlan(NamedTuple):
    """Launch plan of the lattice pair kernel: ``brick`` (bz, by, bx) cubes
    per block, the dynamic shared-memory bytes ``smem`` per block (the
    kernel opts in above the default 48 KB), and the number of ``blocks``
    (ragged bricks at the grid's edge masked)."""
    brick: tuple
    smem: int
    blocks: int


def lattice_smem_bytes(brick, capacity, n_chans, x_split=1):
    """Shared-memory bytes of one block of a functor of ``n_chans``
    channels (``csrc/lattice_pair.cu`` ``smem_bytes``): for each halo slot
    a list entry of x, y, z and its id (16 bytes) and its other
    ``n_chans - 3`` channels, the live count before each cube of each halo
    x-row, two ints per halo cube, the work list, and two 16-bit lists of
    partners in reach per lane.  The halo reaches ``x_split`` cubes on
    each side in x, one in y and z."""
    bz, by, bx = brick
    hx, rows = bx + 2 * x_split, (by + 2) * (bz + 2)
    H = hx * rows
    B = bz * by * bx
    HC = H * capacity
    return 16 * HC + 4 * (n_chans - 3) * HC + 4 * rows * (hx + 1) + \
        8 * H + 4 * (B + 1) + 4 * B * capacity + \
        4 * LATTICE_LIST * LATTICE_THREADS


def _halo_fits(brick, capacity, x_split):
    """The kernel's limits on a halo: its x extent in 5 bits, its slots in
    16-bit places and, a byte each, in the partner lists' room."""
    bz, by, bx = brick
    HC = (bx + 2 * x_split) * (by + 2) * (bz + 2) * capacity
    return bx + 2 * x_split <= 32 and \
        HC <= min(65535, 4 * LATTICE_LIST * LATTICE_THREADS)


@functools.lru_cache(maxsize=64)
def lattice_plan(grid_size, capacity, n_chans, x_split=1):
    """The brick, halo, shared memory and blocks of the lattice pair kernel
    on a ``grid_size`` grid of ``capacity`` slots per cube, for a functor
    of ``n_chans`` channels and an x reach of ``x_split`` cubes.  Bricks
    are clipped to the grid; raises if not even one cube and its halo fit
    the card's shared memory and the kernel's limits."""
    gx, gy, gz = grid_dims(grid_size)
    C = int(capacity)
    if C < 1 or min(gx, gy, gz) < 1 or gx * gy * gz * C >= 2 ** 31 \
            or n_chans < 3 or x_split < 1:
        raise ValueError(f"lattice_plan: grid {(gx, gy, gz)}, capacity {C}, "
                         f"{n_chans} channels, x_split {x_split}")
    fitting = [b for b in ((min(bz, gz), min(by, gy), min(bx, gx))
                           for bz, by, bx in BRICKS)
               if _halo_fits(b, C, x_split)]
    if not fitting:
        raise ValueError(f"lattice_plan: x_split {x_split} at capacity {C}: "
                         f"no brick's halo fits the kernel's limits")
    for brick in fitting:
        smem = lattice_smem_bytes(brick, C, n_chans, x_split)
        if smem <= SMEM_BUDGET:
            break
    if smem > SMEM_MAX:
        raise ValueError(f"lattice_plan: capacity {C} needs {smem} bytes of "
                         f"shared memory for one cube and its halo, above "
                         f"the card's {SMEM_MAX}")
    bz, by, bx = brick
    blocks = -(-gz // bz) * -(-gy // by) * -(-gx // bx)
    return LatticePlan(brick, smem, blocks)


def _y_block(gy):
    """Height of the flag's y blocks: the JAX kernel's where it accepts the
    grid (``gy % 8 == 0``: the largest multiple of 8 up to
    ``DEFAULT_Y_BLOCK`` that divides ``gy``), else ``DEFAULT_Y_BLOCK`` rows
    with a ragged last block (the CUDA kernel takes any grid)."""
    yb = max((DEFAULT_Y_BLOCK // 8) * 8, 8)
    if gy % 8:
        return yb
    while gy % yb:
        yb -= 8
    return yb


def extras_block_overflow(layout, cube_size, grid_size, z_block,
                          extras_block_cap):
    """``__err_extras_block`` of the JAX kernel, in plain torch.

    The JAX kernel tables each live extra in every (z_block, y_block)
    block whose cube range meets the extra's +-1-cube reach in z and y
    (at most 2 x 2 blocks), with at most ``max(cap // 8 * 8, 8)`` extras
    per block (``lattice_pallas._extras_tables``).  This counts the table
    entries past that cap, so both packages raise on the same states.
    Where the JAX kernel refuses the grid (an extent its blocks do not
    divide) the last block of the axis is ragged.  The blocks span whole
    x rows, so thin x-cubes do not change the count."""
    gx, gy, gz = grid_dims(grid_size)
    zb, yb = z_block, _y_block(gy)
    nz, ny = -(-gz // zb), -(-gy // yb)
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


def _check_slab(layout, grid_z, z_halo):
    """Refuse a slab with overflow extras (the JAX package's z-slab shim
    carries none), a ``z_halo`` that is not six parts, and one of
    ``grid_z`` and ``z_halo`` without the other."""
    if (grid_z is None) != (z_halo is None):
        raise ValueError("lattice pair pass: a z-slab takes grid_z and "
                         "z_halo together")
    if z_halo is None:
        return
    if layout.E is not None:
        raise ValueError("lattice pair pass: z_halo takes no overflow "
                         "extras")
    if len(z_halo) != 6:
        raise ValueError("lattice pair pass: z_halo is (lo_leaves, "
                         "hi_leaves, lo_ov, hi_ov, lo_occ, hi_occ)")


def slab_on_padded(pw_int, pw_friction, layout, cube_size, *, grid_size,
                   capacity, grid_z, n_pad, z_halo, x_split=1):
    """The pair pass of a z-slab of ``grid_z`` planes with its exchanged
    planes (``z_halo``) through :func:`lattice_xla.pairwise_on_padded`.
    The halo planes' slots take ids from ``n_pad + 1`` on (the planes
    carry no ids; ``i == j`` must hold on the diagonal only)."""
    lo_l, hi_l, lo_ov, hi_ov, lo_occ, hi_occ = z_halo
    gx, gy, _ = grid_dims(grid_size)
    W = gx * capacity
    plane = gy * W

    def stack(lo, a, hi, fill):
        a = torch.cat([lo.reshape(1, gy, W), a.reshape(grid_z, gy, W),
                       hi.reshape(1, gy, W)])
        return _pad_axis(a, 1, 1, 1, fill)
    T = layout.T
    P = type(T)(*(stack(lo, a, hi, 0.0)
                  for lo, a, hi in zip(lo_l, T, hi_l)))
    Pov = type(layout.Tov)(*(stack(lo, a, hi, 0.0)
                             for lo, a, hi in zip(lo_ov, layout.Tov, hi_ov)))
    Pocc = stack(lo_occ, layout.pid < n_pad, hi_occ, False)
    ids = torch.arange(n_pad + 1, n_pad + 1 + 2 * plane,
                       device=layout.pid.device)
    Ppid = stack(ids[:plane], layout.pid, ids[plane:], n_pad)
    return pairwise_on_padded(pw_int, pw_friction, P, Pov, Pocc, Ppid,
                              cube_size, grid_size=gx, capacity=capacity,
                              x_split=x_split)


def lattice_pairwise_plain(pw_int, pw_friction, layout, n, cube_size, *,
                           grid_size, capacity, z_block,
                           extras_block_cap=16, grid_z=None, n_pad=None,
                           z_halo=None, x_split=1):
    """Plain torch version of the pair pass, generic over the force.

    The lattice-lattice sums are ``lattice_pairwise_resident``'s; with
    overflow extras, each extra's stencil of lattice slots (+-1 cube in z
    and y, +-``x_split`` in x) is evaluated both ways (the lattice sides
    scatter-added into the slot sums) and the extras pair all-against-all,
    diagonal included, as in the JAX kernel's merge.  A z-slab
    (``grid_z``, ``n_pad``, ``z_halo``) runs :func:`slab_on_padded`."""
    _check_slab(layout, grid_z, z_halo)
    if z_halo is not None:
        gx, gy, _ = grid_dims(grid_size)
        n_pad = n_pad if n_pad is not None else layout.slot_of.shape[0]
        return slab_on_padded(pw_int, pw_friction, layout, cube_size,
                              grid_size=(gx, gy, grid_z), capacity=capacity,
                              grid_z=grid_z, n_pad=n_pad, z_halo=z_halo,
                              x_split=x_split)
    F, sum_f, sum_v, aux = lattice_pairwise_resident(
        pw_int, pw_friction, layout, n, cube_size, grid_size=grid_size,
        capacity=capacity, x_split=x_split)
    if layout.E is None:
        return F, sum_f, sum_v, aux

    pw_off = getattr(pw_int, "offdiag", None) or pw_int
    n_pad = layout.slot_of.shape[0]
    E, T = layout.E, layout.T
    gx, gy, gz = grid_dims(grid_size)
    live = layout.epid < n_pad
    slots, ok = stencil_slots(cube_coord(E.x, cube_size / x_split, gx),
                              cube_coord(E.y, cube_size, gy),
                              cube_coord(E.z, cube_size, gz), grid_size,
                              capacity, x_split)
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
                            extras_block_cap=16, grid_z=None, n_pad=None,
                            z_halo=None, x_split=1):
    """Lattice pair-pass wrapper: launches ``csrc/lattice_pair.cu`` for
    CUDA tensors, runs :func:`lattice_pairwise_plain` for CPU tensors,
    raises for anything else; a launch counts in ``kernels.lattice_pair``
    (``utils.profiling``).  ``z_block`` is the JAX kernel's block height, which
    sets the blocks of ``__err_extras_block``; ``x_split`` the thin
    x-cubes' reach.

    A z-slab, as in the JAX function: ``grid_z`` is the slab's own z
    extent, ``n_pad`` the empty-slot sentinel of ``layout.pid`` (where
    ``slot_of`` is not the stable ids' table), and ``z_halo`` the planes
    past its z faces from the neighbouring slabs, ``(lo_leaves,
    hi_leaves, lo_ov, hi_ov, lo_occ, hi_occ)``, each a ``[gy * gx * C]``
    plane (the leaves in the order of ``layout.T``'s fields, the
    occupancy bool).  ``grid_z`` and ``z_halo`` come together.  Sums are
    returned for the slab's own slots; a slab with overflow extras is
    refused."""
    dev = layout.pid.device
    if dev.type == "cpu":
        return lattice_pairwise_plain(
            pw_int, pw_friction, layout, n, cube_size, grid_size=grid_size,
            capacity=capacity, z_block=z_block,
            extras_block_cap=extras_block_cap, grid_z=grid_z, n_pad=n_pad,
            z_halo=z_halo, x_split=x_split)
    if dev.type != "cuda":
        raise ValueError(f"lattice pair kernel: unsupported device {dev}")
    _check_slab(layout, grid_z, z_halo)
    from .. import _build
    spec, params = _force_spec(pw_int, pw_friction)
    gx, gy, gz = grid_dims(grid_size)
    if grid_z is not None:
        gz = grid_z
    C = capacity
    n_cubes = gx * gy * gz
    n_slots = n_cubes * C
    if n_pad is None:
        n_pad = layout.slot_of.shape[0]
    f32 = torch.float32

    def channels(P, ov, size, what):
        what = f"lattice pair kernel: {what}"
        return [require(getattr(P, f), (size,), f32, dev, f"{what}.{f}")
                for f in spec["fields"]] + \
            [require(a, (size,), f32, dev, f"{what} old_v") for a in ov]

    chans = channels(layout.T, layout.Tov, n_slots, "T")
    occ = (layout.pid < n_pad).to(torch.uint8)
    if z_halo is not None:
        halo = []
        for k, side in enumerate(("lo", "hi")):
            leaves = type(layout.T)(*z_halo[k])
            halo.append(channels(leaves, z_halo[2 + k], gx * gy * C,
                                 f"z_halo {side}"))
        lo_chans, hi_chans = (_build.pointers(h) for h in halo)
        lo_occ, hi_occ = (require(o, (gx * gy * C,), torch.bool, dev,
                                  "lattice pair kernel: z_halo occupancy")
                          .to(torch.uint8) for o in z_halo[4:])
        z_args = (lo_chans, hi_chans, lo_occ.data_ptr(), hi_occ.data_ptr())
    else:
        z_args = (None, None, None, None)
    M = len(spec["dF"]) + len(spec["aux"]) + 4
    out = torch.empty((M, n_slots), dtype=f32, device=dev)
    has_e = layout.E is not None
    if has_e:
        E_cap = layout.epid.shape[0]
        echans = channels(layout.E, layout.Eov, E_cap, "E")
        ecube = torch.where(layout.epid < n_pad,
                            cube_ids(layout.E, E_cap, cube_size, grid_size,
                                     x_split),
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
    plan = lattice_plan((gx, gy, gz), C, len(chans), int(x_split))
    lib = _build.library()
    count("kernels.lattice_pair")
    _build.check(getattr(lib, spec["entries"]["lattice"])(
        _build.pointers(chans), occ.data_ptr(), *z_args, *e_args, gx, gy,
        gz, C,
        float(cube_size), int(x_split), *plan.brick, plan.smem,
        param_array(spec, params), out.data_ptr(),
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
