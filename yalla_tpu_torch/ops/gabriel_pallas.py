"""Gabriel lattice pair pass (kernel K5) and its plain version.

Counterpart of ``yalla_tpu/ops/gabriel_pallas.py::gabriel_lattice_pallas``,
with the same contract as ``grid_xla.gabriel_pairwise``: per-point sums
``(F, sum_friction, sum_v, aux)`` in stable order ``[n_pad]``, with
``__err_gabriel_candidates`` per point and ``__err_lattice_dropped`` and
``__err_out_of_grid`` as scalars in aux.

Both versions build the dense lattice with ``lattice_build(...,
extras_cap=0)`` (the pour kernel K2 on the GPU) and decide as the JAX
kernel decides (``gabriel_pallas.py:188-268``):

* the candidates of point i are the occupied slots j != i of the 27 cubes
  around i's with ``dist < cube_size``; the first ``max_candidates`` (NC)
  of them, in stencil order, form the compact set; more set the flag;
* a compact candidate r is kept iff ``d2_r < cube_size^2`` and no other
  compact candidate k has ``|m - x_k|^2 < d2_r * gc2`` and
  ``d2_k < cube_size^2``, with ``m = (x_i + x_r) * 0.5`` and
  ``gc2 = (0.5 * gabriel_coefficient)^2`` (one f32 constant);
* the force and friction run on the kept pairs and once on the diagonal,
  with the points' stable ids (forces may single out a point by id, as
  ``models/growth_w_wall.py`` does with the wall node).

The blockers are all other candidates, not only closer ones as in the
gather form; the JAX kernel's docstring shows the two give the same set
for ``gabriel_coefficient < 1``.

* ``gabriel_lattice_pallas`` is the kernel wrapper: CUDA tensors go to
  ``csrc/gabriel_pair.cu`` (forces with a device functor only), CPU
  tensors to ``gabriel_lattice_plain``.  :func:`gabriel_plan` sizes the
  kernel's bricks of cubes and their shared memory.
* ``gabriel_lattice_plain`` is the same function in torch ops, generic
  over the force, over blocks of occupied slots.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count
from .common import evaluate_pairs, grid_dims
from .functors import pair_functor, param_array, require, unpack_sums
from .lattice_xla import lattice_build, stencil_slots

__all__ = ["gabriel_lattice_pallas", "gabriel_lattice_plain",
           "gabriel_plan", "GabrielPlan", "GABRIEL_MAX_NC"]

# the largest compact set the wrapper takes
GABRIEL_MAX_NC = 128
# csrc/gabriel_pair.cu: threads per block, lanes per live point, the
# largest staged list (its places take 15 bits of a compact entry), and the
# shared memory a block may take on the H100 (227 KB; above 48 KB only by
# opting in)
GABRIEL_THREADS = 256
GABRIEL_GROUP = 4
GABRIEL_MAX_STAGED = 1 << 15
SMEM_MAX = 232_448
# bricks (bz, by, bx) of cubes per block, largest first; the plan takes the
# first whose shared memory fits SMEM_BUDGET (three blocks per SM, each
# with 1 KB reserved)
BRICKS = ((4, 4, 4), (2, 4, 4), (2, 2, 4), (2, 2, 2), (1, 2, 2), (1, 1, 2),
          (1, 1, 1))
SMEM_BUDGET = 75 * 1024
# elements per block of the plain version (bounds its memory)
PAIR_BLOCK = 1 << 21


class GabrielPlan(NamedTuple):
    """Launch plan of the Gabriel lattice kernel: ``brick`` (bz, by, bx)
    cubes per block, the dynamic shared-memory bytes ``smem`` per block
    (the kernel opts in above the default 48 KB), and the number of
    ``blocks`` (ragged bricks at the grid's edge masked)."""
    brick: tuple
    smem: int
    blocks: int


def _stride(capacity):
    """A cube's stride in the kernel's staged list: the capacity rounded up
    to a power of two."""
    return 1 << (int(capacity) - 1).bit_length()


def gabriel_smem_bytes(brick, capacity, max_candidates):
    """Shared-memory bytes of one block (``csrc/gabriel_pair.cu``
    ``smem_bytes``): a 16-byte entry (x, y, z, stable id) per slot of the
    brick's one-cube halo, a cube's slots strided by the capacity rounded
    up to a power of two; a live count and a first lattice slot per halo
    cube; the work list's length; a 16-bit work-list entry per own slot;
    and a 16-bit compact set of ``max_candidates`` entries per group of
    lanes."""
    bz, by, bx = brick
    H = (bz + 2) * (by + 2) * (bx + 2)
    B = bz * by * bx
    return 16 * H * _stride(capacity) + 8 * H + 16 + 2 * B * capacity + \
        2 * (GABRIEL_THREADS // GABRIEL_GROUP) * max_candidates


@functools.lru_cache(maxsize=64)
def gabriel_plan(grid_size, capacity, max_candidates):
    """The brick, shared memory and blocks of the Gabriel lattice kernel on
    a ``grid_size`` grid of ``capacity`` slots per cube with compact sets
    of ``max_candidates``.  Bricks are clipped to the grid; raises if not
    even one cube and its halo fit the card's shared memory or the staged
    list's 15-bit places."""
    gx, gy, gz = grid_dims(grid_size)
    C, NC = int(capacity), int(max_candidates)
    if C < 1 or NC < 1 or min(gx, gy, gz) < 1 or gx * gy * gz * C >= 2 ** 31:
        raise ValueError(f"gabriel_plan: grid {(gx, gy, gz)}, capacity {C}, "
                         f"max_candidates {NC}")
    for bz, by, bx in BRICKS:
        brick = (min(bz, gz), min(by, gy), min(bx, gx))
        smem = gabriel_smem_bytes(brick, C, NC)
        if smem <= SMEM_BUDGET:
            break
    bz, by, bx = brick
    staged = (bz + 2) * (by + 2) * (bx + 2) * _stride(C)
    if smem > SMEM_MAX or staged > GABRIEL_MAX_STAGED:
        raise ValueError(
            f"gabriel_plan: capacity {C} with max_candidates {NC} needs "
            f"{smem} bytes of shared memory and {staged} staged slots for "
            f"one cube and its halo, above the card's {SMEM_MAX} bytes or "
            f"the kernel's {GABRIEL_MAX_STAGED} slots")
    blocks = -(-gz // bz) * -(-gy // by) * -(-gx // bx)
    return GabrielPlan(brick, smem, blocks)


def _squares(cube_size, gabriel_coefficient):
    """``(cube_size^2, gc2)`` as the f32 values the JAX kernel uses."""
    cs = np.float32(cube_size)
    return float(cs * cs), float(np.float32((0.5 * gabriel_coefficient) ** 2))


def _flags(lay, over):
    """The failure flags of one pass: per-point candidate overflow (stable
    order), the lattice's dropped and out-of-grid counts."""
    return {"__err_gabriel_candidates": over,
            "__err_lattice_dropped": lay.n_dropped.to(torch.float32),
            "__err_out_of_grid": lay.n_oob.to(torch.float32)}


def _compact_block(lay, i, cube_size, grid_size, capacity, NC):
    """Candidate count and first-NC compact slots (-1 where empty) of the
    occupied slots ``i``: ``([B], [B, NC])``."""
    gx, gy, _ = grid_dims(grid_size)
    T, pid = lay.T, lay.pid
    n_pad = lay.slot_of.shape[0]
    cube = torch.div(i, capacity, rounding_mode="floor")
    j, ok = stencil_slots(cube % gx, (cube // gx) % gy, cube // (gx * gy),
                          grid_size, capacity)
    rx = T.x[i, None] - T.x[j]
    ry = T.y[i, None] - T.y[j]
    rz = T.z[i, None] - T.z[j]
    dist = torch.sqrt(rx * rx + ry * ry + rz * rz)
    cand = ok & (pid[j] < n_pad) & (j != i[:, None]) & (dist < cube_size)
    rank = torch.cumsum(cand, dim=1) - 1
    dest = torch.where(cand & (rank < NC), rank, NC)
    compact = torch.full((i.shape[0], NC + 1), -1, dtype=torch.int64,
                         device=i.device).scatter_(
        1, dest, torch.where(cand, j, -1))[:, :NC]
    return cand.sum(dim=1), compact


def _keep(Ti, Tc, valid, cs2, gc2):
    """Kept mask ``[B, NC]`` of the midpoint test on the compact set:
    ``Ti`` the points' positions ``[B, 1]``, ``Tc`` the candidates'
    ``[B, NC]``, every product and sum rounded as the kernel rounds it."""
    def sq(a):
        return a * a
    d2 = torch.where(valid, sq(Ti.x - Tc.x) + sq(Ti.y - Tc.y)
                     + sq(Ti.z - Tc.z), torch.inf)
    mx, my, mz = (Ti.x + Tc.x) * 0.5, (Ti.y + Tc.y) * 0.5, (Ti.z + Tc.z) * 0.5
    dk2 = (sq(mx[:, :, None] - Tc.x[:, None, :])
           + sq(my[:, :, None] - Tc.y[:, None, :])
           + sq(mz[:, :, None] - Tc.z[:, None, :]))      # [B, r, k]
    near = d2 < cs2
    NC = d2.shape[1]
    other = ~torch.eye(NC, dtype=torch.bool, device=d2.device)
    blocked = ((dk2 < (d2 * gc2)[:, :, None]) & near[:, None, :]
               & other).any(dim=2)
    return near & ~blocked


def gabriel_lattice_plain(pw_int, pw_friction, X, old_v, n, cube_size, *,
                          grid_size, capacity, max_candidates=20,
                          gabriel_coefficient=0.8, lay=None):
    """Plain torch version of the Gabriel lattice pass, generic over the
    force: a ``[B, 27 C]`` candidate block per block of occupied slots,
    first-NC compaction, the ``[B, NC, NC]`` midpoint test and
    ``evaluate_pairs`` on the kept pairs and on the diagonal.  ``lay`` is
    the state's lattice build where the caller made it."""
    NC = int(max_candidates)
    cs2, gc2 = _squares(cube_size, gabriel_coefficient)
    if lay is None:
        lay = lattice_build(X, old_v, n, cube_size, grid_size, capacity, 0)
    T, pid = lay.T, lay.pid
    n_pad = lay.slot_of.shape[0]
    i_all = torch.nonzero(pid < n_pad).squeeze(1)
    block = max(1, PAIR_BLOCK // max(27 * capacity, NC * NC))
    ids, parts = [], []
    for i in i_all.split(block) or (i_all,):
        count, compact = _compact_block(lay, i, cube_size, grid_size,
                                        capacity, NC)
        valid = compact >= 0
        jc = torch.clamp(compact, min=0)
        Ti = type(T)(*(a[i, None] for a in T))
        Tc = type(T)(*(a[jc] for a in T))
        keep = _keep(Ti, Tc, valid, cs2, gc2)
        F, sum_f, sum_v, aux = evaluate_pairs(
            pw_int, pw_friction, Ti, Tc, [a[jc] for a in lay.Tov],
            pid[i, None], pid[jc], keep, sum_axes=(1,))
        Td = type(T)(*(a[i] for a in T))
        Fd, sum_fd, sum_vd, auxd = evaluate_pairs(
            pw_int, pw_friction, Td, Td, [a[i] for a in lay.Tov], pid[i],
            pid[i], torch.ones_like(i, dtype=torch.bool), sum_axes=())
        parts.append((F + Fd, sum_f + sum_fd,
                      tuple(a + b for a, b in zip(sum_v, sum_vd)),
                      {k: aux[k] + auxd[k] for k in aux},
                      (count > NC).to(torch.float32)))
        ids.append(pid[i])
    stable = torch.cat(ids)

    def back(vals):
        out = torch.zeros(n_pad, dtype=torch.float32, device=pid.device)
        out[stable] = torch.cat(vals)
        return out
    F = type(parts[0][0])(*(back([p[0][k] for p in parts])
                            for k in range(len(parts[0][0]))))
    sum_f = back([p[1] for p in parts])
    sum_v = tuple(back([p[2][c] for p in parts]) for c in range(3))
    aux = {k: back([p[3][k] for p in parts]) for k in parts[0][3]}
    aux.update(_flags(lay, back([p[4] for p in parts])))
    return F, sum_f, sum_v, aux


def gabriel_lattice_pallas(pw_int, pw_friction, X, old_v, n, cube_size, *,
                           grid_size, capacity, max_candidates=20,
                           gabriel_coefficient=0.8, lay=None):
    """Gabriel lattice wrapper: launches ``csrc/gabriel_pair.cu`` for CUDA
    tensors, runs :func:`gabriel_lattice_plain` for CPU tensors, raises for
    anything else; a launch counts in ``kernels.gabriel_pair``
    (``utils.profiling``).  The kernel takes compact sets of at most
    ``GABRIEL_MAX_NC`` and writes the rows of the ids that hold a slot;
    the rest stay at the zeros the wrapper fills.  ``lay`` is the state's
    lattice build (``lattice_build(..., extras_cap=0)``) where the caller
    made it (``GabrielEngine`` times the two apart); else the wrapper
    builds it."""
    dev = X.x.device
    kw = dict(grid_size=grid_size, capacity=capacity,
              max_candidates=max_candidates,
              gabriel_coefficient=gabriel_coefficient, lay=lay)
    if dev.type == "cpu":
        return gabriel_lattice_plain(pw_int, pw_friction, X, old_v, n,
                                     cube_size, **kw)
    if dev.type != "cuda":
        raise ValueError(f"Gabriel lattice kernel: unsupported device {dev}")
    from .. import _build
    spec, params = pair_functor(pw_int, pw_friction, "gabriel",
                                "the plain Gabriel lattice path on CPU "
                                "tensors")
    NC = int(max_candidates)
    if not 1 <= NC <= GABRIEL_MAX_NC:
        raise ValueError(f"Gabriel lattice kernel: max_candidates {NC} "
                         f"outside [1, {GABRIEL_MAX_NC}]")
    _, gc2 = _squares(cube_size, gabriel_coefficient)
    gx, gy, gz = grid_dims(grid_size)
    plan = gabriel_plan((gx, gy, gz), capacity, NC)
    if lay is None:
        lay = lattice_build(X, old_v, n, cube_size, grid_size, capacity, 0)
    n_slots = lay.pid.shape[0]
    n_pad = lay.slot_of.shape[0]
    f32 = torch.float32
    what = "Gabriel lattice kernel:"
    chans = [require(getattr(lay.T, f), (n_slots,), f32, dev,
                     f"{what} T.{f}") for f in spec["fields"]] + \
        [require(a, (n_slots,), f32, dev, f"{what} old_v") for a in lay.Tov]
    pid = require(lay.pid, (n_slots,), torch.int64, dev, f"{what} pid")
    M = len(spec["dF"]) + len(spec["aux"]) + 4
    out = torch.zeros((M + 1, n_pad), dtype=f32, device=dev)
    lib = _build.library()
    count("kernels.gabriel_pair")
    _build.check(getattr(lib, spec["entries"]["gabriel"])(
        _build.pointers(chans), pid.data_ptr(), n_pad, gx, gy, gz, capacity,
        float(cube_size), gc2, NC, *plan.brick, plan.smem,
        param_array(spec, params), out.data_ptr(),
        _build.stream_handle(dev)), "Gabriel lattice kernel")
    F, sum_f, sum_v, aux = unpack_sums(out[:M], spec, pw_int, type(X))
    aux.update(_flags(lay, out[M]))
    return F, sum_f, sum_v, aux

