"""Pour: cube-sorted channels -> dense lattice slots (kernel K2).

Counterpart of ``yalla_tpu/ops/lattice_pour.py::pour_pallas``, with its
contract.  ``S`` is an f32 ``[K, n_pad]`` stack sorted by cube id whose
last row is the target slot of each sorted entry (``cid * C + rank``, or
``DST_SENTINEL`` for entries that must not be placed); ``row_starts``
(``[gy * gz + 1]`` ints) gives the first sorted position of each (z, y) row
of cubes and, last, the end of the last row.  Returns ``(out [K-1,
n_slots] f32, +0.0 where empty, live [n_slots] f32, 1.0 where an entry
was placed, n_unrouted)``.  An entry is placed only if its slot lies in the
row whose window ``[row_starts[r], row_starts[r + 1])`` holds it;
``n_unrouted`` counts the entries with a valid target that are not (on a
consistent sort there are none), and ``lattice_build`` adds it to
``n_dropped``.  The TPU kernel also leaves entries past its spill budget
unrouted; the port has no such budget and places them.

On the GPU the kernel (``csrc/pour.cu``) is slot-major, as the TPU kernel
is: a block owns whole rows, maps its slots to its window's entries and
writes every slot once, zeros included; its plain version is an index
assignment.
"""
from __future__ import annotations

import functools

import torch

from ..utils.profiling import count
from .common import grid_dims
from .functors import require

__all__ = ["DST_SENTINEL", "pour_pallas", "pour_plain", "pour_plan"]

# f32 slot-target sentinel: beyond any valid slot id, exactly representable
DST_SENTINEL = float(2 ** 25)
# slots a block of csrc/pour.cu owns, about (whole rows, at least one):
# the fastest of the sizes ``kernel_profile.py --plans`` times on the 500k
# and 100k builds (PERF.md)
BLOCK_SLOTS = 1024


def _check(S, row_starts, grid_size, capacity):
    """(gx * C, gy * gz, n_slots) of the lattice; raises on a bad input."""
    if S.dtype != torch.float32 or S.dim() != 2 or S.shape[0] < 2:
        raise ValueError(f"pour: S must be f32 [K >= 2, n_pad], got "
                         f"{S.dtype} {tuple(S.shape)}")
    gx, gy, gz = grid_dims(grid_size)
    W, n_rows = gx * capacity, gy * gz
    n_slots = W * n_rows
    if not 0 < n_slots < 2 ** 24:
        raise ValueError(f"pour: n_slots {n_slots} must be in (0, 2^24) "
                         f"(slot ids ride f32 exactly)")
    if row_starts.shape != (n_rows + 1,) or row_starts.is_floating_point():
        raise ValueError(f"pour: row_starts must be [{n_rows + 1}] ints, "
                         f"got {row_starts.dtype} {tuple(row_starts.shape)}")
    return W, n_rows, n_slots


@functools.lru_cache(maxsize=64)
def pour_plan(n_rows, W):
    """(rows per block, blocks) of the pour kernel: whole rows, about
    ``BLOCK_SLOTS`` slots a block."""
    rows = max(1, BLOCK_SLOTS // W)
    return rows, -(-n_rows // rows)


def pour_plain(S, row_starts, grid_size, capacity):
    """Plain torch version: an index assignment of the entries placed."""
    W, _, n_slots = _check(S, row_starts, grid_size, capacity)
    dst = S[-1]
    ok = (dst >= 0) & (dst < n_slots)
    slot = torch.where(ok, dst, 0.0).to(torch.int64)
    rs = row_starts.to(torch.int64)
    t = torch.arange(S.shape[1], device=S.device)
    row = slot // W
    placed = ok & (rs[row] <= t) & (t < rs[row + 1])
    idx = slot[placed]
    out = torch.zeros((S.shape[0] - 1, n_slots), dtype=S.dtype,
                      device=S.device)
    out[:, idx] = S[:-1, placed]
    live = torch.zeros(n_slots, dtype=S.dtype, device=S.device)
    live[idx] = 1.0
    return out, live, (ok & ~placed).sum()


def pour_pallas(S, row_starts, grid_size, capacity):
    """Pour kernel wrapper: launches ``csrc/pour.cu`` for a CUDA tensor,
    runs :func:`pour_plain` for a CPU tensor, raises for anything else.
    A launch counts in ``kernels.pour`` (``utils.profiling``)."""
    if S.device.type == "cpu":
        return pour_plain(S, row_starts, grid_size, capacity)
    if S.device.type != "cuda":
        raise ValueError(f"pour: unsupported device {S.device}")
    from .. import _build
    W, n_rows, n_slots = _check(S, row_starts, grid_size, capacity)
    K, n_pad = S.shape
    require(S, (K, n_pad), torch.float32, S.device, "pour: S")
    require(row_starts, (n_rows + 1,), torch.int32, S.device,
            "pour: row_starts")
    rows, blocks = pour_plan(n_rows, W)
    # the kernel writes every byte of these (n_unrouted after zeroing it)
    out = torch.empty((K - 1, n_slots), dtype=S.dtype, device=S.device)
    live = torch.empty(n_slots, dtype=S.dtype, device=S.device)
    n_unrouted = torch.empty((), dtype=torch.int64, device=S.device)
    lib = _build.library()
    count("kernels.pour")
    _build.check(lib.yalla_pour(S.data_ptr(), K, n_pad, row_starts.data_ptr(),
                                n_rows, W, rows, blocks, out.data_ptr(),
                                live.data_ptr(), n_unrouted.data_ptr(),
                                _build.stream_handle(S.device)), "pour")
    return out, live, n_unrouted
