"""Pour: cube-sorted channels -> dense lattice slots (kernel K2).

Counterpart of ``yalla_tpu/ops/lattice_pour.py::pour_pallas``.  The TPU
kernel is a butterfly routing network because scatters are slow there;
on the GPU the same contract is a direct placement
(``csrc/pour.cu``), and its plain version is an index assignment.

Contract: ``S`` is an f32 ``[K, n_pad]`` stack whose last row is the
target slot of each sorted entry (``cid * C + rank``, or
``DST_SENTINEL`` for entries that must not be placed).  Returns
``(out [K-1, n_slots] f32, 0-filled where empty, live [n_slots] f32,
1.0 where an entry was placed, n_unrouted)``.  Direct placement routes
every entry, so ``n_unrouted`` is always 0; it stays in the return value
because ``lattice_build`` adds it to ``n_dropped``.
"""
from __future__ import annotations

import torch

__all__ = ["DST_SENTINEL", "pour_pallas", "pour_plain"]

# f32 slot-target sentinel: beyond any valid slot id, exactly representable
DST_SENTINEL = float(2 ** 25)


def _check(S, n_slots):
    if S.dtype != torch.float32 or S.dim() != 2 or S.shape[0] < 2:
        raise ValueError(f"pour: S must be f32 [K >= 2, n_pad], got "
                         f"{S.dtype} {tuple(S.shape)}")
    if not 0 < n_slots < 2 ** 24:
        raise ValueError(f"pour: n_slots {n_slots} must be below 2^24 "
                         f"(slot ids ride f32 exactly)")


def pour_plain(S, n_slots):
    """Plain torch version: an index assignment of the placed entries."""
    _check(S, n_slots)
    dst = S[-1]
    ok = (dst >= 0) & (dst < n_slots)
    idx = dst[ok].to(torch.int64)
    out = torch.zeros((S.shape[0] - 1, n_slots), dtype=S.dtype,
                      device=S.device)
    out[:, idx] = S[:-1, ok]
    live = torch.zeros(n_slots, dtype=S.dtype, device=S.device)
    live[idx] = 1.0
    return out, live, torch.zeros((), dtype=torch.int64, device=S.device)


def pour_pallas(S, n_slots):
    """Pour kernel wrapper: launches ``csrc/pour.cu`` for a CUDA tensor,
    runs :func:`pour_plain` for a CPU tensor, raises for anything else.
    ``pour_pallas.launches`` counts kernel launches."""
    if S.device.type == "cpu":
        return pour_plain(S, n_slots)
    if S.device.type != "cuda":
        raise ValueError(f"pour: unsupported device {S.device}")
    from .. import _build
    _check(S, n_slots)
    if not S.is_contiguous():
        raise ValueError("pour: S must be contiguous")
    K, n_pad = S.shape
    out = torch.zeros((K - 1, n_slots), dtype=S.dtype, device=S.device)
    live = torch.zeros(n_slots, dtype=S.dtype, device=S.device)
    lib = _build.library()
    pour_pallas.launches += 1
    _build.check(lib.yalla_pour(S.data_ptr(), K, n_pad, n_slots,
                                out.data_ptr(), live.data_ptr(),
                                _build.stream_handle(S.device)), "pour")
    return out, live, torch.zeros((), dtype=torch.int64, device=S.device)


pour_pallas.launches = 0
