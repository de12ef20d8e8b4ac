"""Multi-device scaling: the cells-axis decomposition.

Counterpart of ``yalla_tpu/parallel/spmd.py``.  Every per-cell array is
split over the ranks of a 1-D ring, ``n_pad / D`` rows each, and the Heun
step runs on every rank at once:

* each rank owns its rows and computes their derivatives against the full
  population, gathered with one ``all_gather`` of the state per Heun pass
  (and one of ``old_v`` per step);
* the engine's ``(i_offset, i_size)`` window restricts the pair pass to the
  rank's rows (``i_offset = rank * size``): the plain passes, as in the
  JAX package, whose sharded path runs no Pallas kernel either;
* the momentum fix (the COM drift, a pinned point, or both) is a sum over
  the ranks, and the ``__err_*`` flags a maximum over them.

A rank is a process (``parallel/_comm.py``): ``spawn`` starts them, or
``torchrun`` with one card a rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.common import (ERR_PREFIX, augment, derivative, fold_pair,
                          fold_steps, friction_w_neighbour, mean_v,
                          momentum_fix, nonfinite)
from ._comm import Mesh, all_gather, pmax, psum, single

__all__ = ["make_cells_mesh", "make_sharded_step", "shard_state",
           "gather_pt"]


def make_cells_mesh(device="cuda", group=None):
    """This process's rank of the ring of ``group`` (the default process
    group, initialised by the caller or by ``_comm.spawn``), its tensors
    on ``device``: under NCCL card ``rank % device_count``.  Without a
    process group, a ring of one."""
    device = torch.device(device)
    if not dist.is_initialized():
        return single(device)
    group = group or dist.group.WORLD
    rank = dist.get_rank(group)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count()
                              if dist.get_backend(group) == "nccl"
                              else torch.cuda.current_device())
    return Mesh(group, rank, dist.get_world_size(group), device)


def _rows(mesh, n_rows):
    """``(offset, size)`` of this rank's rows of ``n_rows``."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split over {mesh.size} "
                         f"ranks")
    size = n_rows // mesh.size
    return mesh.rank * size, size


def shard_state(mesh, X, old_v):
    """This rank's rows of the per-cell arrays ``X`` and ``old_v`` (Pts of
    the full ``[n_pad]`` arrays), on the mesh's device."""
    offset, size = _rows(mesh, X.x.shape[0])

    def part(pt):
        return type(pt)(*(a[offset:offset + size].to(mesh.device)
                          .contiguous() for a in pt))
    return part(X), part(old_v)


def gather_pt(mesh, pt):
    """The full arrays of a Pt (or a list of tensors of one length and
    dtype) from every rank's rows: one all-gather."""
    if mesh.size == 1:
        return pt
    rows = all_gather(mesh, torch.stack(list(pt)))
    k = len(pt)
    full = rows.reshape(mesh.size, k, -1).transpose(0, 1).reshape(k, -1)
    return type(pt)(*full) if hasattr(pt, "_fields") else list(full)


def make_sharded_step(mesh, engine, pw_int, *,
                      pw_friction=friction_w_neighbour, gen=None,
                      fix_mode="com", n_steps=1, precompute=None):
    """A multi-device Heun step (or ``n_steps`` of them).

    Returns ``step(X, old_v, n, dt, cube_size, fix_point, gen_args=None)
    -> (X, old_v, errs)`` on this rank's rows (:func:`shard_state`), with
    the semantics of the single-device ``heun_step`` (the same physics and
    fix rules).  ``errs`` holds the in-loop ``__err_*`` flags as 0-d
    tensors, each the maximum over steps, passes and ranks: check them as
    ``Solution._check_errors`` does.  ``gen`` is a ``GenericForce`` run
    on the gathered state with ``gen_args``; ``n`` is a Python int."""

    def step(X, old_v, n, dt, cube_size, fix_point, gen_args=None):
        size = X.x.shape[0]
        offset = mesh.rank * size
        dev = X.x.device
        active = offset + torch.arange(size, device=dev) < n

        def rows(pt):
            return type(pt)(*(a[offset:offset + size] for a in pt))

        def deriv(X_full, ov_full):
            Xa = augment(X_full, n, precompute)
            out = engine.pairwise(pw_int, pw_friction, Xa, ov_full, n,
                                  cube_size, i_offset=offset, i_size=size)
            add_gen = None if gen is None else \
                (lambda F: F + rows(gen.fn(X_full, n, gen_args)))
            # the per-cell transform on this rank's rows of the gathered
            # (augmented) state
            dX, aux = derivative(pw_int, out, rows(Xa), type(X_full),
                                 active, add_gen)
            errs = {k: v.max().to(torch.float32) for k, v in aux.items()
                    if k.startswith(ERR_PREFIX)}
            dX, = momentum_fix([(dX, active, offset)], n, fix_mode,
                               fix_point, lambda t: psum(mesh, t))
            return dX, errs

        errs = {}
        for _ in range(int(n_steps)):
            ov_full = gather_pt(mesh, old_v)   # gathered every step
            d1, e1 = deriv(gather_pt(mesh, X), ov_full)
            X1 = X + d1 * dt
            d2, e2 = deriv(gather_pt(mesh, X1), ov_full)
            X = X + (d1 + d2) * (0.5 * dt)
            old_v = mean_v(d1, d2)
            local = fold_pair(e2, e1)
            nonfin = nonfinite(X).to(torch.float32)
            local["__err_non_finite"] = torch.maximum(
                local.get("__err_non_finite", nonfin), nonfin)
            keys = list(local)
            # one maximum over the ranks a step for every flag
            red = pmax(mesh, torch.stack([local[k] for k in keys]))
            errs = fold_steps(errs, dict(zip(keys, red)))
        return X, old_v, errs

    return step
