"""The collectives of the multi-device paths, on ``torch.distributed``.

The JAX package needs no counterpart of this module: XLA inserts the
collectives of ``shard_map`` itself.  Here each rank is a process and
calls them:

* :class:`Mesh`: one rank's view of the ring (process group, rank, size,
  the ``torch.device`` its tensors live on);
* :func:`all_gather`: the ranks' tensors concatenated along dim 0 (JAX's
  ``all_gather(..., tiled=True)``);
* :func:`psum` and :func:`pmax`: sums and maxima of small tensors of
  scalars;
* :func:`plane_exchange`: one plane to each z-neighbour and one from it,
  zeros at the ring's ends (``parallel/lattice_spmd.py::_plane_exchange``
  of the JAX package);
* :func:`spawn`: run a function of the package on ``n_procs`` ranks and
  return rank 0's result as numpy.

Transport: with one rank per card the collectives take CUDA tensors under
NCCL.  Ranks that share one card cannot use NCCL, and gloo's collectives
are certain only for CPU tensors, so under gloo a CUDA tensor is staged
through host memory explicitly: copied to the host, sent, copied back.
The compute stays on the card.  While tracing is on
(``utils.profiling``), each collective is the span ``comm.<collective>``
and counts in ``comm.calls`` and ``comm.bytes``, the device synchronised
before it, so that earlier kernels do not count, and after it.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import warnings
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils import profiling

__all__ = ["Mesh", "all_gather", "psum", "pmax", "plane_exchange", "spawn",
           "to_numpy"]


@dataclass(frozen=True)
class Mesh:
    """One rank of a 1-D ring: its process group (None alone), rank, the
    ring's size and the device of its tensors."""
    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self):
        return dist.get_backend(self.group) if self.size > 1 else "none"

    @property
    def staged(self):
        """True where CUDA tensors go through host memory (gloo)."""
        return self.device.type == "cuda" and self.backend == "gloo"

    @property
    def transport(self):
        """The transport's name, as a run reports it."""
        return f"{self.backend}, staged through host memory" \
            if self.staged else self.backend


def single(device):
    """A ring of one rank: every collective is the identity."""
    return Mesh(None, 0, 1, torch.device(device))


@contextlib.contextmanager
def _traced(mesh, name, nbytes):
    """One collective as the span ``comm.<name>``, counted in
    ``comm.calls`` and ``comm.bytes``, the card synchronised around it;
    nothing while tracing is off."""
    if not profiling.enabled():
        yield
        return
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    with profiling.span(f"comm.{name}"):
        yield
        if cuda:
            torch.cuda.synchronize(mesh.device)
    profiling.count("comm.calls")
    profiling.count("comm.bytes", nbytes)


def _out(mesh, t):
    """``t`` as the collective takes it: on the host where staged."""
    return t.cpu() if mesh.staged else t.contiguous()


def _back(mesh, t):
    return t.to(mesh.device) if mesh.staged else t


def all_gather(mesh, t):
    """The ranks' ``t`` concatenated along dim 0, in rank order."""
    if mesh.size == 1:
        return t
    with _traced(mesh, "all_gather", t.numel() * t.element_size()):
        src = _out(mesh, t)
        out = src.new_empty((mesh.size * src.shape[0],) + src.shape[1:])
        with warnings.catch_warnings():
            # newer torch names it all_gather_single; older ones lack that
            warnings.filterwarnings("ignore", category=FutureWarning,
                                    message=".*all_gather_into_tensor.*")
            dist.all_gather_into_tensor(out, src, group=mesh.group)
        return _back(mesh, out)


def _reduce(mesh, t, op, name):
    if mesh.size == 1:
        return t
    with _traced(mesh, name, t.numel() * t.element_size()):
        buf = _out(mesh, t).clone()
        dist.all_reduce(buf, op=op, group=mesh.group)
        return _back(mesh, buf)


def psum(mesh, t):
    """Elementwise sum of ``t`` over the ranks (a new tensor)."""
    return _reduce(mesh, t, dist.ReduceOp.SUM, "psum")


def pmax(mesh, t):
    """Elementwise maximum of ``t`` over the ranks (a new tensor)."""
    return _reduce(mesh, t, dist.ReduceOp.MAX, "pmax")


def plane_exchange(mesh, first, last):
    """One-plane z exchange along the ring: ``(lo, hi)``, where ``lo`` is
    the previous rank's ``last`` and ``hi`` the next rank's ``first``,
    zeros at the ring's ends (``first``, ``last``: this rank's edge
    planes, one tensor each)."""
    lo, hi = torch.zeros_like(last), torch.zeros_like(first)
    if mesh.size == 1:
        return lo, hi
    with _traced(mesh, "plane_exchange",
                 2 * first.numel() * first.element_size()):
        first, last = _out(mesh, first), _out(mesh, last)
        lo_b, hi_b = torch.zeros_like(last), torch.zeros_like(first)
        ops = []
        if mesh.rank > 0:
            ops += [dist.P2POp(dist.isend, first, mesh.rank - 1, mesh.group),
                    dist.P2POp(dist.irecv, lo_b, mesh.rank - 1, mesh.group)]
        if mesh.rank < mesh.size - 1:
            ops += [dist.P2POp(dist.isend, last, mesh.rank + 1, mesh.group),
                    dist.P2POp(dist.irecv, hi_b, mesh.rank + 1, mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return _back(mesh, lo_b), _back(mesh, hi_b)


def to_numpy(tree):
    """Tensors of a result as numpy arrays; a point type (a NamedTuple)
    as a dict of its fields."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: to_numpy(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree


def _rank_main(rank, fn, n_procs, args, kwargs, backend, device, tmp,
               timeout):
    store = dist.FileStore(os.path.join(tmp, "store"), n_procs)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=n_procs,
                            timeout=timedelta(seconds=timeout))
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank if backend == "nccl"
                               else dev.index or 0)
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_procs
                                      // 2))
        out = fn(Mesh(dist.group.WORLD, rank, n_procs, dev), *args,
                 **kwargs)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(to_numpy(out), f)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_procs, *args, backend="gloo", device="cuda", timeout=600,
          **kwargs):
    """Run ``fn(mesh, *args, **kwargs)`` on ``n_procs`` new processes, one
    rank each, and return rank 0's result (tensors as numpy,
    :func:`to_numpy`).

    The ranks meet through a ``FileStore`` in a temporary directory, so
    that runs side by side never contend for a port.  ``fn`` must be a
    module-level function of an importable module: the ranks import it
    afresh.  ``device="cuda"`` (the default): every rank on the current
    card under gloo (collectives staged through the host), rank ``r`` on
    card ``r`` under NCCL; ``device="cpu"``: every rank on the host.  A
    rank that raises stops the others, and the error is raised here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="yalla_spawn_") as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, n_procs, args, kwargs, backend,
                                 str(device), tmp, timeout),
                           nprocs=n_procs, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)
