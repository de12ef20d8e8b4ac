"""All-pairs pass (kernel K3) and its plain version.

Counterpart of ``yalla_tpu/ops/tile_pallas.py::tile_pairwise_pallas``: the
same contract and returns as ``tile_pairwise`` -- per-point sums
``(F, sum_friction, sum_v, aux)``, all ``[n_pad]``, over every pair of the
first ``n`` points, the i == j diagonal included.

* ``tile_pairwise_pallas`` is the kernel wrapper: a CUDA tensor goes to
  ``csrc/tile_pair.cu``, a CPU tensor to ``tile_pairwise_plain``.  The
  kernel runs forces that declare a device functor (``ops/functors.py``)
  and refuses the rest on the GPU.  Unlike the TPU kernel it takes any
  ``n_pad``.  :func:`tile_plan` splits j across blocks (the kernel's
  grid, and the scratch its reduction pass sums).
* ``tile_pairwise_plain`` is the plain all-pairs path,
  ``pairwise_xla.tile_pairwise`` -- the oracle the JAX tests hold the TPU
  kernel against.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils.profiling import count
from .functors import pair_functor, param_array, require, unpack_sums
from .pairwise_xla import tile_pairwise

__all__ = ["tile_pairwise_pallas", "tile_pairwise_plain", "tile_plan",
           "TilePlan", "sm_count"]

# csrc/tile_pair.cu: threads per block and j points per shared-memory tile
TILE_THREADS = 128
TILE_J = 64
# blocks the plan puts on each streaming multiprocessor
BLOCKS_PER_SM = 4


class TilePlan(NamedTuple):
    """Launch plan of the all-pairs kernel: ``rows`` i-points per thread,
    j split into ``splits`` ranges of ``chunk`` points, a grid of
    ``blocks`` = (i blocks, splits), and the partial sums' scratch shape
    ``(splits, sums, n_pad)``."""
    rows: int
    splits: int
    chunk: int
    blocks: tuple
    scratch: tuple


@functools.lru_cache(maxsize=64)
def tile_plan(n, n_pad, rows, sums, sms):
    """Split the j range of an ``n``-point all-pairs pass over ``n_pad``
    rows so that the grid holds at most ``BLOCKS_PER_SM`` blocks on each
    of the card's ``sms`` streaming multiprocessors, and as close to that
    as whole splits allow, each split at least one tile of j (none
    empty).  At most, not about: a fifth block on a few SMs keeps them a
    quarter longer than the rest, and the pass waits for them."""
    if not 0 <= n <= n_pad or rows < 1 or sums < 1 or sms < 1:
        raise ValueError(f"tile_plan: n {n}, n_pad {n_pad}, rows {rows}, "
                         f"sums {sums}, sms {sms}")
    i_blocks = -(-n_pad // (TILE_THREADS * rows))
    want = sms * BLOCKS_PER_SM // max(i_blocks, 1)
    splits = max(1, min(want, -(-n // TILE_J)))
    chunk = max(1, -(-n // splits))
    splits = max(1, -(-n // chunk))
    return TilePlan(rows, splits, chunk, (i_blocks, splits),
                    (splits, sums, n_pad))


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """Streaming multiprocessors of the CUDA ``device``."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def tile_pairwise_plain(pw_int, pw_friction, X, old_v, n):
    """Plain torch version of the all-pairs pass, generic over the force."""
    return tile_pairwise(pw_int, pw_friction, X, old_v, n)


def tile_pairwise_pallas(pw_int, pw_friction, X, old_v, n):
    """All-pairs wrapper: launches ``csrc/tile_pair.cu`` for CUDA tensors,
    runs :func:`tile_pairwise_plain` for CPU tensors, raises for anything
    else.  A launch counts in ``kernels.tile_pair`` (``utils.profiling``)."""
    dev = X.x.device
    if dev.type == "cpu":
        return tile_pairwise_plain(pw_int, pw_friction, X, old_v, n)
    if dev.type != "cuda":
        raise ValueError(f"tile pair kernel: unsupported device {dev}")
    from .. import _build
    spec, params = pair_functor(
        pw_int, pw_friction, "tile",
        "TileEngine(pallas=False, mxu=False), the plain all-pairs path,")
    n_pad = X.x.shape[0]
    n = int(n)
    if not 0 <= n <= n_pad:
        raise ValueError(f"tile pair kernel: n {n} outside [0, {n_pad}]")
    f32 = torch.float32
    chans = [require(getattr(X, f), (n_pad,), f32, dev,
                     f"tile pair kernel: X.{f}") for f in spec["fields"]] + \
        [require(a, (n_pad,), f32, dev, "tile pair kernel: old_v")
         for a in old_v]
    sums = len(spec["dF"]) + len(spec["aux"]) + 4
    plan = tile_plan(n, n_pad, spec["tile_rows"], sums, sm_count(dev))
    part = torch.empty(plan.scratch, dtype=f32, device=dev)
    out = torch.empty((sums, n_pad), dtype=f32, device=dev)
    lib = _build.library()
    count("kernels.tile_pair")
    _build.check(getattr(lib, spec["entries"]["tile"])(
        _build.pointers(chans), n, n_pad, plan.rows, plan.splits, plan.chunk,
        param_array(spec, params), part.data_ptr(), out.data_ptr(),
        _build.stream_handle(dev)), "tile pair kernel")
    return unpack_sums(out, spec, pw_int, type(X))

