"""All-pairs pass (kernel K3) and its plain version.

Counterpart of ``yalla_tpu/ops/tile_pallas.py::tile_pairwise_pallas``: the
same contract and returns as ``tile_pairwise`` -- per-point sums
``(F, sum_friction, sum_v, aux)``, all ``[n_pad]``, over every pair of the
first ``n`` points, the i == j diagonal included.

* ``tile_pairwise_pallas`` is the kernel wrapper: a CUDA tensor goes to
  ``csrc/tile_pair.cu``, a CPU tensor to ``tile_pairwise_plain``.  The
  kernel runs forces that declare a device functor (``ops/functors.py``)
  and refuses the rest on the GPU.  Unlike the TPU kernel it takes any
  ``n_pad``.
* ``tile_pairwise_plain`` is the plain all-pairs path,
  ``pairwise_xla.tile_pairwise`` -- the oracle the JAX tests hold the TPU
  kernel against.
"""
from __future__ import annotations

import torch

from .functors import pair_functor, param_array, require, unpack_sums
from .pairwise_xla import tile_pairwise

__all__ = ["tile_pairwise_pallas", "tile_pairwise_plain"]


def tile_pairwise_plain(pw_int, pw_friction, X, old_v, n):
    """Plain torch version of the all-pairs pass, generic over the force."""
    return tile_pairwise(pw_int, pw_friction, X, old_v, n)


def tile_pairwise_pallas(pw_int, pw_friction, X, old_v, n):
    """All-pairs wrapper: launches ``csrc/tile_pair.cu`` for CUDA tensors,
    runs :func:`tile_pairwise_plain` for CPU tensors, raises for anything
    else.  ``tile_pairwise_pallas.launches`` counts kernel launches."""
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
    out = torch.empty((len(spec["dF"]) + len(spec["aux"]) + 4, n_pad),
                      dtype=f32, device=dev)
    lib = _build.library()
    tile_pairwise_pallas.launches += 1
    _build.check(getattr(lib, spec["entries"]["tile"])(
        _build.pointers(chans), n, n_pad, param_array(spec, params),
        out.data_ptr(), _build.stream_handle(dev)), "tile pair kernel")
    return unpack_sums(out, spec, pw_int, type(X))


tile_pairwise_pallas.launches = 0
