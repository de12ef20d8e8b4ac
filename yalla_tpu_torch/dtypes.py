"""Point types: a vector space over named float fields, on torch tensors.

Counterpart of ``yalla_tpu/dtypes.py``.  A ``Pt`` is a NamedTuple whose
fields are tensors (usually ``f32[n_pad]`` per field for a population, or
broadcastable pair blocks inside an engine); the operators act
component-wise, so arithmetic on a ``Pt`` is vectorised by construction.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["make_pt", "Float3", "pt_zeros_like", "device_of"]

_PT_REGISTRY: dict[tuple[str, tuple[str, ...]], type] = {}


class _PtMixin:
    """Component-wise vector-space operators (ref dtypes.cuh:151-217)."""

    __slots__ = ()

    def _map(self, fn, *others):
        return type(self)(*(fn(*vals) for vals in zip(self, *others)))

    def __add__(self, other):
        return self._map(lambda a, b: a + b, other)

    def __sub__(self, other):
        return self._map(lambda a, b: a - b, other)

    def __neg__(self):
        return self._map(lambda a: -a)

    def __mul__(self, scalar):
        return self._map(lambda a: a * scalar)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return self._map(lambda a: a / scalar)

    @classmethod
    def zeros(cls, shape, *, device=None, dtype=torch.float32):
        return cls(*(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in cls._fields))

    def replace(self, **kw):
        return self._replace(**kw)


def make_pt(name: str, *extra_fields: str) -> type:
    """Create a point type with fields ``x, y, z, *extra_fields``.

    Returns a NamedTuple subclass supporting ``+ - * /`` component-wise.
    Types are memoised, so repeated calls with the same signature return
    the identical class (as ``yalla_tpu.dtypes.make_pt`` does)."""
    fields = ("x", "y", "z") + tuple(extra_fields)
    key = (name, fields)
    if key in _PT_REGISTRY:
        return _PT_REGISTRY[key]
    base = NamedTuple(name, [(f, torch.Tensor) for f in fields])
    cls = type(name, (_PtMixin, base), {"__slots__": ()})
    cls.__new__.__defaults__ = tuple(0.0 for _ in fields)
    _PT_REGISTRY[key] = cls
    return cls


Float3 = make_pt("Float3")


def pt_zeros_like(pt):
    """A Pt of the same type with every field zero."""
    return type(pt)(*(torch.zeros_like(a) for a in pt))


def device_of(device, what):
    """``torch.device(device)``; raises if it names CUDA and no CUDA device
    is available.  The port's entry points default to ``"cuda"``: the
    caller asks for the CPU by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}(device={str(device)!r}): no CUDA device "
                           f"is available; pass device=\"cpu\" for the CPU")
    return dev
