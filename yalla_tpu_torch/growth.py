"""Proliferation (dynamic N) and lineage tracing as framework features.

Counterpart of ``yalla_tpu/growth.py``.  The reference implements cell
division per model with ``atomicAdd`` slot allocation (e.g.
``examples/branching.cu:113-170``): thread i draws a uniform, applies
gates, claims slot ``n = atomicAdd(d_n_cells, 1)``, places the daughter at
the parent plus a random ``mean_distance / 4`` offset, halves conserved
fields, and copies ``d_old_v``.  Here, as in the JAX package, a boolean
division mask is turned into daughter slots by a prefix sum: the first
``n_divided`` wanting cells in slot order divide, and their daughters land
in the contiguous slot range ``[n, n + n_divided)``.  (The JAX function
writes them through a ``birth_cap``-wide window because full-width
scatters are costly on its device; here the daughters' range is a plain
slice, the same function.)

The active count is a Python int, as everywhere in the port, so
``proliferate`` reads ``n_divided`` and ``n_lost`` back from the device
together, once per call, and returns the new count as an int.  Carrying
the count on the device belongs with capturing the step in a CUDA graph.

Randomness: ``proliferate`` draws from the ``torch.Generator`` it is
given, or takes the draws themselves (``draws=``), so a caller (a test
holding the port against the JAX package's ``jax.random`` draws) can pass
its own.

No function here writes into a tensor it was given: every returned tensor
that differs from its input is a new one, so a reference to an earlier
state (a frame queued for output) keeps its values.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .dtypes import Float3, device_of
from .utils.profiling import span, spanned

__all__ = ["proliferate", "DivisionInfo", "Draws", "draw", "Lineage",
           "lineage_init", "record_divisions"]


class DivisionInfo(NamedTuple):
    ok: torch.Tensor         # bool[n_pad]: cell i divided this call
    child_idx: torch.Tensor  # int32[n_pad]: daughter slot (valid where ok)
    n_divided: int
    n_lost: int              # divisions dropped at capacity or birth_cap
    #                          (the reference hard-asserts instead,
    #                           solvers.cuh:82; callers must check)
    n: int                   # the active count before this call


class Draws(NamedTuple):
    """The randoms of one ``proliferate`` call, one per row: the uniform
    ``want_fn`` gates on, and the unit direction ``child_fn`` places the
    daughter along."""
    rnd: torch.Tensor      # f32[n_pad] in [0, 1)
    direction: Float3      # unit vectors, f32[n_pad] per component


def _auto_birth_cap(n_pad):
    """Most divisions applied per call: all rows for small states, a
    generous fraction for large ones (~3% of slots; divisions per pass in
    every reference model are a few permille of n at most)."""
    return n_pad if n_pad <= 2048 else min(n_pad, max(2048, n_pad // 32))


def _random_unit(generator, n_pad, device):
    """Uniform directions via the reference's own parameterization
    (theta = acos(2u - 1), phi = 2 pi u; branching.cu:141-143)."""
    u = torch.rand((2, n_pad), generator=generator, device=device)
    theta = torch.acos(2.0 * u[0] - 1.0)
    phi = u[1] * (2.0 * math.pi)
    return Float3(x=torch.sin(theta) * torch.cos(phi),
                  y=torch.sin(theta) * torch.sin(phi),
                  z=torch.cos(theta))


def draw(generator, n_pad, device):
    """One call's :class:`Draws` from ``generator`` (on ``device``)."""
    return Draws(torch.rand(n_pad, generator=generator, device=device),
                 _random_unit(generator, n_pad, device))


def _first_with_count(offs, k):
    """Row of the j-th True of the mask ``offs`` is the running count of,
    for j = 1..k: the first row whose count reaches j."""
    return torch.searchsorted(
        offs, torch.arange(1, k + 1, dtype=offs.dtype, device=offs.device))


def _with_rows(base, start, rows):
    """``base`` with ``rows`` written at ``[start, start + len(rows))``,
    as a new tensor."""
    out = base.clone()
    out[start:start + rows.shape[0]] = rows
    return out


@spanned("growth.proliferate")
def proliferate(want_fn, child_fn, X, old_v, n, generator=None, props=(),
                birth_cap=None, draws=None):
    """One division pass.

    want_fn(X, props, rnd, i, n) -> bool[n_pad]
        division decision per cell; ``rnd`` is a fresh uniform [n_pad],
        ``i`` the row index, ``n`` the active count (an int).  Apply rate
        gates / newborn guards here (cf. branching.cu:118-137).
    child_fn(X, props, direction, i) -> (X_parent, X_child)
        how fields split between parent and daughter; ``direction`` is a
        random unit Float3 per cell (scale it by mean_distance / 4 to match
        the reference placement).
    props: tuple of per-cell tensors copied parent -> daughter verbatim
        (0-d tensors and numbers pass through).
    birth_cap: max divisions applied per call; defaults to all of n_pad
        below 2048 rows, n_pad / 32 above.  Divisions beyond it (or beyond
        n_pad capacity) are dropped and counted in ``n_lost``.
    generator / draws: the ``torch.Generator`` the randoms come from, or
        the randoms themselves (:class:`Draws`).

    Returns (X', old_v', n', props', DivisionInfo), ``n'`` an int: one
    device readback per call.
    """
    n = int(n)
    n_pad = X.x.shape[0]
    dev = X.x.device
    W = _auto_birth_cap(n_pad) if birth_cap is None else min(birth_cap, n_pad)
    i = torch.arange(n_pad, device=dev)
    if draws is None:
        draws = draw(generator, n_pad, dev)
    want = want_fn(X, props, draws.rnd, i, n) & (i < n)

    offs = torch.cumsum(want, 0)
    child_idx = (n + offs - 1).to(torch.int32)
    # both cutoffs are monotone in offs, so the surviving divisions are
    # exactly the first n_divided wants (a slot-ordered prefix)
    ok = want & (offs <= min(W, n_pad - n))
    with span("growth.readback"):
        n_divided, n_wanted = torch.stack([ok.sum(), want.sum()]).tolist()

    X_parent, X_child = child_fn(X, props, draws.direction, i)
    # parent of the k-th division: the first row with offs == k + 1
    parent_of = _first_with_count(offs, n_divided)

    def place(cur, parent_new, child):
        base = torch.where(ok, parent_new, cur)     # a new tensor
        base[n:n + n_divided] = child[parent_of]
        return base

    def inherit(a):
        return _with_rows(a, n, a[parent_of]) if n_divided else a

    X_new = type(X)(*(place(*c) for c in zip(X, X_parent, X_child)))
    old_v_new = type(old_v)(*(inherit(a) for a in old_v))
    props_new = tuple(
        p if not torch.is_tensor(p) or p.ndim == 0 else inherit(p)
        for p in props)
    return (X_new, old_v_new, n + n_divided, props_new,
            DivisionInfo(ok=ok, child_idx=child_idx, n_divided=n_divided,
                         n_lost=n_wanted - n_divided, n=n))


# --------------------------------------------------------------------------
# Lineage tracing (ref branching.cu:46-55, 154-169, 283-339)
# --------------------------------------------------------------------------

class Lineage(NamedTuple):
    """Preallocated tree-node arrays + per-cell parent/clone labels."""
    n_nodes: int                # nodes recorded, also past the arrays' end
    node_x: torch.Tensor        # f32[cap]
    node_y: torch.Tensor
    node_z: torch.Tensor
    node_time: torch.Tensor     # f32[cap]
    node_parent: torch.Tensor   # int32[cap]
    node_clone: torch.Tensor    # int32[cap]
    node_type: torch.Tensor     # int32[cap]
    cell_parent: torch.Tensor   # int32[n_pad], -1 = root
    cell_clone: torch.Tensor    # int32[n_pad]


def lineage_init(cap, n_pad, n_0, device="cuda"):
    """Founders get clone id i + 1 and no parent (branching.cu:222-228)."""
    dev = device_of(device, "lineage_init")
    i = torch.arange(n_pad, dtype=torch.int32, device=dev)

    def zeros(dtype):
        return torch.zeros(cap, dtype=dtype, device=dev)
    return Lineage(
        n_nodes=0,
        node_x=zeros(torch.float32), node_y=zeros(torch.float32),
        node_z=zeros(torch.float32), node_time=zeros(torch.float32),
        node_parent=torch.full((cap,), -1, dtype=torch.int32, device=dev),
        node_clone=zeros(torch.int32), node_type=zeros(torch.int32),
        cell_parent=torch.full((n_pad,), -1, dtype=torch.int32, device=dev),
        cell_clone=torch.where(i < n_0, i + 1, 0).to(torch.int32),
    )


@spanned("growth.record_divisions")
def record_divisions(lin: Lineage, info: DivisionInfo, X, cell_type,
                     time_progression):
    """Append one internal node per division; relabel parent + daughter
    (branching.cu:154-169).  ``X`` is the state after the division and
    ``cell_type`` an int32 tensor per cell.  Nodes past the arrays'
    capacity are counted in ``n_nodes`` and not stored.  (``info`` carries
    the counts, so there is no ``birth_cap`` to repeat here.)"""
    k, n, n_nodes = info.n_divided, info.n, lin.n_nodes
    if not k:
        return lin
    cap = lin.node_x.shape[0]
    offs = torch.cumsum(info.ok, 0)
    parent_of = _first_with_count(offs, k)
    kn = max(0, min(k, cap - n_nodes))      # nodes that fit the arrays
    node_src = parent_of[:kn]

    def put_node(arr, vals):
        return _with_rows(arr, n_nodes, vals.to(arr.dtype))

    # a number fills on the device (no host-to-device copy, which would
    # wait for the stream)
    time = time_progression.to(lin.node_time.dtype).expand(kn) \
        if torch.is_tensor(time_progression) else torch.full(
            (kn,), float(time_progression), dtype=lin.node_time.dtype,
            device=lin.node_time.device)
    node_idx = (n_nodes + offs - 1).to(torch.int32)
    child_node = torch.arange(n_nodes, n_nodes + k, dtype=torch.int32,
                              device=offs.device)
    return lin._replace(
        n_nodes=n_nodes + k,
        node_x=put_node(lin.node_x, X.x[node_src]),
        node_y=put_node(lin.node_y, X.y[node_src]),
        node_z=put_node(lin.node_z, X.z[node_src]),
        node_time=put_node(lin.node_time, time),
        node_parent=put_node(lin.node_parent, lin.cell_parent[node_src]),
        node_clone=put_node(lin.node_clone, lin.cell_clone[node_src]),
        node_type=put_node(lin.node_type, cell_type[node_src]),
        cell_clone=_with_rows(lin.cell_clone, n, lin.cell_clone[parent_of]),
        cell_parent=_with_rows(
            torch.where(info.ok, node_idx, lin.cell_parent), n, child_node),
    )
