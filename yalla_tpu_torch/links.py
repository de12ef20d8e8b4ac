"""Links between points (protrusions) and solid walls.

Counterpart of ``yalla_tpu/links.py`` (ref links.cuh).  A link table is a
fixed-capacity pair of index arrays ``(a, b)`` with its own active count;
``a == b`` marks an inactive link (ref links.cuh:121-122).  Forces reach
both endpoints by ``index_add_`` (the reference's ``atomicAdd``,
links.cuh:105-110) and enter the solver through the ``GenericForce`` hook;
the builders declare a ``capture_key`` (their code reads nothing back, nor
may the ``force`` and ``w_force`` given them), so that on the card a step
captures them with its glue.
On CUDA tensors ``index_add_`` fixes no summation order, so link and wall
forces agree with the CPU to f32 rounding, not bit for bit.

Randomness: ``Links`` holds a ``torch.Generator`` on its device, seeded
from ``seed``.  ``Links.update`` draws the rewiring randoms from it and
hands them to the rule, so a caller (a test holding the port against the
JAX package's ``jax.random`` draws) can pass its own instead.  A rule says
what it draws by a factory, ``rule.draws = factory``, with ``factory(
generator, m, device)`` the randoms of ``m`` link rows: ``cube_draws``
(the default, a ``Draws``: the grid-sampled rules of growth_w_wall,
model_features_sequential_addition and intercalation_w_gradient) or
``uniforms(count)`` (``count`` uniforms a row: sorting_prot 3,
intercalation 1).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .dtypes import device_of, pt_zeros_like
from .ops.grid_xla import _row_offsets, build_grid
from .solvers import GenericForce
from .utils.profiling import spanned

__all__ = ["Links", "Draws", "cube_draws", "uniforms",
           "random_cube_neighbours", "linear_force", "link_forces",
           "wall_forces", "link_wall_forces", "xy_wall_relu_force"]


def _pad(n):
    return max(64, -(-int(n) // 64) * 64)


class Draws(NamedTuple):
    """The randoms of one ``Links.update`` of a grid-sampled rule, one per
    link row: a neighbour cube, a uniform that picks a cell in it, and the
    rule's own uniform."""
    pick_cube: torch.Tensor   # int64[n_pad] in [0, 27)
    u: torch.Tensor           # f32[n_pad] in [0, 1)
    noise: torch.Tensor       # f32[n_pad] in [0, 1)


def cube_draws(generator, m, device):
    """A :class:`Draws` of ``m`` rows from ``generator``: the cube, then
    the pick, then the noise."""
    return Draws(torch.randint(0, 27, (m,), generator=generator,
                               device=device),
                 torch.rand(m, generator=generator, device=device),
                 torch.rand(m, generator=generator, device=device))


def uniforms(count):
    """A draws factory: ``count`` uniforms in [0, 1) a link row, as a
    tuple of ``count`` f32 tensors, drawn in order."""
    def draws(generator, m, device):
        return tuple(torch.rand(m, generator=generator, device=device)
                     for _ in range(count))
    return draws


class Links:
    """Fixed-capacity link container (ref links.cuh:24-91).  ``h_a`` /
    ``h_b`` are the host mirror (int32 numpy), ``d_a`` / ``d_b`` the
    int64 tensors on ``device`` (the card unless the caller asks for the
    CPU); ``d_n`` is the active count (an int)."""

    def __init__(self, n_max, strength=1.0 / 5, seed=None, device="cuda"):
        self.device = device_of(device, "Links")
        self.n_max = int(n_max)
        self.n_pad = _pad(self.n_max)
        self.strength = float(strength)
        self.h_a = np.zeros(self.n_pad, np.int32)
        self.h_b = np.zeros(self.n_pad, np.int32)
        self.h_n = self.n_max
        self.d_a = torch.zeros(self.n_pad, dtype=torch.int64,
                               device=self.device)
        self.d_b = torch.zeros_like(self.d_a)
        self.d_n = self.n_max
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def set_d_n(self, n):
        assert n <= self.n_max
        self.d_n = int(n)

    def get_d_n(self):
        return self.d_n

    def copy_to_device(self):
        assert self.h_n <= self.n_max
        self.d_a = torch.as_tensor(self.h_a.astype(np.int64),
                                   device=self.device)
        self.d_b = torch.as_tensor(self.h_b.astype(np.int64),
                                   device=self.device)
        self.d_n = int(self.h_n)

    def copy_to_host(self):
        """The link table into the host mirror, in one transfer (one wait
        for the device)."""
        ab = torch.stack((self.d_a, self.d_b)).cpu().numpy()
        self.h_a, self.h_b = ab.astype(np.int32)
        self.h_n = self.d_n

    def reset(self, check=None):
        """Deactivate links for which ``check(a, b)`` is True (all by
        default), ref links.cuh:66-76.  ``check`` may be vectorised (numpy
        arrays in, bool array out) or a scalar predicate."""
        self.copy_to_host()
        if check is None:
            self.h_a[:] = 0
            self.h_b[:] = 0
        else:
            a = self.h_a[:self.n_max]
            b = self.h_b[:self.n_max]
            try:
                kill = np.asarray(check(a, b), dtype=bool)
                if kill.shape != a.shape:
                    raise TypeError
            except Exception:
                kill = np.fromiter(
                    (bool(check(int(x), int(y))) for x, y in zip(a, b)),
                    dtype=bool, count=self.n_max)
            a[kill] = 0
            b[kill] = 0
        self.copy_to_device()

    @property
    def state(self):
        return (self.d_a, self.d_b, self.d_n, self.strength)

    def draws(self, rule=None, generator=None):
        """One update's randoms for ``rule`` from ``generator`` (this
        table's own by default, else one on its device): the rule's
        ``rule.draws`` factory, :func:`cube_draws` if it names none."""
        factory = getattr(rule, "draws", cube_draws)
        return factory(self.generator if generator is None else generator,
                       self.n_pad, self.device)

    @spanned("rewiring.update")
    def update(self, rule, cells, draws=None):
        """Protrusion rewiring (ref e.g. ``examples/intercalation.cu:32-56``):
        ``rule(a, b, X, n_cells, draws) -> (a', b')`` on every link row;
        rows past the active count keep their links.  ``draws`` defaults to
        :meth:`draws` of the rule.  Traced, the call (its draws and the
        rule) is the span ``rewiring.update``."""
        if draws is None:
            draws = self.draws(rule)
        live = torch.arange(self.n_pad, device=self.d_a.device) < self.d_n
        a2, b2 = rule(self.d_a, self.d_b, cells.d_X, cells.d_n, draws)
        self.d_a = torch.where(live, a2, self.d_a)
        self.d_b = torch.where(live, b2, self.d_b)


def random_cube_neighbours(X, n_cells, cube_size, grid_size, src, pick_cube,
                           u):
    """For each source cell, a random cell of one of its 27 neighbour cubes
    (the grid-sampled proposals of ``examples/growth_w_wall.cu:99-136``):
    cube ``pick_cube`` (in [0, 27)) of the source's stencil, cell
    ``floor(u * count)`` of that cube's sorted run.  Returns (candidate
    ids, found mask)."""
    n_cubes = grid_size ** 3
    tables = build_grid(X, n_cells, cube_size, grid_size)
    offs27 = _row_offsets(grid_size, src.device).reshape(27)
    c = torch.clamp(tables.cid[src] + offs27[pick_cube], 0, n_cubes - 1)
    start = tables.cube_start[c]
    cnt = tables.cube_end[c] - start + 1
    pick = start + torch.minimum((u * cnt).to(torch.int64),
                                 torch.clamp(cnt - 1, min=0))
    n_pad = tables.order.shape[0]
    return tables.order[torch.clamp(pick, 0, n_pad - 1)], cnt >= 1


def linear_force(Xa, Xb, r, dist, strength):
    """Unit-vector spring of constant magnitude (ref links.cuh:99-111).
    Returns (dFa, dFb)."""
    safe = torch.where(dist > 0, dist, 1.0)
    fx = strength * r.x / safe
    fy = strength * r.y / safe
    fz = strength * r.z / safe
    dFa = pt_zeros_like(Xa).replace(x=-fx, y=-fy, z=-fz)
    dFb = pt_zeros_like(Xb).replace(x=fx, y=fy, z=fz)
    return dFa, dFb


def _at(a, i):
    """``a[i]`` for an int ``i`` or a 0-d int64 device tensor (no
    readback)."""
    if isinstance(i, torch.Tensor):
        return a.index_select(0, i.reshape(1)).reshape(())
    return a[i]


def _link_dX(force, X, args):
    """The link forces of ``args = (a, b, n_links, strength)`` on X
    (``n_links`` an int or a 0-d int64 device tensor).  A dead row (past
    ``n_links``, or ``a == b``) adds its zero into a spare row of its own
    past X's rows, so that no address takes the adds of every dead row
    (on the card each is an atomic); the live rows add as they would
    alone."""
    a, b, n_links, strength = args
    m, n_rows = a.shape[0], X.x.shape[0]
    rows = torch.arange(m, device=a.device)
    live = (rows < n_links) & (a != b)
    spare = rows + n_rows
    to_a, to_b = torch.where(live, a, spare), torch.where(live, b, spare)
    Xa = type(X)(*(f[a] for f in X))
    Xb = type(X)(*(f[b] for f in X))
    r = Xa - Xb
    dist = torch.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    dFa, dFb = force(Xa, Xb, r, dist, strength)

    def add(f, fa, fb):
        fa = torch.where(live, torch.as_tensor(fa).expand(live.shape), 0.0)
        fb = torch.where(live, torch.as_tensor(fb).expand(live.shape), 0.0)
        zero = f.new_zeros(n_rows + m)
        return zero.index_add(0, to_a, fa).index_add(0, to_b, fb)[:n_rows]
    return type(X)(*(add(f, fa, fb) for f, fa, fb in zip(X, dFa, dFb)))


def _link_force_fn(force):
    """The generic force of the links alone."""
    def fn(X, n, args):
        return _link_dX(force, X, args)
    return fn


def link_forces(links: Links, force=linear_force, fields=None):
    """GenericForce applying ``force`` over the link table
    (ref links.cuh:128-140).  ``fields`` names the Pt fields it writes
    (x, y, z for the default ``linear_force``)."""
    if fields is None and force is linear_force:
        fields = ("x", "y", "z")
    return GenericForce(fn=_link_force_fn(force), args=links.state,
                        fields=fields,
                        capture_key=("link_forces", force, fields))


# --------------------------------------------------------------------------
# Walls (ref links.cuh:142-228): planes tracked by a "wall node" point.
# --------------------------------------------------------------------------

def xy_wall_relu_force(X, i, wall_idx):
    """ReLU band force on point-to-plane distance for a wall normal to z
    (ref links.cuh:157-169).  Returns (F_z per point, interacting mask)."""
    dist_wall = torch.abs(X.z - _at(X.z, wall_idx))
    interacting = (dist_wall < 1.0) & (i != wall_idx)
    F = torch.clamp(0.8 - dist_wall, min=0) - torch.clamp(dist_wall - 0.8,
                                                          min=0)
    return torch.where(interacting, F, 0.0), interacting


def _wall_dX(w_force, link_force, X, n_cells, args):
    """Wall-node forces, plus the link forces when ``link_force`` is
    given (then ``args = (link_args, wall_idx)``).  The counts (``n_cells``,
    the links' and ``wall_idx``) are ints or 0-d int64 device tensors."""
    if link_force is not None:
        link_args, wall_idx = args
        dX = _link_dX(link_force, X, link_args)
    else:
        wall_idx = args
        dX = pt_zeros_like(X)
    i = torch.arange(X.x.shape[0], device=X.x.device)
    active = i < n_cells
    F, interacting = w_force(X, i, wall_idx)
    F = torch.where(active, F, 0.0)
    n_ints = (interacting & active).sum()
    # reaction on the wall node, averaged over the interactions
    # (ref links.cuh:166-167, 183-195); the division applies to the wall
    # node's whole generic-force dX, as in update_wall_node
    wall_reaction = -F.sum()
    dX = dX.replace(z=dX.z + F)
    scale = torch.where(n_ints > 0, 1.0 / torch.clamp(n_ints, min=1), 1.0)
    upd = {}
    for f in ("x", "y", "z"):
        arr = getattr(dX, f).clone()
        val = (_at(arr, wall_idx) + (wall_reaction if f == "z" else 0.0)) \
            * scale
        if isinstance(wall_idx, torch.Tensor):
            arr.index_put_((wall_idx.reshape(1),), val.reshape(1))
        else:
            arr[wall_idx] = val
        upd[f] = arr
    return dX.replace(**upd)


def wall_forces(wall_idx, w_force=xy_wall_relu_force, fields=("x", "y", "z")):
    """Wall node, no links (ref links.cuh:198-210)."""
    return GenericForce(
        fn=lambda X, n, args: _wall_dX(w_force, None, X, n, args),
        args=int(wall_idx), fields=fields,
        capture_key=("wall_forces", w_force, fields))


def link_wall_forces(links: Links, wall_idx, l_force=linear_force,
                     w_force=xy_wall_relu_force, fields=None):
    """Wall node + links (ref links.cuh:213-228)."""
    if fields is None and l_force is linear_force:
        fields = ("x", "y", "z")
    return GenericForce(
        fn=lambda X, n, args: _wall_dX(w_force, l_force, X, n, args),
        args=(links.state, int(wall_idx)), fields=fields,
        capture_key=("link_wall_forces", l_force, w_force, fields))
