"""Heun integrator, engines and the ``Solution`` facade (subset).

Counterpart of ``yalla_tpu/solvers.py``.  The equation of motion is
v = F + <v(t - dt)> for x, y, z, where <v> is the friction-weighted mean
neighbour velocity (ref solvers.cuh:109-161), and dw/dt = F_w for every
other field.  PyTorch runs eagerly, so a step is a plain function and a
run of steps a Python loop; point counts are Python ints.

Ported: the all-pairs ``TileEngine`` (the plain brute-force oracle and
the all-pairs kernels K3 and K4), the spatial-hash ``GridEngine``, the
``GabrielEngine`` (the windowed and the gather form, and the Gabriel
lattice kernel K5),
generic forces (``GenericForce``, ``gen_forces=``), the ``LatticeEngine``
with every cadence, thin x-cubes and mover routing
(``LatticeEngine.pairwise`` for ``heun_step``, and
``ops.lattice_xla.lattice_heun_steps``, which ``take_steps`` runs),
``solver="auto"``, the switch of ``solver="grid"`` to the lattice above
20k points, and ``Solution.validate``.  On the card a Heun step on the
kernel lattice engine runs as a CUDA graph (``step_graph.py``); any other
step runs its two pair passes eagerly and the glue after each as a CUDA
graph, where its generic force, if any, declares ``capture_key``; the
Gabriel engine's lattice pass, and the lattice or the grid engine's
pass between such glue, is a CUDA graph of its own; ``take_steps``
at a build before every pass runs its builds eagerly and each pass with
its glue as a CUDA graph.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import step_graph
from .dtypes import Float3, device_of
# add_rhs, augment, nonfinite and truncate_aug are importable from here too
from .ops.common import (ERR_PREFIX, add_rhs, augment,  # noqa: F401
                         derivative, fold_pair, fold_steps,
                         friction_on_background, friction_w_neighbour,
                         grid_dims, mean_v, momentum_fix, nonfinite,
                         out_of_grid_mask, truncate_aug)
from .ops.functors import PAIR_FUNCTORS
from .ops.grid_xla import (build_grid, gabriel_pairwise, gabriel_windowed,
                           grid_overflow, grid_pair_sums)
from .ops.lattice_xla import (_merge_extras, lattice_build,
                              lattice_heun_steps, pick_lattice_dims,
                              slot_to_stable)
from .ops.pairwise_xla import tile_pairwise
from .utils.profiling import span, spanned

__all__ = ["TileEngine", "GridEngine", "GabrielEngine", "LatticeEngine",
           "GenericForce", "Solution", "SimulationError", "heun_step",
           "heun_steps", "step_graph_key", "segment_key",
           "lattice_segment_key", "gabriel_pass_key", "lattice_pass_key",
           "grid_pass_key",
           "friction_w_neighbour",
           "friction_on_background"]


class SimulationError(RuntimeError):
    """A failure detected inside the hot loop: engine capacity overflow
    (silent pair/cell loss) or non-finite state
    (ref cudebug.cuh:8-35, solvers.cuh:82, 90, 153-154)."""


@dataclass(frozen=True)
class TileEngine:
    """All-pairs O(N^2) (ref Tile_computer, solvers.cuh:324-342).

    Routing, as in the JAX engine: a ``central_force`` with a friction
    carrying ``central_coef`` goes to the central kernel (``mxu``,
    ``ops/central_mxu.py``, K4); otherwise ``pallas`` goes to the tile
    kernel (``ops/tile_pallas.py``, K3); otherwise to the plain
    ``tile_pairwise`` in ``j_block`` columns (default 1024).  ``None``
    resolves to the kernels on CUDA tensors (as JAX resolves it on the
    TPU) and to the plain path on the CPU; ``mxu`` defaults to ``pallas``.
    The kernel wrappers run their plain versions on CPU tensors.  The
    ``n_pad % 128`` condition is the TPU kernels' layout rule: it is kept
    on the CPU, where it keeps the routing identical to JAX's, and dropped
    on CUDA, whose kernels take any ``n_pad``.

    The ``(i_offset, i_size)`` window (the rows the sharded cells path,
    ``parallel/spmd.py``, gives each rank) goes to the plain pass, as JAX
    routes it: the kernels sum the whole population only, and JAX's
    sharded path runs no Pallas kernel either."""
    j_block: int | None = None
    pallas: bool | None = None
    mxu: bool | None = None

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        del cube_size  # no cutoff in the all-pairs engine
        cuda = X.x.device.type == "cuda"
        use_pallas = self.pallas if self.pallas is not None else cuda
        use_mxu = self.mxu if self.mxu is not None else use_pallas
        aligned = (cuda or X.x.shape[0] % 128 == 0) \
            and _whole(i_offset, i_size)
        if use_mxu and aligned \
                and getattr(pw_int, "fields", None) is not None \
                and hasattr(pw_int, "coef") \
                and hasattr(pw_friction, "central_coef"):
            from .ops.central_mxu import central_pairwise_mxu
            return central_pairwise_mxu(pw_int, pw_friction, X, old_v, n)
        if use_pallas and aligned:
            from .ops.tile_pallas import tile_pairwise_pallas
            return tile_pairwise_pallas(pw_int, pw_friction, X, old_v, n)
        return tile_pairwise(pw_int, pw_friction, X, old_v, n,
                             j_block=self.j_block or 1024,
                             i_offset=i_offset, i_size=i_size)


def _whole(i_offset, i_size):
    """True for the window of the whole population."""
    return i_offset == 0 and i_size is None


@dataclass(frozen=True)
class GridEngine:
    """Spatial-hash O(N) with the ``dist < cube_size`` cutoff
    (ref Grid_computer, solvers.cuh:465-502); ``ops/grid_xla.py``, with
    its ``(i_offset, i_size)`` window.

    On the card the whole gather pass (the build's sort and scatter
    tables, the candidate gathers, the pair force and the sums) can be
    a CUDA graph's replay (``graph``), the pair force captured with it:
    a pair force reads nothing back, has no shape that depends on the
    data, and reads what it reads besides its arguments (a module's
    constants) as the capture found it, the contract under which the
    JAX package traces the same force under ``jit``."""
    grid_size: int = 50
    row_cap: int = 32
    i_block: int = 4096

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None, graph=False):
        """One gather pass (``ops.grid_xla.grid_pairwise``) on the rows
        ``[i_offset, i_offset + i_size)`` (default: all).

        With ``graph``, where :func:`grid_pass_key` gives a key, the pass
        is a CUDA graph's replay (:func:`.step_graph.grid_pass`), bit for
        bit the eager pass, whose outputs are the graph's own tensors,
        overwritten at its next replay: ``_heun`` asks for it between a
        step's glue segments and hands them straight to a segment, which
        copies them in.  Traced, the span ``grid.build`` times the key and
        the build (the cube ids, the sort and the two scatter tables; on
        a replay, the load of the inputs), ``grid.pair`` the rest (the
        blocks' row ranges, gathers, force and sums; on a replay, the
        replay), once a pass each."""
        def build(Xc, nc):
            return build_grid(Xc, nc, cube_size, self.grid_size)

        def pair(tables, Xc, ovc, nc):
            return grid_pair_sums(pw_int, pw_friction, Xc, ovc, nc,
                                  cube_size, tables,
                                  grid_size=self.grid_size,
                                  row_cap=self.row_cap, i_block=self.i_block,
                                  i_offset=i_offset, i_size=i_size)

        def whole(Xc, ovc, nc):
            return pair(build(Xc, nc), Xc, ovc, nc)

        with span("grid.build"):
            key = grid_pass_key(self, pw_int, pw_friction, X, cube_size,
                                i_offset, i_size) if graph else None
            g = None if key is None else step_graph.grid_pass(
                key, whole, X, old_v, n)
            if g is None:
                tables = build(X, n)
        with span("grid.pair"):
            if g is not None:
                return g.replay()
            return pair(tables, X, old_v, n)


@dataclass(frozen=True)
class GabrielEngine:
    """Grid + Gabriel-graph neighbourhood pruning (ref Gabriel_computer,
    solvers.cuh:604-644).

    ``lattice`` runs the Gabriel lattice pass (``ops/gabriel_pallas.py``:
    the CUDA kernel K5 on CUDA tensors, its plain version on CPU tensors),
    on a dense lattice of ``grid_size`` cubes with ``capacity`` slots each.
    ``None`` resolves to it on CUDA tensors, as JAX resolves it on the
    TPU; on the CPU, as in JAX off the TPU, to the grid path.  The CUDA
    kernel takes any grid, so the TPU kernel's shape rules
    (:meth:`_lattice_fits`) do not enter the routing.

    Off the lattice, as in JAX, ``windowed`` runs ``gabriel_windowed``
    (the JAX default): subgroups of ``subgroup`` consecutive cube-sorted
    points in blocks of ``i_block`` share nine windows of ``window_cap``
    sorted entries, and up to ``salvage_cap`` points that misfit their
    windows are salvaged exactly by the gather form (more raise
    ``__err_gabriel_window``).  ``windowed=False``, and any window
    ``(i_offset, i_size)`` of the sharded cells path, run the gather form
    ``gabriel_pairwise``: K5 and the windowed pass sum the whole
    population only.  ``z_block`` is the TPU kernel's block height, read
    only by :meth:`_lattice_fits`.  On the card the lattice route is a
    CUDA graph's replay (:meth:`_lattice_pass`).  Traced, the lattice
    route's build (the sort glue and the pour K2) is the span
    ``gabriel.build`` and its pair pass (K5's wrapper) ``gabriel.pair``."""
    grid_size: int = 50
    row_cap: int = 32
    gabriel_coefficient: float = 0.8
    i_block: int = 256
    max_candidates: int = 100
    windowed: bool = True
    window_cap: int = 64
    salvage_cap: int = 256
    subgroup: int | None = 16
    lattice: bool | None = None
    capacity: int = 8
    z_block: int = 2

    def _lattice_fits(self):
        """The TPU kernel's shape rules: x-row of slots lane-aligned, y
        extent in blocks of 8, z extent in blocks of ``z_block``."""
        gx, gy, gz = grid_dims(self.grid_size)
        return ((gx * self.capacity) % 128 == 0 and gy % 8 == 0
                and gz % self.z_block == 0)

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None):
        use_lattice = self.lattice if self.lattice is not None \
            else X.x.device.type == "cuda"
        if use_lattice and _whole(i_offset, i_size):
            return self._lattice_pass(pw_int, pw_friction, X, old_v, n,
                                      cube_size)
        if self.windowed and _whole(i_offset, i_size):
            return gabriel_windowed(
                pw_int, pw_friction, X, old_v, n, cube_size,
                grid_size=self.grid_size,
                gabriel_coefficient=self.gabriel_coefficient,
                i_block=self.i_block, window_cap=self.window_cap,
                max_candidates=self.max_candidates, row_cap=self.row_cap,
                salvage_cap=self.salvage_cap, subgroup=self.subgroup)
        return gabriel_pairwise(
            pw_int, pw_friction, X, old_v, n, cube_size,
            grid_size=self.grid_size, row_cap=self.row_cap,
            gabriel_coefficient=self.gabriel_coefficient,
            i_block=self.i_block, max_candidates=self.max_candidates,
            i_offset=i_offset, i_size=i_size)

    def _lattice_pass(self, pw_int, pw_friction, X, old_v, n, cube_size):
        """The lattice route: the build (the sort glue and K2), then K5's
        wrapper; where :func:`gabriel_pass_key` gives a key, a CUDA
        graph's replay (:func:`.step_graph.gabriel_pass`), bit for bit the
        eager pass.  The span ``gabriel.build`` times the key and the build
        (on a replay, the load of the inputs), ``gabriel.pair`` the pair
        pass (on a replay, the replay and the copies out)."""
        from .ops.gabriel_pallas import gabriel_lattice_pallas

        def build(Xc, ovc, nc):
            return lattice_build(Xc, ovc, nc, cube_size, self.grid_size,
                                 self.capacity, 0)

        def pair(lay, Xc, ovc, nc):
            return gabriel_lattice_pallas(
                pw_int, pw_friction, Xc, ovc, nc, cube_size,
                grid_size=self.grid_size, capacity=self.capacity,
                max_candidates=self.max_candidates,
                gabriel_coefficient=self.gabriel_coefficient, lay=lay)

        with span("gabriel.build"):
            key = gabriel_pass_key(self, pw_int, pw_friction, X, cube_size)
            graph = None if key is None else step_graph.gabriel_pass(
                key, lambda *t: pair(build(*t), *t), X, old_v, n)
            if graph is None:
                lay = build(X, old_v, n)
        with span("gabriel.pair"):
            return pair(lay, X, old_v, n) if graph is None \
                else graph.replay()


@dataclass(frozen=True)
class LatticeEngine:
    """Dense cube-lattice engine (see ops/lattice_xla.py).

    The pair pass and the pour run through their kernel wrappers
    (``ops/lattice_pallas.py``, ``ops/lattice_pour.py``): the hand-written
    CUDA kernels for tensors on the GPU, their plain torch versions for
    tensors on the CPU, whatever ``pallas`` says.  ``pallas`` keeps the
    JAX engine's name and its one difference in function: ``pallas=False``
    (the JAX engine's default, its XLA route) drops ``extras_cap``, as JAX
    drops it; ``pallas=True`` (the port's default) honours it
    (``__err_extras_block`` as the kernels raise it).  So a JAX
    ``LatticeEngine(pallas=False)`` and this engine with ``pallas=False``
    (or ``extras_cap=0``, as ``interop.engine_from`` maps it) raise the same
    flags on the same states.  ``z_block`` is the JAX kernel's z-block
    height, which sets the blocks of ``__err_extras_block``.

    As in the JAX engine: ``rebuild_every`` is the binning's cadence (1:
    a fresh binning before every pass, the reference's); ``force_r_max``
    (the force's interaction radius) makes a resident cadence certify
    itself (``__err_stale`` where the cells' motion could hide a pair
    within the margin ``cube_size - force_r_max``); ``route_movers`` (> 0,
    with extras and a resident cadence) sends the cells whose
    extrapolated chunk displacement could eat half that margin into the
    extras list; ``x_split`` bins x at ``cube_size / x_split`` (thin
    x-cubes, of which ``grid_size``'s x counts; a pass reaches
    ``x_split`` of them on each side), which needs ``rebuild_every``
    1."""
    grid_size: int | tuple = 64
    capacity: int = 8
    z_block: int = 4
    rebuild_every: int = 1
    pallas: bool = True
    force_r_max: float | None = None
    extras_cap: int = 0
    extras_block_cap: int = 16
    route_movers: float = 0.0
    x_split: int = 1

    def __post_init__(self):
        # z_block must divide the grid's z extent (the JAX kernel's blocks)
        gz = grid_dims(self.grid_size)[2]
        zb = min(self.z_block, gz)
        while gz % zb:
            zb -= 1
        object.__setattr__(self, "z_block", max(zb, 1))

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size,
                 i_offset=0, i_size=None, graph=False):
        """One pair pass in stable-id order: a fresh binning
        (``lattice_build``, whose pour is K2), the pair pass in slot order
        (K1), every sum gathered back by ``slot_to_stable``, the overflow
        extras' sums written at their ids, and the pass's own flags
        (dropped cells lose all their pairs; out-of-grid cells are
        mis-binned, ref solvers.cuh:361-364).  The pass covers the whole
        population: a window raises ``ValueError``, where JAX asserts.

        With ``graph``, where :func:`lattice_pass_key` gives a key, the
        pass is a CUDA graph's replay (:func:`.step_graph.lattice_pass`),
        bit for bit the eager pass, whose outputs are the graph's own
        tensors, overwritten at its next replay: ``_heun`` asks for it
        between a step's glue segments and hands them straight to a
        segment, which copies them in.  The span ``lattice.build`` times
        the key and the build (on a replay, the load of the inputs),
        ``lattice.pair`` K1's wrapper (on a replay, the replay)."""
        if not _whole(i_offset, i_size):
            raise ValueError("LatticeEngine.pairwise takes no (i_offset, "
                             "i_size) window; the z-slab path is "
                             "parallel.lattice_spmd.ShardedLatticeEngine")
        from .ops.lattice_pallas import lattice_pairwise_pallas
        extras = self.extras_cap if self.pallas else 0

        def build(Xc, ovc, nc):
            return lattice_build(Xc, ovc, nc, cube_size, self.grid_size,
                                 self.capacity, extras, x_split=self.x_split)

        def pair(lay, nc):
            return lattice_pairwise_pallas(
                pw_int, pw_friction, lay, nc, cube_size,
                grid_size=self.grid_size, capacity=self.capacity,
                z_block=self.z_block,
                extras_block_cap=self.extras_block_cap, x_split=self.x_split)

        def whole(Xc, ovc, nc):
            lay = build(Xc, ovc, nc)
            return _stable_sums(lay, pair(lay, nc), extras)

        with span("lattice.build"):
            key = lattice_pass_key(self, pw_int, pw_friction, X, cube_size) \
                if graph else None
            g = None if key is None else step_graph.lattice_pass(
                key, whole, X, old_v, n)
            if g is None:
                lay = build(X, old_v, n)
        with span("lattice.pair"):
            if g is not None:
                return g.replay()
            outs = pair(lay, n)
        return _stable_sums(lay, outs, extras)


def _stable_sums(lay, outs, extras):
    """A lattice pass's outputs ``(F, sum_f, sum_v, aux)`` in stable-id
    order from K1's outputs ``outs`` on the layout ``lay``: the gathers,
    the extras' sums merged at their ids, and the pass's flags."""
    F, sum_f, sum_v, aux = (slot_to_stable(lay, t) for t in outs[:4])
    if extras:
        Fe, sum_fe, sum_ve, aux_e = outs[4]

        def merge(a, e):
            return _merge_extras(lay, a, e)
        F = type(F)(*(merge(a, e) for a, e in zip(F, Fe)))
        sum_f = merge(sum_f, sum_fe)
        sum_v = tuple(merge(a, e) for a, e in zip(sum_v, sum_ve))
        aux_e = dict(aux_e)
        blk = aux_e.pop("__err_extras_block")
        aux = {k: merge(aux[k], aux_e[k]) for k in aux}
        aux["__err_extras_block"] = blk
    aux["__err_lattice_dropped"] = lay.n_dropped.to(torch.float32)
    aux["__err_out_of_grid"] = lay.n_oob.to(torch.float32)
    return F, sum_f, sum_v, aux


# --------------------------------------------------------------------------
# Generic forces (the reference's Generic_forces hook, solvers.cuh:43-53)
# --------------------------------------------------------------------------

class GenericForce(NamedTuple):
    """A generic force with explicit state: ``fn(X, n, args) -> dX`` is
    added to the pair forces of every pass, before the friction mixing.
    ``fields`` names the Pt fields it writes (``None``: all).

    ``capture_key``, a hashable value or None (the default), names what
    ``fn`` computes from ``args`` and promises that it reads nothing
    back: two forces with equal keys compute the same function.  On the
    card a step then captures the force with the glue around it
    (:func:`segment_key`), ``n`` and each int in ``args`` as a 0-d int64
    device tensor, each float as it is; a force without one runs
    eagerly."""
    fn: Callable[..., Any]
    args: Any = None
    fields: tuple | None = None
    capture_key: Any = None


def _as_generic(gen_forces):
    """``None``, a ``GenericForce``, or a plain ``fn(X, n) -> dX``, as a
    ``GenericForce`` (or ``None``)."""
    if gen_forces is None or isinstance(gen_forces, GenericForce):
        return gen_forces
    return GenericForce(lambda X, n, args: gen_forces(X, n))


# --------------------------------------------------------------------------
# Heun predictor-corrector (ref Heun_solver::take_step, solvers.cuh:226-275)
# --------------------------------------------------------------------------

def _glue(pw_int, fix_mode, fix_point, X, Xa, out, n, gen, gen_args):
    """The derivative from a pair pass's outputs ``out`` on ``Xa`` (X
    augmented): ``ops.common.derivative`` with the generic force, the
    flags' max, the momentum fix and the non-finite flag.  ``n`` and the
    ints of ``gen_args`` are Python ints, or 0-d device tensors inside a
    segment's graph."""
    active = torch.arange(X.x.shape[0], device=X.x.device) < n
    add_gen = None if gen is None else \
        (lambda F: F + gen.fn(X, n, gen_args))
    dX, aux = derivative(pw_int, out, Xa, type(X), active, add_gen)
    aux = {k: (v.max() if k.startswith(ERR_PREFIX) else v)
           for k, v in aux.items()}
    dX, = momentum_fix([(dX, active, 0)], n, fix_mode, fix_point)
    aux["__err_non_finite"] = nonfinite(dX).to(torch.float32)
    return dX, aux


def step_graph_key(engine, pw_int, pw_friction, fix_mode, X, old_v, dt,
                   cube_size, fix_point=0, precompute=None, gen=None):
    """The key of the step's CUDA graph (:mod:`.step_graph`), or None
    where :func:`heun_step` does not capture the whole step.  A step is
    captured on a ``LatticeEngine`` (not a subclass) with ``pallas``, on
    CUDA tensors, with no generic force and with ``dt``, ``cube_size``
    and ``fix_point`` Python numbers.  The key is what the capture bakes
    in: the engine (by value), the force, the friction and the precompute
    (by identity), the parameters of the force's CUDA functor (by value),
    the momentum fix, ``dt``, the cube size, the point type, the shapes,
    dtypes and device of the state."""
    if type(engine) is not LatticeEngine or not engine.pallas \
            or gen is not None:
        return None
    state = (*X, *old_v)
    return _key(state, engine, pw_int, pw_friction, precompute, fix_mode,
                fix_point, dt, cube_size, type(X),
                tuple((tuple(a.shape), a.dtype) for a in state), X.x.device)


def segment_key(engine, pw_int, pw_friction, fix_mode, X, dt, cube_size,
                fix_point=0, precompute=None, gen=None):
    """The key of the step's glue segments (:func:`.step_graph.segment`),
    or None where :func:`heun_step` runs its glue eagerly.  The glue is
    captured on CUDA tensors, with ``dt``, ``cube_size`` and
    ``fix_point`` Python numbers, and with no generic force or one that
    declares ``capture_key`` (user code that declares none may read
    back).  The key holds what :func:`step_graph_key` holds but the
    state's shapes, which the segments' inputs add (``step_graph.
    cache_key``), and the force's ``capture_key``."""
    if gen is not None and gen.capture_key is None:
        return None
    return _key(X, engine, pw_int, pw_friction, precompute, fix_mode,
                fix_point, dt, cube_size, type(X),
                None if gen is None else gen.capture_key)


def lattice_segment_key(engine, rebuild_every, pw_int, pw_friction,
                        fix_mode, X, dt, cube_size, fix_point=0,
                        precompute=None, gen=None, rebin_m_cap=0):
    """The key of the glue segments of ``lattice_heun_steps`` on
    ``engine`` (:func:`.step_graph.segment`), or None where its loop runs
    eagerly: at any cadence but a fresh binning before every pass
    (``rebuild_every`` 1, no ``rebin_m_cap``, no generic force), off
    CUDA, inside another capture, or where ``dt``, ``cube_size`` or
    ``fix_point`` is not a Python number.  The key holds what
    :func:`segment_key` holds (the engine by value: its grid, capacity,
    ``z_block``, extras caps and ``x_split``) and the loop's name; the
    inputs' shapes add to it (``step_graph.cache_key``)."""
    if rebuild_every != 1 or rebin_m_cap or gen is not None \
            or _capturing():
        return None
    return _key(X, engine, pw_int, pw_friction, precompute, fix_mode,
                fix_point, dt, cube_size, type(X), "lattice_heun_steps")


def gabriel_pass_key(engine, pw_int, pw_friction, X, cube_size,
                     i_offset=0, i_size=None):
    """The key of the Gabriel lattice pass's CUDA graph
    (:func:`.step_graph.gabriel_pass`), or None where the pass runs
    eagerly: off CUDA, on a window ``(i_offset, i_size)``, where
    ``cube_size`` is not a Python number, inside another capture, or where
    the key does not hash.  The key is what the capture bakes in: the
    engine (by value), the force and the friction (by identity), the
    parameters of the force's CUDA functor (by value, K5 reads them at
    launch), the cube size and the point type; the inputs' shapes add to
    it (``step_graph.cache_key``), their count does not."""
    return _pass_key(engine, pw_int, pw_friction, X, cube_size, i_offset,
                     i_size)


def lattice_pass_key(engine, pw_int, pw_friction, X, cube_size,
                     i_offset=0, i_size=None):
    """The key of the lattice engine's pair pass as a CUDA graph
    (:func:`.step_graph.lattice_pass`), or None where the pass runs
    eagerly: for an engine that is not exactly a ``LatticeEngine``, off
    CUDA, on a window ``(i_offset, i_size)``, where ``cube_size`` is not a
    Python number, inside another capture, or where the key does not hash.
    The key is what the capture bakes in: the engine (by value: its grid,
    capacity, ``z_block``, extras caps, ``x_split`` and ``pallas``), the
    force and the friction (by identity), the parameters of the force's
    CUDA functor (by value, K1 reads them at launch), the cube size and
    the point type; the inputs' shapes add to it (``step_graph.
    cache_key``), their count does not."""
    if type(engine) is not LatticeEngine:
        return None
    return _pass_key(engine, pw_int, pw_friction, X, cube_size, i_offset,
                     i_size)


def grid_pass_key(engine, pw_int, pw_friction, X, cube_size, i_offset=0,
                  i_size=None):
    """The key of the grid engine's gather pass as a CUDA graph
    (:func:`.step_graph.grid_pass`), or None where the pass runs eagerly:
    for an engine that is not exactly a ``GridEngine``, off CUDA, on a
    window ``(i_offset, i_size)``, where ``cube_size`` is not a Python
    number, inside another capture, or where the key does not hash.  The
    key is what the capture bakes in: the engine (by value: its grid,
    ``row_cap`` and ``i_block``), the force and the friction (by
    identity), the parameters of the force's CUDA functor (by value, None
    for a Python force), the cube size and the point type; the inputs'
    shapes add to it (``step_graph.cache_key``), their count does not."""
    if type(engine) is not GridEngine:
        return None
    return _pass_key(engine, pw_int, pw_friction, X, cube_size, i_offset,
                     i_size)


def _pass_key(engine, pw_int, pw_friction, X, cube_size, i_offset, i_size):
    """The key of an engine's pair pass as a CUDA graph (the Gabriel, the
    lattice and the grid engine's), or None off CUDA, on a window, where
    ``cube_size`` is not a Python number, inside another capture, or where
    the key does not hash."""
    if not _whole(i_offset, i_size) or not all(a.is_cuda for a in X) \
            or not isinstance(cube_size, (int, float)) or _capturing():
        return None
    return _hashable((engine, pw_int, pw_friction, _functor_values(pw_int),
                      cube_size, type(X)))


def _capturing():
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _key(state, engine, pw_int, pw_friction, precompute, fix_mode,
         fix_point, dt, cube_size, *rest):
    """The graph key of a step on ``state`` with ``rest`` appended, or
    None off CUDA, where ``dt``, ``cube_size`` or ``fix_point`` is not a
    Python number, or where the key does not hash."""
    if not all(a.is_cuda for a in state) or not all(
            isinstance(v, (int, float)) for v in (dt, cube_size, fix_point)):
        return None
    return _hashable((engine, pw_int, pw_friction, precompute,
                      _functor_values(pw_int), fix_mode, fix_point, type(dt),
                      dt, cube_size, *rest))


def _hashable(key):
    """``key``, or None where it does not hash."""
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _functor_values(pw_int):
    """The parameters a kernel reads from the force's CUDA functor at each
    launch (``ops.functors.param_array``), None without one."""
    functor = getattr(pw_int, "cuda_functor", None)
    if functor is None or functor[0] not in PAIR_FUNCTORS:
        return None
    return (functor[0],) + tuple(
        getattr(functor[1], k, None)
        for k in PAIR_FUNCTORS[functor[0]]["params"])


@spanned("integrator.heun_step")
def heun_step(engine, pw_int, pw_friction, fix_mode, X, old_v, n, dt,
              cube_size, fix_point=0, precompute=None, gen=None,
              gen_args=None):
    """One 2nd-order step: ``(X, old_v) -> (X', old_v', aux)``.  ``gen``
    is a ``GenericForce`` (its ``args`` ignored) called with
    ``gen_args``.  Where :func:`step_graph_key` gives a key, the step is
    a CUDA graph's replay (:mod:`.step_graph`); else, where
    :func:`segment_key` gives one, the glue after each of its two pair
    passes is (the passes run eagerly, a ``LatticeEngine``'s or a
    ``GridEngine``'s as graphs of their own): the same kernels on the
    same inputs, bit for bit the eager step."""
    def body(Xc, ovc, nc, segment=step_graph.eager):
        return _heun(engine, pw_int, pw_friction, fix_mode, Xc, ovc, nc, dt,
                     cube_size, fix_point, precompute, gen, gen_args,
                     segment)
    key = step_graph_key(engine, pw_int, pw_friction, fix_mode, X, old_v,
                         dt, cube_size, fix_point, precompute, gen)
    if key is not None:
        return step_graph.run(key, body, X, old_v, n)
    return body(X, old_v, n, _segments(
        segment_key(engine, pw_int, pw_friction, fix_mode, X, dt, cube_size,
                    fix_point, precompute, gen)))


def _segments(key):
    """A step's ``segment(tag, body, inputs, copy)``: the CUDA graphs of
    ``key`` (:func:`.step_graph.segment`), or each body run as it stands
    where ``key`` is None."""
    if key is None:
        return step_graph.eager
    return lambda tag, fn, tree, copy: step_graph.segment(key + (tag,), fn,
                                                          tree, copy)


def _heun(engine, pw_int, pw_friction, fix_mode, X, old_v, n, dt,
          cube_size, fix_point, precompute, gen, gen_args,
          segment=step_graph.eager):
    """The step of :func:`heun_step`: the two pair passes called here, the
    glue after each as ``segment(tag, body, inputs, copy) ->
    body(inputs)`` (:func:`.step_graph.segment` replays it; ``copy``: its
    outputs leave the step)."""
    pt = type(X)

    def first(t):
        Xa, out, nc, args = t
        X0 = truncate_aug(Xa, pt)
        dX, aux1 = _glue(pw_int, fix_mode, fix_point, X0, Xa, out, nc, gen,
                         args)
        return dX, aux1, X0 + dX * dt

    def second(t):
        X0, X1a, dX, aux1, out, nc, args = t
        dX1, aux = _glue(pw_int, fix_mode, fix_point, truncate_aug(X1a, pt),
                         X1a, out, nc, gen, args)
        return X0 + (dX + dX1) * (0.5 * dt), mean_v(dX, dX1), \
            fold_pair(aux, aux1)

    # between glue segments a lattice or a grid engine's pass is a graph
    # of its own, whose outputs the segment after it copies in; the whole
    # step's graph, which runs this eagerly, holds no pass graph
    kw = {"graph": True} if segment is not step_graph.eager \
        and type(engine) in (LatticeEngine, GridEngine) else {}
    Xa = augment(X, n, precompute)
    out = engine.pairwise(pw_int, pw_friction, Xa, old_v, n, cube_size, **kw)
    dX, aux1, X1 = segment("first", first, (Xa, out, n, gen_args), False)
    X1a = augment(X1, n, precompute)
    out = engine.pairwise(pw_int, pw_friction, X1a, old_v, n, cube_size,
                          **kw)
    return segment("second", second, (X, X1a, dX, aux1, out, n, gen_args),
                   True)


def heun_steps(n_steps, engine, pw_int, pw_friction, fix_mode, X, old_v, n,
               dt, cube_size, fix_point=0, precompute=None, gen=None,
               gen_args=None):
    """``n_steps`` steps of ``heun_step``.  Failure flags are the max over
    the steps (a transient overflow mid-run already mis-integrated the
    state); every other aux channel is the last step's."""
    acc = {}
    for _ in range(int(n_steps)):
        X, old_v, aux = heun_step(engine, pw_int, pw_friction, fix_mode, X,
                                  old_v, n, dt, cube_size, fix_point,
                                  precompute, gen, gen_args)
        acc = fold_steps(acc, aux)
    return X, old_v, acc


# --------------------------------------------------------------------------
# Solution facade (ref Solution<Pt, Solver>, solvers.cuh:60-106)
# --------------------------------------------------------------------------

def _pad_size(n_max):
    if n_max <= 4096:
        return max(128, -(-n_max // 128) * 128)
    return -(-n_max // 4096) * 4096


def _engine_for(solver, n_max, grid_size, row_cap, gabriel_coefficient):
    """The engine ``Solution(solver=...)`` names (the JAX package's
    selection); ``None`` where it is picked from the state at first use
    (``"auto"``, and ``"grid"`` above 20k points)."""
    if solver == "tile":
        return TileEngine()
    if solver == "grid":
        if n_max > 20_000:
            return None
        return GridEngine(grid_size=grid_size, row_cap=row_cap)
    if solver == "lattice":
        return LatticeEngine(grid_size=grid_size)
    if solver == "gabriel":
        return GabrielEngine(grid_size=grid_size, row_cap=row_cap,
                             gabriel_coefficient=gabriel_coefficient)
    if solver == "auto":
        return None
    raise ValueError(f"unknown solver {solver!r}")


def cube_occupancy(x, y, z, cube_size):
    """``(extent, max_occ)`` of host positions: the largest |coordinate|
    and the most points in one cube of ``cube_size``."""
    h = [np.asarray(a) for a in (x, y, z)]
    extent = max(float(np.max(np.abs(a))) for a in h)
    cid = 0
    for a in h:
        cid = cid * (2 ** 21) + np.floor(a / cube_size).astype(np.int64)
    return extent, int(np.unique(cid, return_counts=True)[1].max())


class Solution:
    """Host facade owning padded device state + a host mirror.

    ``h_X`` is a Pt of numpy arrays (mutable in place); ``copy_to_device``
    / ``copy_to_host`` move it to and from ``device``, the card unless
    the caller asks for the CPU (``device="cpu"``): without a GPU the
    default raises.  ``n_pad``
    (default: ``n_max`` rounded up as the JAX package rounds it) is the
    row count of the device state.

    Without ``engine``, ``solver`` names one as in the JAX package:
    ``"tile"``, ``"grid"``, ``"lattice"`` or ``"gabriel"``, sized by
    ``grid_size``, ``row_cap`` and ``gabriel_coefficient``, or ``"auto"``.
    ``"auto"``, and ``"grid"`` above 20k points, leave ``engine`` None
    until the first step or ``validate``, which pick it from the state
    (:meth:`_auto_engine`)."""

    def __init__(self, pt_type, n_max, *, solver="tile", grid_size=50,
                 cube_size=1.0, row_cap=32, gabriel_coefficient=0.8,
                 engine=None, device="cuda", n_pad=None):
        self.device = device_of(device, "Solution")
        self.pt_type = pt_type
        self.n_max = int(n_max)
        self.n_pad = int(n_pad) if n_pad else _pad_size(self.n_max)
        if self.n_pad < self.n_max:
            raise ValueError(f"Solution: n_pad {self.n_pad} < n_max "
                             f"{self.n_max}")
        # set when solver="grid" resolves to an auto lattice: the lattice
        # must then cover the REQUESTED grid extent, not just the initial
        # state's bounding box
        self._requested_grid_size = None
        if engine is None:
            engine = _engine_for(solver, self.n_max, grid_size, row_cap,
                                 gabriel_coefficient)
            if engine is None and solver == "grid":
                self._requested_grid_size = int(grid_size)
        self.engine = engine
        self.cube_size = float(cube_size)
        self.h_X = pt_type(*[np.zeros(self.n_pad, np.float32)
                             for _ in pt_type._fields])
        self.h_n = self.n_max
        self.d_X = None
        self.d_old_v = Float3.zeros(self.n_pad, device=self.device)
        self.d_n = self.n_max
        self.aux: dict = {}
        self._fix_mode = "com"
        self._fix_point = 0

    # -- host <-> device ----------------------------------------------------
    def copy_to_device(self):
        assert self.h_n <= self.n_max
        # np.array copies: on the CPU the device state must not share the
        # host mirror's memory, which callers write in place
        self.d_X = self.pt_type(*[
            torch.as_tensor(np.array(f, np.float32), device=self.device)
            for f in self.h_X])
        self.d_n = int(self.h_n)

    def copy_to_host(self):
        """The device state into the host mirror, in one transfer (one
        wait for the device), each field an array of its own."""
        assert self.d_X is not None
        host = torch.stack(tuple(self.d_X)).cpu().numpy()
        self.h_X = self.pt_type(*[f.copy() for f in host])
        self.h_n = self.d_n
        return self.h_X

    def get_d_n(self):
        return int(self.d_n)

    @property
    def n_active(self):
        return self.d_n

    # -- momentum fixing (ref solvers.cuh:196-208) ---------------------------
    def set_fixed(self, point_id=None):
        if point_id is None:
            self._fix_mode = "com"
        else:
            self._fix_mode = "point"
            self._fix_point = int(point_id)

    def set_fixed_xy(self, point_id):
        self._fix_mode = "com_z"
        self._fix_point = int(point_id)

    # -- integration ----------------------------------------------------------
    def _ensure_device(self):
        if self.d_X is None:
            self.copy_to_device()
        if self.engine is None:
            self.engine = self._auto_engine()

    def _auto_engine(self):
        """Pick an engine from capacity and the current state's extent, as
        the JAX package does (host numpy on the state, one readback):
        all-pairs up to 2048 points (cf. ref solvers.cuh:346-347), the
        dense lattice above, (grid, capacity) sized jointly to the
        populated bounding box and the measured occupancy
        (``ops.lattice_xla.pick_lattice_dims``; growth or drift past them
        raises through the in-loop flags).  Where the JAX package asks
        whether its backend is the TPU to pick ``pallas``, the port's
        lattice engine asks nothing: its pair pass takes the kernel for a
        CUDA state and the plain version for a CPU state by itself."""
        if self.n_max <= 2048:
            return TileEngine()
        n = int(self.d_n)
        if n:
            extent, max_occ = cube_occupancy(
                *(a[:n].cpu().numpy() for a in
                  (self.d_X.x, self.d_X.y, self.d_X.z)), self.cube_size)
        else:
            extent, max_occ = 1.0, 1
        margin = max(2.0 * self.cube_size, 0.3 * extent)
        extent = extent + margin
        if self._requested_grid_size is not None:
            # solver="grid": honour the extent the caller sized the grid
            # for (grid_size cubes across), not just today's bounding box
            extent = max(extent,
                         self._requested_grid_size * self.cube_size / 2)
            warnings.warn(
                f"Solution(solver='grid', n_max={self.n_max}) uses the "
                f"dense lattice engine above 20k points (same cutoff "
                f"physics; sized to cover the requested "
                f"{self._requested_grid_size}-cube grid). Pass an explicit "
                f"engine= to override.", stacklevel=3)
        gs, cap = pick_lattice_dims(extent, self.cube_size, max_occ + 1)
        return LatticeEngine(grid_size=gs, capacity=cap, z_block=2)

    def take_step(self, dt, pw_int, *, pw_friction=friction_w_neighbour,
                  gen_forces=None, precompute=None, check_errors=True):
        """One Heun step (ref Solution::take_step, solvers.cuh:94-105):
        :func:`heun_steps` on ``engine.pairwise`` for every engine, as in
        the JAX package.  On a ``LatticeEngine`` that rebuilds the lattice
        before each pass whatever ``rebuild_every`` says (its cadence is
        :meth:`take_steps`'), and a generic force composes with its
        overflow extras."""
        self._ensure_device()
        self._heun_steps(1, dt, pw_int, pw_friction,
                         _as_generic(gen_forces), precompute)
        if check_errors:
            self._check_errors()
        return self.aux

    def _heun_steps(self, n_steps, dt, pw_int, pw_friction, gen,
                    precompute):
        self.d_X, self.d_old_v, self.aux = heun_steps(
            n_steps, self.engine, pw_int, pw_friction, self._fix_mode,
            self.d_X, self.d_old_v, self.d_n, dt, self.cube_size,
            self._fix_point, precompute, gen,
            gen.args if gen is not None else None)

    @spanned("integrator.take_steps")
    def take_steps(self, n_steps, dt, pw_int, *,
                   pw_friction=friction_w_neighbour, gen_forces=None,
                   precompute=None, check_errors=True):
        """``n_steps`` Heun steps.  With a LatticeEngine this runs the
        lattice integrator (the derivative kept in slot order) at the
        engine's cadence: every ``k`` steps a fresh binning, ``k`` the
        largest divisor of ``n_steps`` not above ``rebuild_every`` (with a
        warning where it is smaller), generic forces inside its slot loop;
        at ``rebuild_every`` 1 a generic force runs instead through
        :func:`heun_steps` on ``engine.pairwise`` (the same step: the
        lattice engine's ``pairwise`` rebuilds per pass too).  Any other
        engine runs :func:`heun_steps`.  ``gen_forces`` is a
        ``GenericForce`` or a plain ``fn(X, n)``.  On the card, at a
        build before every pass with no generic force, the glue after
        each build (the pass, the derivative, the Heun update and the
        folds) replays as a CUDA graph (:func:`lattice_segment_key`),
        two a step, the builds still eager calls.  Traced, the call is
        the span ``integrator.take_steps``."""
        self._ensure_device()
        e = self.engine
        gen = _as_generic(gen_forces)
        n_steps = int(n_steps)
        if isinstance(e, LatticeEngine) and (gen is None
                                             or e.rebuild_every != 1):
            k = e.rebuild_every
            if n_steps % k:
                # the closest cadence the loop can run (n_steps % k == 0):
                # falling to 1 would run per-pass rebuilds while the
                # engine says otherwise
                k = max(d for d in range(1, e.rebuild_every + 1)
                        if n_steps % d == 0)
                # stacklevel 3: the caller, past the span's wrapper
                warnings.warn(
                    f"take_steps(n_steps={n_steps}) is not a multiple of "
                    f"rebuild_every={e.rebuild_every}; rebuilding every "
                    f"{k} steps for this call", stacklevel=3)
            key = lattice_segment_key(
                e, k, pw_int, pw_friction, self._fix_mode, self.d_X, dt,
                self.cube_size, self._fix_point, precompute, gen)
            self.d_X, self.d_old_v, self.aux = lattice_heun_steps(
                n_steps, k, pw_int, pw_friction, self._fix_mode,
                e.grid_size, e.capacity, e.z_block, self.d_X,
                self.d_old_v, self.d_n, dt, self.cube_size,
                self._fix_point, precompute, e.pallas, gen,
                gen.args if gen is not None else None, e.force_r_max,
                e.extras_cap, e.extras_block_cap, 0, False,
                e.route_movers, e.x_split, _segments(key))
        else:
            self._heun_steps(n_steps, dt, pw_int, pw_friction, gen,
                             precompute)
        if check_errors:
            self._check_errors()
        return self.aux

    # -- diagnostics ----------------------------------------------------------
    def validate(self):
        """Runtime sanity checks: NaN/inf in state, count within capacity,
        and engine capacity overflow (ref cudebug.cuh:8-14; NaN guards at
        solvers.cuh:153-154).  Returns a dict of findings; empty means
        healthy."""
        self._ensure_device()
        problems = {}
        n = self.get_d_n()
        if n > self.n_max:
            problems["over_capacity"] = n
        bad = {f: int((~torch.isfinite(a[:n])).sum())
               for f, a in zip(self.pt_type._fields, self.d_X)}
        bad = {f: c for f, c in bad.items() if c}
        if bad:
            problems["non_finite"] = bad
        if self.check_grid_capacity():
            problems["grid_capacity_overflow"] = True
        gs = getattr(self.engine, "grid_size", None)
        if gs is not None:
            # Out-of-grid points are clipped into edge cubes by every binned
            # engine (the reference D_ASSERTs instead, solvers.cuh:361-364);
            # flag them so mis-binned states are detected
            if bool(out_of_grid_mask(self.d_X, n, self.cube_size, gs).any()):
                problems["out_of_grid"] = True
        if isinstance(self.engine, LatticeEngine):
            lay = lattice_build(self.d_X, self.d_old_v, n, self.cube_size,
                                self.engine.grid_size, self.engine.capacity,
                                x_split=self.engine.x_split)
            dropped = int(lay.n_dropped)
            if dropped:
                problems["lattice_capacity_dropped"] = dropped
        return problems

    def check_grid_capacity(self):
        """True if the current state overflows the grid engine's
        ``row_cap`` (the reference's capacity D_ASSERTs); False for the
        other engines."""
        self._ensure_device()
        if not isinstance(self.engine, (GridEngine, GabrielEngine)):
            return False
        gs = self.engine.grid_size
        return bool(grid_overflow(build_grid(self.d_X, self.d_n,
                                             self.cube_size, gs),
                                  gs, self.engine.row_cap))

    def _check_errors(self):
        """Raise ``SimulationError`` if any in-loop failure flag of the
        last call is set (ref in-kernel D_ASSERTs, solvers.cuh:82,90,
        153-154).  One host readback per call, the span
        ``integrator.readback``."""
        keys = [k for k in self.aux if k.startswith(ERR_PREFIX)]
        if not keys:
            return
        vals = torch.stack([self.aux[k].float().max() for k in keys])
        with span("integrator.readback"):
            vals = vals.cpu().tolist()
        problems = [f"{k[len(ERR_PREFIX):]} ({v:g})"
                    for k, v in zip(keys, vals) if v]
        if problems:
            raise SimulationError(
                "in-loop failure detected: " + ", ".join(problems)
                + " -- raise engine capacity (grid row_cap / "
                "max_candidates / lattice capacity / extras_cap / "
                "extras_block_cap) or check the forces for NaN")
