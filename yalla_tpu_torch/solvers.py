"""Heun integrator, engines and the ``Solution`` facade (subset).

Counterpart of ``yalla_tpu/solvers.py``.  The equation of motion is
v = F + <v(t - dt)> for x, y, z, where <v> is the friction-weighted mean
neighbour velocity (ref solvers.cuh:109-161), and dw/dt = F_w for every
other field.  PyTorch runs eagerly, so a step is a plain function and a
run of steps a Python loop; point counts are Python ints.

Ported so far: the all-pairs ``TileEngine`` (the brute-force oracle, plain
torch) and the ``LatticeEngine`` per-pass path, which ``take_steps``
routes to ``ops.lattice_xla.lattice_heun_steps``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .dtypes import Float3, make_pt
from .ops.common import (ERR_PREFIX, apply_derived_aux, apply_post_pair,
                         friction_w_neighbour, grid_dims, mask_tree)
from .ops.pairwise_xla import tile_pairwise

__all__ = ["TileEngine", "LatticeEngine", "Solution", "SimulationError",
           "heun_step", "friction_w_neighbour"]


class SimulationError(RuntimeError):
    """A failure detected inside the hot loop: engine capacity overflow
    (silent pair/cell loss) or non-finite state
    (ref cudebug.cuh:8-35, solvers.cuh:82, 90, 153-154)."""


@dataclass(frozen=True)
class TileEngine:
    """All-pairs O(N^2) (ref Tile_computer, solvers.cuh:324-342)."""

    def pairwise(self, pw_int, pw_friction, X, old_v, n, cube_size):
        del cube_size  # no cutoff in the all-pairs engine
        return tile_pairwise(pw_int, pw_friction, X, old_v, n)


@dataclass(frozen=True)
class LatticeEngine:
    """Dense cube-lattice engine (see ops/lattice_xla.py).

    The pair pass and the pour run through their kernel wrappers
    (``ops/lattice_pallas.py``, ``ops/lattice_pour.py``): the hand-written
    CUDA kernels for tensors on the GPU, their plain torch versions for
    tensors on the CPU.  ``pallas`` keeps the JAX engine's name for that
    path and must stay True (the JAX package's XLA path has no separate
    port).  Only the per-pass rebuild cadence (``rebuild_every=1``) is
    ported; the integrator refuses the rest.  ``z_block`` is the JAX
    kernel's z-block height, which sets the blocks of
    ``__err_extras_block``."""
    grid_size: int | tuple = 64
    capacity: int = 8
    z_block: int = 4
    rebuild_every: int = 1
    pallas: bool = True
    extras_cap: int = 0
    extras_block_cap: int = 16

    def __post_init__(self):
        # z_block must divide the grid's z extent (the JAX kernel's blocks)
        gz = grid_dims(self.grid_size)[2]
        zb = min(self.z_block, gz)
        while gz % zb:
            zb -= 1
        object.__setattr__(self, "z_block", max(zb, 1))


# --------------------------------------------------------------------------
# Heun predictor-corrector (ref Heun_solver::take_step, solvers.cuh:226-275)
# --------------------------------------------------------------------------

def _fix_components(dX, n, active, fix_mode, fix_point):
    """Momentum fix: COM drift (default), pinned point, or xy-point/z-COM
    (ref solvers.cuh:196-208, 240-253).  Only x, y, z are ever fixed."""
    def com(a):
        return torch.where(active, a, 0.0).sum() / n
    if fix_mode == "com":
        return com(dX.x), com(dX.y), com(dX.z)
    if fix_mode == "point":
        return dX.x[fix_point], dX.y[fix_point], dX.z[fix_point]
    if fix_mode == "com_z":
        return dX.x[fix_point], dX.y[fix_point], com(dX.z)
    raise ValueError(fix_mode)


def augment(X, n, precompute):
    """Append derived per-point fields (e.g. polarity vectors) for the
    duration of one pairwise pass; they flow through Xi / Xj / r."""
    if precompute is None:
        return X
    aug = precompute(X, n)
    AugT = make_pt(type(X).__name__ + "Aug",
                   *(list(type(X)._fields[3:]) + list(aug.keys())))
    return AugT(*X, *aug.values())


def truncate_aug(F, orig_type):
    if type(F).__name__ == orig_type.__name__:
        return F
    return orig_type(*tuple(F)[:len(orig_type._fields)])


def nonfinite(pt):
    """0-d bool tensor: any non-finite value in any field."""
    return torch.stack([~torch.isfinite(a).all() for a in pt]).any()


def add_rhs(F, sum_f, sum_v):
    """Add the friction-weighted mean neighbour velocity to F's x, y, z
    (ref add_rhs, solvers.cuh:146-161); no friction, no term."""
    inv = torch.where(sum_f > 0, 1.0 / torch.where(sum_f > 0, sum_f, 1.0),
                      0.0)
    return F.replace(x=F.x + sum_v[0] * inv, y=F.y + sum_v[1] * inv,
                     z=F.z + sum_v[2] * inv)


def _deriv(engine, pw_int, pw_friction, fix_mode, precompute,
           X, old_v, n, cube_size, fix_point):
    active = torch.arange(X.x.shape[0], device=X.x.device) < n
    Xa = augment(X, n, precompute)
    F, sum_f, sum_v, aux = engine.pairwise(
        pw_int, pw_friction, Xa, old_v, n, cube_size)
    aux = apply_derived_aux(pw_int, aux, sum_f)
    F, aux = apply_post_pair(pw_int, F, aux, Xa)
    aux = {k: (v.max() if k.startswith(ERR_PREFIX) else v)
           for k, v in aux.items()}
    dX = mask_tree(add_rhs(truncate_aug(F, type(X)), sum_f, sum_v), active)
    fx, fy, fz = _fix_components(dX, n, active, fix_mode, fix_point)
    dX = dX.replace(x=torch.where(active, dX.x - fx, 0.0),
                    y=torch.where(active, dX.y - fy, 0.0),
                    z=torch.where(active, dX.z - fz, 0.0))
    aux["__err_non_finite"] = nonfinite(dX).to(torch.float32)
    return dX, aux


def heun_step(engine, pw_int, pw_friction, fix_mode, X, old_v, n, dt,
              cube_size, fix_point=0, precompute=None):
    """One 2nd-order step: ``(X, old_v) -> (X', old_v', aux)``."""
    def d(Xc):
        return _deriv(engine, pw_int, pw_friction, fix_mode, precompute,
                      Xc, old_v, n, cube_size, fix_point)
    dX, aux1 = d(X)
    X1 = X + dX * dt
    dX1, aux = d(X1)
    # failure flags must survive from BOTH passes
    for k in aux:
        if k.startswith(ERR_PREFIX):
            aux[k] = torch.maximum(aux[k], aux1[k])
    X_new = X + (dX + dX1) * (0.5 * dt)
    old_v_new = Float3(x=(dX.x + dX1.x) * 0.5,
                       y=(dX.y + dX1.y) * 0.5,
                       z=(dX.z + dX1.z) * 0.5)
    return X_new, old_v_new, aux


# --------------------------------------------------------------------------
# Solution facade (ref Solution<Pt, Solver>, solvers.cuh:60-106)
# --------------------------------------------------------------------------

def _pad_size(n_max):
    if n_max <= 4096:
        return max(128, -(-n_max // 128) * 128)
    return -(-n_max // 4096) * 4096


class Solution:
    """Host facade owning padded device state + a host mirror.

    ``h_X`` is a Pt of numpy arrays (mutable in place); ``copy_to_device``
    / ``copy_to_host`` move it to and from ``device``.  A CUDA device is
    used only if it exists: asking for one without a GPU raises."""

    def __init__(self, pt_type, n_max, *, engine=None, cube_size=1.0,
                 device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Solution(device={device!r}): no CUDA device is available")
        self.pt_type = pt_type
        self.n_max = int(n_max)
        self.n_pad = _pad_size(self.n_max)
        self.engine = engine if engine is not None else TileEngine()
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
        self.d_X = self.pt_type(*[
            torch.as_tensor(np.asarray(f, np.float32), device=self.device)
            for f in self.h_X])
        self.d_n = int(self.h_n)

    def copy_to_host(self):
        assert self.d_X is not None
        self.h_X = self.pt_type(*[f.cpu().numpy().copy() for f in self.d_X])
        self.h_n = self.d_n
        return self.h_X

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
    def take_steps(self, n_steps, dt, pw_int, *,
                   pw_friction=friction_w_neighbour, precompute=None,
                   check_errors=True):
        """``n_steps`` Heun steps.  With a LatticeEngine this runs the
        lattice integrator (per-pass rebuild); with a TileEngine, a loop
        of all-pairs steps."""
        if self.d_X is None:
            self.copy_to_device()
        e = self.engine
        if isinstance(e, LatticeEngine):
            from .ops.lattice_xla import lattice_heun_steps
            self.d_X, self.d_old_v, self.aux = lattice_heun_steps(
                int(n_steps), e.rebuild_every, pw_int, pw_friction,
                self._fix_mode, e.grid_size, e.capacity, e.z_block,
                self.d_X, self.d_old_v, self.d_n, dt, self.cube_size,
                self._fix_point, precompute, e.pallas, None, None, None,
                e.extras_cap, e.extras_block_cap)
        else:
            X, old_v, errs = self.d_X, self.d_old_v, {}
            for _ in range(int(n_steps)):
                X, old_v, aux = heun_step(
                    e, pw_int, pw_friction, self._fix_mode, X, old_v,
                    self.d_n, dt, self.cube_size, self._fix_point,
                    precompute)
                for k, v in aux.items():
                    if k.startswith(ERR_PREFIX):
                        errs[k] = torch.maximum(errs[k], v) \
                            if k in errs else v
            self.d_X, self.d_old_v = X, old_v
            self.aux = {**aux, **errs} if n_steps else {}
        if check_errors:
            self._check_errors()
        return self.aux

    def _check_errors(self):
        """Raise ``SimulationError`` if any in-loop failure flag of the
        last call is set (ref in-kernel D_ASSERTs, solvers.cuh:82,90,
        153-154).  One host readback per call."""
        keys = [k for k in self.aux if k.startswith(ERR_PREFIX)]
        if not keys:
            return
        vals = torch.stack([self.aux[k].float().max() for k in keys]) \
            .cpu().tolist()
        problems = [f"{k[len(ERR_PREFIX):]} ({v:g})"
                    for k, v in zip(keys, vals) if v]
        if problems:
            raise SimulationError(
                "in-loop failure detected: " + ", ".join(problems)
                + " -- raise engine capacity (lattice capacity / "
                "extras_cap / extras_block_cap) or check the forces for "
                "NaN")
