"""Carry states, parameters and engine settings across from the JAX package.

Everything here goes through numpy, so the port never imports JAX: a JAX
``Cell``/``Float3`` state converts with ``np.asarray`` field by field, and a
settled benchmark state comes from its ``.bench_cache/*.npz`` file.  The
same numbers therefore go into both packages.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import Float3
from .solvers import LatticeEngine, TileEngine

__all__ = ["pt_from_numpy", "pt_to_numpy", "load_settled", "params_from",
           "bench_config", "bench_engine", "BENCH_EXTRAS_CAP"]

# the benchmark's static overflow-extras list size (bench.py, E_CAP)
BENCH_EXTRAS_CAP = 2048
# the benchmark's lattice z-slab height (bench.py, ``zb``)
BENCH_Z_BLOCK = 2


def pt_from_numpy(pt_type, fields, device="cpu"):
    """A Pt of f32 tensors on ``device`` from a mapping (or a NamedTuple,
    e.g. a JAX Pt) of per-field arrays."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return pt_type(*[torch.as_tensor(np.array(fields[f], np.float32),
                                     device=device)
                     for f in pt_type._fields])


def pt_to_numpy(pt):
    """``{field: np.ndarray}`` of a Pt of tensors."""
    return {f: a.detach().cpu().numpy() for f, a in zip(pt._fields, pt)}


def load_settled(path, pt_type, device="cpu"):
    """(X, old_v) from a settled-state ``.npz`` of the benchmark cache
    (fields ``X_<name>`` per Cell field and ``V_x/V_y/V_z``)."""
    with np.load(path) as d:
        if list(d["__cell_fields"]) != list(pt_type._fields):
            raise ValueError(f"{path}: fields {list(d['__cell_fields'])} "
                             f"do not match {pt_type._fields}")
        X = pt_from_numpy(pt_type, {f: d["X_" + f] for f in pt_type._fields},
                          device)
        old_v = pt_from_numpy(Float3, {f: d["V_" + f] for f in "xyz"},
                              device)
    return X, old_v


def params_from(params_type, source):
    """A port parameter NamedTuple from a JAX one (or a dict) with the same
    field names."""
    if hasattr(source, "_asdict"):
        source = source._asdict()
    return params_type(**{k: source[k] for k in params_type._fields})


def bench_config(path, key):
    """The certified engine settings ``cfg`` of one ``bench_state.json``
    entry (e.g. ``branching_500000``)."""
    with open(path) as f:
        return json.load(f)[key]["cfg"]


def bench_engine(cfg):
    """The engine the benchmark runs for ``cfg``.  The all-pairs engines
    (``"tile_central_mxu"``, ``"tile_pallas"``) are the TileEngine on its
    central or tile kernel; the caller gives ``Solution`` the benchmark's
    row count, ``cfg["n_pad"]``.  Otherwise a LatticeEngine: its grid,
    capacity and cube size, overflow extras sized as the benchmark sizes
    them, the kernel path, and the per-pass rebuild cadence."""
    tile = {"tile_central_mxu": TileEngine(mxu=True),
            "tile_pallas": TileEngine(pallas=True)}
    if cfg.get("engine") in tile:
        return tile[cfg["engine"]]
    if cfg.get("rebin") or cfg.get("x_split", 1) != 1:
        raise ValueError(f"unsupported benchmark cadence: {cfg}")
    e_b = int(cfg["extras_block_cap"])
    return LatticeEngine(
        grid_size=tuple(cfg["gs"]), capacity=int(cfg["C"]),
        z_block=BENCH_Z_BLOCK, rebuild_every=int(cfg["rebuild_every"]),
        pallas=True, extras_cap=BENCH_EXTRAS_CAP if e_b else 0,
        extras_block_cap=max(e_b, 8))
