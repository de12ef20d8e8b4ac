"""Carry states, parameters and engine settings across from the JAX package.

Everything here goes through numpy, so the port never imports JAX: a JAX
``Cell``/``Float3`` state converts with ``np.asarray`` field by field, and a
settled benchmark state comes from its ``.bench_cache/*.npz`` file.  The
same numbers therefore go into both packages.  Like every entry point of
the port, each function here puts its tensors on the card unless the
caller asks for the CPU (``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .dtypes import Float3, device_of, make_pt
from .growth import Lineage
from .links import Links
from .solvers import (GabrielEngine, GridEngine, LatticeEngine, Solution,
                      TileEngine)

__all__ = ["pt_from_numpy", "pt_to_numpy", "load_settled", "params_from",
           "bench_config", "bench_engine", "engine_from", "links_from",
           "lineage_from", "state_from", "solution_from", "BENCH_EXTRAS_CAP"]

# the benchmark's static overflow-extras list size (bench.py, E_CAP)
BENCH_EXTRAS_CAP = 2048
# the benchmark's lattice z-slab height (bench.py, ``zb``)
BENCH_Z_BLOCK = 2


def pt_from_numpy(pt_type, fields, device="cuda"):
    """A Pt of f32 tensors on ``device`` from a mapping (or a NamedTuple,
    e.g. a JAX Pt) of per-field arrays."""
    device = device_of(device, "pt_from_numpy")
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return pt_type(*[torch.as_tensor(np.array(fields[f], np.float32),
                                     device=device)
                     for f in pt_type._fields])


def pt_to_numpy(pt):
    """``{field: np.ndarray}`` of a Pt of tensors."""
    return {f: a.detach().cpu().numpy() for f, a in zip(pt._fields, pt)}


def load_settled(path, pt_type, device="cuda"):
    """(X, old_v) from a settled-state ``.npz`` of the benchmark cache
    (fields ``X_<name>`` per Cell field and ``V_x/V_y/V_z``)."""
    device = device_of(device, "load_settled")
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
    them, the kernel path, the rebuild cadence and the thin x-cubes
    (``x_split``) where the entry has them.  A slot-space rebin cadence
    (``rebin``) is an argument of ``lattice_heun_steps``, not of the
    engine, and is refused here."""
    tile = {"tile_central_mxu": TileEngine(mxu=True),
            "tile_pallas": TileEngine(pallas=True)}
    if cfg.get("engine") in tile:
        return tile[cfg["engine"]]
    if cfg.get("rebin"):
        raise ValueError(f"unsupported benchmark cadence: {cfg}")
    e_b = int(cfg["extras_block_cap"])
    return LatticeEngine(
        grid_size=tuple(cfg["gs"]), capacity=int(cfg["C"]),
        z_block=BENCH_Z_BLOCK, rebuild_every=int(cfg["rebuild_every"]),
        pallas=True, extras_cap=BENCH_EXTRAS_CAP if e_b else 0,
        extras_block_cap=max(e_b, 8), x_split=int(cfg.get("x_split", 1)))


def engine_from(engine):
    """The port's ``TileEngine`` / ``GridEngine`` / ``GabrielEngine`` /
    ``LatticeEngine`` with the settings of a JAX engine of the same name
    (a frozen dataclass).  The Gabriel engine's windowed form and its
    window settings (``window_cap``, ``salvage_cap``, ``subgroup``) carry
    across; a setting the port has no counterpart for (the TPU kernel's
    ``y_block``) is left behind.  A JAX ``LatticeEngine(pallas=False)``
    ignores its ``extras_cap``; it maps to the port's engine with
    ``pallas=True, extras_cap=0``, which computes the same function.
    Every other lattice setting (``x_split``, ``route_movers``,
    ``force_r_max``, the cadence) carries across."""
    port = {"TileEngine": TileEngine, "GridEngine": GridEngine,
            "GabrielEngine": GabrielEngine, "LatticeEngine": LatticeEngine}
    name = type(engine).__name__
    if name not in port:
        raise ValueError(f"engine_from: no port of {name}")
    keep = {f.name for f in dataclasses.fields(port[name])}
    settings = dataclasses.asdict(engine)
    if name == "LatticeEngine":
        if not settings["pallas"]:
            settings.update(pallas=True, extras_cap=0)
    return port[name](**{k: v for k, v in settings.items() if k in keep})


def links_from(links, device="cuda", seed=0):
    """The port's ``Links`` holding a JAX ``Links``' table (``d_a``,
    ``d_b``, ``d_n``, ``strength``), on ``device``.  The port's generator
    is seeded from ``seed``: the JAX key stream does not carry across."""
    out = Links(links.n_max, float(links.strength), seed=seed, device=device)
    out.h_a = np.asarray(links.d_a).astype(np.int32)
    out.h_b = np.asarray(links.d_b).astype(np.int32)
    out.h_n = int(links.d_n)
    out.copy_to_device()
    return out


def lineage_from(lineage, device="cuda"):
    """The port's ``growth.Lineage`` from a JAX one (its leaves as arrays):
    the node and cell tables on ``device``, the node count an int."""
    device = device_of(device, "lineage_from")
    d = lineage._asdict()
    return Lineage(n_nodes=int(d.pop("n_nodes")), **{
        k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()})


def state_from(state, device="cuda", seed=0):
    """The port's ``models.branching.State`` from a JAX one (its leaves as
    arrays), on ``device``, so both packages compute on the same state.
    The port's generator is seeded from ``seed``: the JAX key does not
    carry across."""
    from .models import branching as B
    device = device_of(device, "state_from")
    key = torch.Generator(device=device)
    key.manual_seed(int(seed))

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return B.State(
        X=pt_from_numpy(B.Cell, state.X, device),
        old_v=pt_from_numpy(Float3, state.old_v, device),
        n=int(state.n), lineage=lineage_from(state.lineage, device),
        epi_nbs=f32(state.epi_nbs), mes_nbs=f32(state.mes_nbs), key=key)


def solution_from(solution, engine=None, device="cuda"):
    """The port's ``Solution`` holding a JAX ``Solution``'s state, on
    ``device``: the point type of the same name and fields, ``n_max``,
    ``n_pad``, ``cube_size``, the fixing mode, the device state (the host
    mirror where none was copied to the device) with its active count,
    and ``d_old_v``.  The engine is ``engine``, else the JAX engine's
    counterpart (``engine_from``); a JAX Solution that has not picked its
    engine yet leaves the port's to pick at first use."""
    jx = solution.d_X if solution.d_X is not None else solution.h_X
    n = int(solution.d_n) if solution.d_X is not None else solution.h_n
    pt_type = make_pt(solution.pt_type.__name__,
                      *solution.pt_type._fields[3:])
    if engine is None and solution.engine is not None:
        engine = engine_from(solution.engine)
    out = Solution(pt_type, solution.n_max, solver="auto", engine=engine,
                   cube_size=solution.cube_size, device=device,
                   n_pad=solution.n_pad)
    out.h_X = pt_type(*[np.array(a, np.float32) for a in jx])
    out.h_n = n
    out.copy_to_device()
    out.d_old_v = pt_from_numpy(Float3, solution.d_old_v, out.device)
    out._fix_mode, out._fix_point = solution._fix_mode, solution._fix_point
    return out
