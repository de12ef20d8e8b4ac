"""The multi-device dry run, and the runs a rank makes of each sharded path.

``dryrun_multichip(n_devices, device="cuda")`` is the port's counterpart of
``__graft_entry__.dryrun_multichip``: it spawns ``n_devices`` ranks
(``_comm.spawn``) and runs on tiny shapes

1. the cells-axis Heun step (``spmd.make_sharded_step`` on a
   ``GridEngine``, the branching force with ``polarity_precompute3``, 2
   steps), then a division pass (``growth.proliferate``) on the gathered
   state; every rank draws from the same seeded ``torch.Generator``, so
   the state stays the same on every rank;
2. two fused frames, each a division pass and
   ``lattice_sharded_heun_steps(pallas=True)`` (K1 with ``z_halo`` on the
   card, its plain version on the CPU) at grid 16, C 8, then a third with
   ``pallas=False`` (JAX's default, which runs the same pass: K1 on the
   card too);

and asserts what the JAX function asserts, and on the card that every
frame launched K1 twice a step.  Rank 0 prints its two lines.

``run_cells``, ``run_slab`` and ``run_engine`` run the three sharded paths
on a state given as numpy, for the tests and for ``chip_smoke.py``: a rank
imports them from the package, never from the caller's module.  A force
is named (``FORCES``), because a closure cannot be sent to a rank.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..dtypes import Float3
from ..ops.common import friction_w_neighbour
from ..utils import profiling
from ._comm import spawn
from .lattice_spmd import ShardedLatticeEngine, lattice_sharded_heun_steps
from .spmd import gather_pt, make_sharded_step, shard_state

__all__ = ["dryrun_multichip", "run_cells", "run_slab", "run_engine",
           "clipped_spring", "FORCES"]


def clipped_spring(Xi, r, dist, i, j):
    """A spring of rest length 0.5 inside distance 1 (the force of the JAX
    package's ``tests/test_parallel.py``)."""
    valid = (i != j) & (dist < 1.0)
    safe = torch.where(dist > 0, dist, 1.0)
    w = torch.where(valid, (0.5 - dist) / safe, 0.0)
    return Float3(x=r.x * w, y=r.y * w, z=r.z * w)


def _branching():
    from ..models import branching as B
    from ..polarity import polarity_precompute3
    return B.Cell, B.make_force(B.Params()), polarity_precompute3


def _relu():
    from ..inits import relu_force
    return Float3, relu_force, None


def _sorting():
    from ..models import sorting as S
    return S.Cell, S.make_adhesion(S.Params()), None


# name -> () -> (point type, force, precompute)
FORCES = {"clipped_spring": lambda: (Float3, clipped_spring, None),
          "relu": _relu, "branching": _branching, "sorting": _sorting}


def _state(mesh, force, X, old_v):
    """(point type, force, precompute, X, old_v) on the mesh's device from
    numpy fields (dicts of arrays)."""
    Cell, pw, pre = FORCES[force]()
    dev = mesh.device
    Xt = Cell(*(torch.as_tensor(np.asarray(X[f], np.float32), device=dev)
                for f in Cell._fields))
    ovt = Float3(*(torch.as_tensor(np.asarray(old_v[f], np.float32),
                                   device=dev) for f in "xyz"))
    return pw, pre, Xt, ovt


def _links(links, device):
    """``(gen, gen_args)`` of a link table ``(a, b, strength)``."""
    if links is None:
        return None, None
    from ..links import Links, link_forces
    a, b, strength = links
    lk = Links(len(a), strength=strength, seed=0, device=device)
    lk.h_a[:len(a)] = a
    lk.h_b[:len(b)] = b
    lk.copy_to_device()
    gen = link_forces(lk)
    return gen, gen.args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tally():
    """This rank's collectives (seconds, calls, bytes) and K1 launches
    recorded so far (``utils.profiling``)."""
    c = profiling.counters()
    seconds = sum(total for name, (_, total, _) in profiling.spans().items()
                  if name.startswith("comm."))
    return (seconds, c.get("comm.calls", 0), c.get("comm.bytes", 0),
            c.get("kernels.lattice_pair", 0))


def _timed(mesh, fn, warmup=False):
    """``fn()`` and its wall seconds, the device synchronised around it,
    with this rank's transport seconds and kernel launches during it
    (traced); with ``warmup``, after one untimed call (``fn`` must not
    change its inputs)."""
    if warmup:
        fn()
    _sync(mesh.device)
    with profiling.tracing():
        before = _tally()
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh.device)
        seconds = time.perf_counter() - t0
        after = _tally()
    d = [b - a for a, b in zip(before, after)]
    return out, {"seconds": seconds, "transport_seconds": d[0],
                 "transport_calls": d[1], "transport_bytes": d[2],
                 "lattice_pair_launches": d[3],
                 "transport": mesh.transport}


def _flags(aux):
    return {k: float(v.float().max()) for k, v in aux.items()
            if k.startswith("__err_")}


def run_cells(mesh, engine, force, X, old_v, n, dt, cube_size, n_steps,
              fix_mode="com", fix_point=0, warmup=False):
    """``n_steps`` of ``make_sharded_step`` on this rank's rows of the
    numpy state; returns the gathered positions and fields (``X``), the
    flags, and :func:`_timed`'s measures (``warmup``: after one untimed
    run from the same state)."""
    pw, pre, Xt, ovt = _state(mesh, force, X, old_v)
    Xs, ovs = shard_state(mesh, Xt, ovt)
    step = make_sharded_step(mesh, engine, pw, fix_mode=fix_mode,
                             n_steps=n_steps, precompute=pre)
    (Xs, ovs, errs), info = _timed(
        mesh, lambda: step(Xs, ovs, n, dt, cube_size, fix_point), warmup)
    return {"X": gather_pt(mesh, Xs), "old_v": gather_pt(mesh, ovs),
            "flags": _flags(errs), **info}


def run_slab(mesh, force, X, old_v, n, dt, cube_size, grid_size, capacity,
             z_block, n_steps, rebuild_every, pallas, links=None,
             fix_mode="com", fix_point=0, warmup=False):
    """``lattice_sharded_heun_steps`` on the numpy state (every rank
    holds all of it); ``links``: ``(a, b, strength)`` of a link table run
    as the generic force inside the chunks; ``warmup`` as
    :func:`run_cells`'."""
    pw, pre, Xt, ovt = _state(mesh, force, X, old_v)
    gen, gen_args = _links(links, mesh.device)
    (Xo, ovo, aux), info = _timed(mesh, lambda: lattice_sharded_heun_steps(
        mesh, n_steps, rebuild_every, pw, friction_w_neighbour, fix_mode,
        grid_size, capacity, z_block, Xt, ovt, n, dt, cube_size, fix_point,
        pre, pallas=pallas, gen=gen, gen_args=gen_args), warmup)
    return {"X": Xo, "old_v": ovo, "flags": _flags(aux), **info}


def run_engine(mesh, force, X, old_v, n, dt, cube_size, grid_size,
               capacity, z_block, n_steps, pallas=None, links=None):
    """``heun_steps`` on a ``ShardedLatticeEngine`` (a build per pass) on
    the numpy state, with the links' forces as the generic force."""
    from ..solvers import heun_steps
    pw, pre, Xt, ovt = _state(mesh, force, X, old_v)
    gen, gen_args = _links(links, mesh.device)
    eng = ShardedLatticeEngine(mesh, grid_size, capacity, z_block, pallas)
    (Xo, ovo, aux), info = _timed(mesh, lambda: heun_steps(
        n_steps, eng, pw, friction_w_neighbour, "com", Xt, ovt, n, dt,
        cube_size, 0, pre, gen, gen_args))
    return {"X": Xo, "old_v": ovo, "flags": _flags(aux), **info}


def tiny_branching_state(n_pad=256, n_active=100, seed=0, device="cpu"):
    """A synthetic flagship state (``__graft_entry__._tiny_branching_state``
    from the same numpy draws): a ball of radius 3, epithelium outside
    radius 2, with its lineage, counters and a generator seeded with
    ``seed``."""
    from ..growth import lineage_init
    from ..models import branching as B
    rng = np.random.default_rng(seed)
    r = 3.0 * rng.random(n_pad) ** (1 / 3)
    theta = np.arccos(2 * rng.random(n_pad) - 1)
    phi = rng.random(n_pad) * 2 * np.pi
    f = {"x": r * np.sin(theta) * np.cos(phi),
         "y": r * np.sin(theta) * np.sin(phi), "z": r * np.cos(theta),
         "theta": theta, "phi": phi, "u": rng.random(n_pad) * 0.1,
         "v": rng.random(n_pad) * 0.1, "ctype": (r > 2.0).astype(np.float32)}
    X = B.Cell(*(torch.as_tensor(np.asarray(f[k], np.float32),
                                 device=device) for k in B.Cell._fields))
    zeros = torch.zeros(n_pad, device=device)
    return B.State(X=X, old_v=Float3.zeros(n_pad, device=device),
                   n=n_active,
                   lineage=lineage_init(2 * n_pad, n_pad, n_active, device),
                   epi_nbs=zeros, mes_nbs=zeros.clone(),
                   key=torch.Generator(device=device).manual_seed(seed))


def _dryrun_rank(mesh):
    from ..growth import proliferate
    from ..models import branching as B
    from ..polarity import polarity_precompute3
    from ..solvers import GridEngine
    D, dev = mesh.size, mesh.device
    n_pad = 64 * D
    p = B.Params(prolif_threshold=-100.0)
    force = B.make_force(p)
    want, child = B.make_want_fn(p), B.make_child_fn(p)

    # the cells axis: each rank's rows, two steps, a division pass on the
    # gathered state
    state = tiny_branching_state(n_pad, n_pad // 2, 0, dev)
    X, old_v = shard_state(mesh, state.X, state.old_v)
    step = make_sharded_step(mesh, GridEngine(grid_size=16, row_cap=64,
                                              i_block=64),
                             force, n_steps=2, precompute=polarity_precompute3)
    X, old_v, errs = step(X, old_v, state.n, p.dt, p.r_max, 0)
    bad = {k: float(v) for k, v in errs.items() if float(v)}
    assert not bad, bad
    X, old_v = gather_pt(mesh, X), gather_pt(mesh, old_v)
    nbs = torch.zeros(n_pad, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    X, old_v, n, _, _ = proliferate(want, child, X, old_v, state.n, g,
                                    props=(nbs, nbs))
    assert n >= n_pad // 2, "dry run lost cells"
    lines = [f"dryrun_multichip: cells-axis step OK on {D} devices "
             f"(n={n}, n_pad={n_pad})"]

    # the z-slab lattice: frames of a division pass and two resident steps
    # on the ring, K1 with z_halo; the third frame with pallas=False, which
    # selects nothing on the slab path
    gs, C = 16, 8
    gz = gs // D
    assert gz >= 1, f"grid_size {gs} too small for {D} devices"
    zb = min(2, gz)
    state = tiny_branching_state(n_pad, n_pad // 2, 3, dev)
    X, old_v, n = state.X, state.old_v, state.n
    props = (state.epi_nbs, state.mes_nbs)
    g = torch.Generator(device=dev).manual_seed(4)
    drops = []
    for pallas in (True, True, False):
        X, old_v, n, props, _ = proliferate(want, child, X, old_v, n, g,
                                            props=props)
        with profiling.tracing():
            launches = _tally()[3]
            X, old_v, aux = lattice_sharded_heun_steps(
                mesh, 2, 2, force, friction_w_neighbour, "com", gs, C, zb,
                X, old_v, n, p.dt, p.r_max, 0, polarity_precompute3,
                pallas=pallas)
            launches = _tally()[3] - launches
        if dev.type == "cuda":
            assert launches == 4, \
                f"a pallas={pallas} z-slab frame did not run the lattice " \
                f"pair kernel twice a step"
        props = (aux["epi_nbs"], aux["mes_nbs"])
        drops.append(int(aux["__err_lattice_dropped"]))
    assert n >= n_pad // 2, "z-slab dry run lost cells"
    assert max(drops) == 0, "lattice capacity overflow"
    lines.append(f"dryrun_multichip: OK on {D} devices (z-slab lattice + "
                 f"in-scan proliferation, n={n}, n_pad={n_pad})")
    if mesh.rank == 0:
        print("\n".join(lines), flush=True)
    return {"n_cells": n, "n_pad": n_pad, "transport": mesh.transport}


def dryrun_multichip(n_devices, device="cuda"):
    """One step of both sharded paths on tiny shapes over ``n_devices``
    ranks (processes under gloo, the ranks sharing ``device``), then the
    division passes, as ``__graft_entry__.dryrun_multichip`` does; returns
    rank 0's summary."""
    return spawn(_dryrun_rank, n_devices, backend="gloo", device=device)
