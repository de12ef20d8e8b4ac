#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``yalla_tpu_torch/csrc`` and drives
the port's main path once: the branching model's Heun step at 500k cells
on the dense cube lattice, rebuilt before every pass, at the settings
``bench.py`` certifies (``bench_state.json``, ``branching_500000``), from
the settled state in ``.bench_cache``.  Phases, each reported on its own
line:

1. the card's name and power limit, and the kernel build time;
2. the pour kernel (K2) against its plain version on the main path's
   500k build: bit-exact;
3. the lattice pair kernel (K1) against its plain version on one layout of
   that state: counters and flags exact, the other sums within
   ``|kernel - plain| <= RTOL * |plain| + ATOL * max(1, max|plain|)`` per
   channel (f32 rounding of FMA-contracted force arithmetic and a
   different summation order);
4. the slice on the settled 600-cell state (gs 32, C 4, 9 cells in the
   overflow extras), 2 steps on the GPU against the same steps through the
   plain versions on the CPU: every field within the reference's
   tolerance, atol 1e-6 + rtol 1e-2 (``tests/helpers.py`` ``isclose``);
5. the main path: ``Solution`` + ``LatticeEngine`` for ``N_STEPS`` steps,
   with every ``__err_*`` flag 0, a finite state, and both kernels
   launched 2 * N_STEPS times; its rate in cell-steps/s.

It then prints the kernels' JSON record and, last, the device record.
Any failure raises and exits non-zero.  Without a CUDA device it exits
non-zero at once and prints no result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCH_KEY = "branching_500000"
N_CELLS = 500_000
SETTLED = ROOT / ".bench_cache" / "settled_branching_500000_s0_v1.npz"
N_STEPS = 20
N_SMALL = 600
SETTLED_SMALL = ROOT / ".bench_cache" / "settled_branching_600_s0_v1.npz"
RTOL, ATOL = 1e-4, 1e-5


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the current stream, after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_sums(tag, kernel, plain, exact):
    """Max abs error over the named channels; raises past the tolerance
    (or on any difference in an ``exact`` channel)."""
    import torch
    worst = 0.0
    for name in kernel:
        k, p = kernel[name], plain[name]
        err = float((k - p).abs().max())
        worst = max(worst, err) if name not in exact else worst
        if name in exact:
            ok = torch.equal(k, p)
        else:
            scale = max(1.0, float(p.abs().max()))
            ok = bool(((k - p).abs() <= RTOL * p.abs() + ATOL * scale).all())
        if not ok:
            raise AssertionError(f"{tag} {name}: kernel and plain disagree "
                                 f"(max abs err {err:g})")
    return worst


def flatten(outs, prefix):
    F, sum_f, sum_v, aux = outs[:4]
    d = {f"{prefix}F.{f}": a for f, a in zip(F._fields, F)}
    d[f"{prefix}sum_f"] = sum_f
    d.update({f"{prefix}sum_v{c}": a for c, a in enumerate(sum_v)})
    d.update({f"{prefix}{k}": a.reshape(-1) for k, a in aux.items()})
    return d


def solution(path, n, engine, device, cube_size):
    """A ``Solution`` on ``device`` holding the settled state at ``path``."""
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models.branching import Cell
    from yalla_tpu_torch.solvers import Solution
    X, old_v = load_settled(path, Cell, device)
    sol = Solution(Cell, n, engine=engine, cube_size=cube_size,
                   device=device)
    assert sol.n_pad == X.x.shape[0], (sol.n_pad, X.x.shape)
    sol.h_X = Cell(*(a.cpu().numpy() for a in X))
    sol.h_n = n
    sol.copy_to_device()
    sol.d_old_v = old_v
    return sol


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this test needs one CUDA device")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from yalla_tpu_torch import _build
    from yalla_tpu_torch.interop import (bench_config, bench_engine,
                                         load_settled)
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                    lattice_pairwise_plain)
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas, pour_plain
    from yalla_tpu_torch.ops.lattice_xla import lattice_build, sort_by_cube
    from yalla_tpu_torch.solvers import LatticeEngine, augment

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s")

    # ---- the main path's configuration and state ------------------------
    cfg = bench_config(ROOT / "bench_state.json", BENCH_KEY)
    engine = bench_engine(cfg)
    p = B.Params()
    force = B.make_force(p)
    cube = float(cfg["cube"])
    gs, C = engine.grid_size, engine.capacity
    X, old_v = load_settled(SETTLED, B.Cell, dev)
    n_slots = gs[0] * gs[1] * gs[2] * C
    print(f"state: {N_CELLS} cells in {X.x.shape[0]} rows; grid {gs}, "
          f"C {C}, cube {cube}, extras_cap {engine.extras_cap}, "
          f"extras_block_cap {engine.extras_block_cap}")

    # ---- K2: pour kernel against its plain version -----------------------
    S = sort_by_cube(X, old_v, N_CELLS, cube, gs, C).S
    got = pour_pallas(S, n_slots)
    want = pour_plain(S, n_slots)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "live", "n_unrouted"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"pour {name}: kernel != plain")
    pour_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    pour_ms = cuda_ms(lambda: pour_pallas(S, n_slots), 20)
    pour_plain_ms = cuda_ms(lambda: pour_plain(S, n_slots), 20)
    print(f"K2 pour: bit-exact vs plain (out, live, n_unrouted); "
          f"{pour_ms:.4f} ms/call vs plain {pour_plain_ms:.4f} ms/call")

    # ---- K1: lattice pair kernel against its plain version ---------------
    lay = lattice_build(X, old_v, N_CELLS, cube, gs, C, engine.extras_cap)
    lay = lay._replace(T=augment(lay.T, N_CELLS, B.precompute),
                       E=augment(lay.E, N_CELLS, B.precompute))
    kw = dict(grid_size=gs, capacity=C, z_block=engine.z_block,
              extras_block_cap=engine.extras_block_cap)

    def k1():
        return lattice_pairwise_pallas(force, friction_w_neighbour, lay,
                                       N_CELLS, cube, **kw)

    def k1_plain():
        return lattice_pairwise_plain(force, friction_w_neighbour, lay,
                                      N_CELLS, cube, **kw)
    got, want = k1(), k1_plain()
    torch.cuda.synchronize()
    exact = {"sum_f", "epi_nbs", "E.sum_f", "E.epi_nbs",
             "E.__err_extras_block"}
    pair_err = max(
        compare_sums("K1 lattice", flatten(got, ""), flatten(want, ""),
                     exact),
        compare_sums("K1 extras", flatten(got[4], "E."),
                     flatten(want[4], "E."), exact))
    pair_ms = cuda_ms(k1, 10)
    pair_plain_ms = cuda_ms(k1_plain, 2)
    print(f"K1 lattice pair: {int(lay.n_extras)} live extras, counters and "
          f"flags exact, max abs err {pair_err:.3g} (rtol {RTOL}, atol "
          f"{ATOL} x max(1, max|plain|)); {pair_ms:.3f} ms/pass vs plain "
          f"{pair_plain_ms:.3f} ms/pass")
    del got, want, lay, X, old_v

    # ---- the slice on a small input, against the plain path on the CPU ---
    # (the CPU path is the one the tests hold against the JAX package)
    small = LatticeEngine(grid_size=32, capacity=4, z_block=2,
                          extras_cap=64, extras_block_cap=16)
    ends = {}
    for d in ("cpu", dev):
        s = solution(SETTLED_SMALL, N_SMALL, small, d, 1.0)
        s.take_steps(2, p.dt, force, precompute=B.precompute)
        ends[d] = s.copy_to_host()
    for f in B.Cell._fields:
        a, b = (getattr(ends[d], f)[:N_SMALL] for d in (dev, "cpu"))
        if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all():
            raise AssertionError(f"small slice field {f}: GPU and CPU "
                                 f"disagree (max abs err "
                                 f"{np.abs(a - b).max():g})")
    print(f"small slice: {N_SMALL} cells, 2 steps on the GPU within atol "
          f"1e-6 + rtol 1e-2 of the CPU plain path in every field")

    # ---- the slice: Solution + LatticeEngine at the main path's config ---
    sol = solution(SETTLED, N_CELLS, engine, dev, cube)
    sol.take_steps(1, p.dt, force, precompute=B.precompute)   # warm-up
    pour_pallas.launches = 0
    lattice_pairwise_pallas.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = sol.take_steps(N_STEPS, p.dt, force, precompute=B.precompute)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = {"pour": pour_pallas.launches,
                "lattice_pair": lattice_pairwise_pallas.launches}
    flags = {k: float(v.max()) for k, v in aux.items()
             if k.startswith("__err_")}
    if any(flags.values()):
        raise AssertionError(f"slice flags set: {flags}")
    X_end = sol.copy_to_host()
    for f, a in zip(X_end._fields, X_end):
        if a.shape != (sol.n_pad,) or not np.isfinite(a).all():
            raise AssertionError(f"slice state field {f} is not finite")
    for name, count in launches.items():
        if count != 2 * N_STEPS:
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{N_STEPS} steps, expected {2 * N_STEPS}")
    rate = N_CELLS * N_STEPS / dt_s
    print(f"slice: {N_STEPS} steps, flags {flags}, state finite, launches "
          f"{launches}; {dt_s * 1e3 / N_STEPS:.2f} ms/step, "
          f"{rate:.6g} cell-steps/s")

    kernels = [
        {"name": "pour", "route": "cuda",
         "source": "yalla_tpu_torch/csrc/pour.cu",
         "replaces": "yalla_tpu/ops/lattice_pour.py:244",
         "launches": launches["pour"], "max_abs_err": pour_err,
         "ms": pour_ms, "plain_ms": pour_plain_ms},
        {"name": "lattice_pair", "route": "cuda",
         "source": "yalla_tpu_torch/csrc/lattice_pair.cu",
         "replaces": "yalla_tpu/ops/lattice_pallas.py:672",
         "launches": launches["lattice_pair"], "max_abs_err": pair_err,
         "ms": pair_ms, "plain_ms": pair_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
