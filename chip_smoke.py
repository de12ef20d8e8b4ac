#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``yalla_tpu_torch/csrc`` and drives
the port's two paths: the branching model's Heun step at 500k cells on the
dense cube lattice, rebuilt before every pass, at the settings ``bench.py``
certifies (``bench_state.json``, ``branching_500000``), and the 5k sorting
model's Heun step on the all-pairs engine (``sorting_5000``), each from
its settled state in ``.bench_cache``.  Phases, each reported on its own
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
   launched 2 * N_STEPS times; its rate in cell-steps/s;
6. the central all-pairs kernel (K4) against its plain version on the
   settled 5k sorting state (5000 cells in 5120 rows), with the central
   adhesion: the friction sum exact, the forces within ``K4_ATOL`` (the
   factored form ``x_i * sum_w - sum_j w x_j`` cancels two sums of size
   ``|x| * sum|w|``), ``sum_v`` as K1's; first, the kernel's ``rsqrtf``
   against ``torch.rsqrt`` bit for bit over every pair's squared
   distance, which the exact friction sum rests on;
7. the tile all-pairs kernel (K3) against its plain version on the same
   state with the hand-written adhesion (friction sum exact), and on the
   600-cell branching state with its polarity channels (friction sum and
   ``epi_nbs`` exact);
8. the 5k slice, 2 steps of ``TileEngine(mxu=True)`` (central adhesion)
   and of ``TileEngine(pallas=True)`` (hand-written adhesion) on the GPU
   against the same steps through the plain versions on the CPU, every
   field within the reference's ``isclose``;
9. the 5k slice at ``bench_state.json`` ``sorting_5000``:
   ``Solution(n_pad=5120)`` with ``bench_engine(cfg)`` for ``N5`` steps
   after one warm-up step, flags 0, state finite, K4 launched 2 * N5
   times; then the same with ``TileEngine(pallas=True)`` and the
   hand-written adhesion, K3 launched 2 * N5 times; ms/step and
   cell-steps/s of each.

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
SORT_KEY = "sorting_5000"
N5_CELLS = 5000
SETTLED_5K = ROOT / ".bench_cache" / "settled_sorting_p5120_5000_s0_v1.npz"
N5 = 200
K4_ATOL = 1e-4


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


def compare_sums(tag, kernel, plain, exact, atol=ATOL):
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
            ok = bool(((k - p).abs() <= RTOL * p.abs() + atol * scale).all())
        if not ok:
            raise AssertionError(f"{tag} {name}: kernel and plain disagree "
                                 f"(max abs err {err:g})")
    return worst


def flatten(outs, prefix, n=None):
    """The named channels of a pair pass, rows below ``n`` (all rows if
    ``n`` is None)."""
    F, sum_f, sum_v, aux = outs[:4]
    d = {f"{prefix}F.{f}": a for f, a in zip(F._fields, F)}
    d[f"{prefix}sum_f"] = sum_f
    d.update({f"{prefix}sum_v{c}": a for c, a in enumerate(sum_v)})
    d.update({f"{prefix}{k}": a.reshape(-1) for k, a in aux.items()})
    return {k: a[:n] for k, a in d.items()}


def solution(path, n, engine, device, cube_size, Cell=None, n_pad=None):
    """A ``Solution`` on ``device`` holding the settled state at ``path``
    (branching cells unless ``Cell`` is given)."""
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching
    from yalla_tpu_torch.solvers import Solution
    Cell = Cell or branching.Cell
    X, old_v = load_settled(path, Cell, device)
    sol = Solution(Cell, n, engine=engine, cube_size=cube_size,
                   device=device, n_pad=n_pad)
    assert sol.n_pad == X.x.shape[0], (sol.n_pad, X.x.shape)
    sol.h_X = Cell(*(a.cpu().numpy() for a in X))
    sol.h_n = n
    sol.copy_to_device()
    sol.d_old_v = old_v
    return sol


def kernel_wrappers():
    """Each ported kernel's wrapper, whose ``launches`` counts its kernel
    launches, by the kernel's name in the JSON record."""
    from yalla_tpu_torch.ops.central_mxu import central_pairwise_mxu
    from yalla_tpu_torch.ops.lattice_pallas import lattice_pairwise_pallas
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas
    from yalla_tpu_torch.ops.tile_pallas import tile_pairwise_pallas
    return {"pour": pour_pallas, "lattice_pair": lattice_pairwise_pallas,
            "central_pair": central_pairwise_mxu,
            "tile_pair": tile_pairwise_pallas}


def run_slice(tag, sol, n_cells, n_steps, dt, force, expect,
              precompute=None):
    """One warm-up step, then ``n_steps`` steps with every launch count
    set to 0 just before and read just after.  Checks that every flag is
    0, the state is finite, and each kernel named in ``expect`` launched
    2 * n_steps times.  Returns (launches, ms/step, cell-steps/s)."""
    import numpy as np
    import torch
    sol.take_steps(1, dt, force, precompute=precompute)   # warm-up
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = sol.take_steps(n_steps, dt, force, precompute=precompute)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    flags = {k: float(v.max()) for k, v in aux.items()
             if k.startswith("__err_")}
    if any(flags.values()):
        raise AssertionError(f"{tag} flags set: {flags}")
    X_end = sol.copy_to_host()
    for f, a in zip(X_end._fields, X_end):
        if a.shape != (sol.n_pad,) or not np.isfinite(a).all():
            raise AssertionError(f"{tag} state field {f} is not finite")
    for name in expect:
        if launches[name] != 2 * n_steps:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times in {n_steps} steps, expected "
                                 f"{2 * n_steps}")
    ms, rate = dt_s * 1e3 / n_steps, n_cells * n_steps / dt_s
    print(f"{tag}: {n_steps} steps, flags {flags}, state finite, launches "
          f"{launches}; {ms:.3f} ms/step, {rate:.6g} cell-steps/s")
    return launches, ms, rate


def check_rsqrt(X, n):
    """The central kernel's ``rsqrtf`` against ``torch.rsqrt`` over the
    squared distance of every pair of the first ``n`` points (clamped as
    the kernel clamps it); raises on any difference."""
    import torch
    from yalla_tpu_torch import _build
    lib = _build.library()
    x, y, z = (a[:n] for a in (X.x, X.y, X.z))
    differ = 0
    for i0 in range(0, n, 1024):
        d2 = ((x[i0:i0 + 1024, None] - x[None, :]) ** 2
              + (y[i0:i0 + 1024, None] - y[None, :]) ** 2
              + (z[i0:i0 + 1024, None] - z[None, :]) ** 2)
        d2 = torch.clamp(d2, min=1e-12).contiguous()
        got = torch.empty_like(d2)
        _build.check(lib.yalla_rsqrtf(d2.data_ptr(), got.data_ptr(),
                                      d2.numel(),
                                      _build.stream_handle(d2.device)),
                     "rsqrtf")
        differ += int((got != torch.rsqrt(d2)).sum())
    if differ:
        raise AssertionError(f"rsqrtf and torch.rsqrt differ on {differ} "
                             f"of {n * n} pairs")
    print(f"rsqrtf: bit-exact against torch.rsqrt on all {n * n} pairs of "
          f"the settled 5k state")


def sorting_kernel_checks(dev):
    """Phases 6 and 7: K4 and K3 against their plain versions.  Returns
    {kernel: (max abs err, ms, plain ms)}."""
    import torch
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.models import sorting as S
    from yalla_tpu_torch.ops.central_mxu import (central_pairwise_mxu,
                                                 central_pairwise_plain)
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.tile_pallas import (tile_pairwise_pallas,
                                                 tile_pairwise_plain)
    from yalla_tpu_torch.solvers import augment
    n = N5_CELLS
    sp = S.Params()
    X, ov = load_settled(SETTLED_5K, S.Cell, dev)
    check_rsqrt(X, n)
    out = {}
    for name, force, kernel, plain, atol in (
            ("central_pair", S.make_adhesion_central(sp),
             central_pairwise_mxu, central_pairwise_plain, K4_ATOL),
            ("tile_pair", S.make_adhesion(sp), tile_pairwise_pallas,
             tile_pairwise_plain, ATOL)):
        def k(force=force, kernel=kernel):
            return kernel(force, friction_w_neighbour, X, ov, n)

        def pl(force=force, plain=plain):
            return plain(force, friction_w_neighbour, X, ov, n)
        got, want = k(), pl()
        torch.cuda.synchronize()
        err = compare_sums(f"{name} 5k", flatten(got, "", n),
                           flatten(want, "", n), {"sum_f"}, atol)
        ms, plain_ms = cuda_ms(k, 20), cuda_ms(pl, 5)
        out[name] = (err, ms, plain_ms)
        print(f"{name} on the settled 5k sorting state ({X.x.shape[0]} "
              f"rows): sum_f exact, max abs err {err:.3g} (rtol {RTOL}, "
              f"atol {atol} x max(1, max|plain|)); {ms:.4f} ms/pass vs "
              f"plain {plain_ms:.4f} ms/pass")

    Xb, ovb = load_settled(SETTLED_SMALL, B.Cell, dev)
    Xb = augment(Xb, N_SMALL, B.precompute)
    bforce = B.make_force(B.Params())
    got = tile_pairwise_pallas(bforce, friction_w_neighbour, Xb, ovb,
                               N_SMALL)
    want = tile_pairwise_plain(bforce, friction_w_neighbour, Xb, ovb,
                               N_SMALL)
    torch.cuda.synchronize()
    err = compare_sums("tile_pair branching", flatten(got, "", N_SMALL),
                       flatten(want, "", N_SMALL), {"sum_f", "epi_nbs"})
    print(f"tile_pair on the settled {N_SMALL}-cell branching state with "
          f"polarity channels ({Xb.x.shape[0]} rows): sum_f and epi_nbs "
          f"exact, max abs err {err:.3g}")
    err5, ms, plain_ms = out["tile_pair"]
    out["tile_pair"] = (max(err5, err), ms, plain_ms)
    return out


def sorting_engines():
    """The 5k slice's two all-pairs runs, (tag, engine, force, kernel,
    n_pad): ``bench_state.json`` ``sorting_5000``'s engine with the central
    adhesion, and its ``tile_pallas`` contender with the hand-written
    adhesion, both at the configuration's row count."""
    from yalla_tpu_torch.interop import bench_config, bench_engine
    from yalla_tpu_torch.models import sorting as S
    cfg = bench_config(ROOT / "bench_state.json", SORT_KEY)
    sp = S.Params()
    return (("5k central", bench_engine(cfg), S.make_adhesion_central(sp),
             "central_pair", cfg["n_pad"]),
            ("5k tile", bench_engine(dict(cfg, engine="tile_pallas")),
             S.make_adhesion(sp), "tile_pair", cfg["n_pad"]))


def sorting_gpu_vs_cpu(dev):
    """Phase 8: 2 steps of each 5k run on the GPU against the same steps
    through the plain versions on the CPU."""
    import numpy as np
    from yalla_tpu_torch.models import sorting as S
    sp = S.Params()
    for tag, engine, force, _, n_pad in sorting_engines():
        ends = {}
        for d in ("cpu", dev):
            s = solution(SETTLED_5K, N5_CELLS, engine, d, sp.r_max,
                         Cell=S.Cell, n_pad=n_pad)
            s.take_steps(2, sp.dt, force)
            ends[d] = s.copy_to_host()
        for f in S.Cell._fields:
            a, b = (getattr(ends[d], f)[:N5_CELLS] for d in (dev, "cpu"))
            if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all():
                raise AssertionError(f"{tag} field {f}: GPU and CPU "
                                     f"disagree (max abs err "
                                     f"{np.abs(a - b).max():g})")
        print(f"{tag}: 2 steps on the GPU within atol 1e-6 + rtol 1e-2 of "
              f"the CPU plain path in every field")


def sorting_slices(dev):
    """Phase 9: the 5k slice at ``bench_state.json`` ``sorting_5000`` on
    each engine.  Returns {kernel: launches of its run}."""
    from yalla_tpu_torch.models import sorting as S
    sp = S.Params()
    launches = {}
    for tag, engine, force, kernel, n_pad in sorting_engines():
        sol = solution(SETTLED_5K, N5_CELLS, engine, dev, sp.r_max,
                       Cell=S.Cell, n_pad=n_pad)
        counts, _, _ = run_slice(f"{tag} slice", sol, N5_CELLS, N5, sp.dt,
                                 force, [kernel])
        launches[kernel] = counts[kernel]
    return launches


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
    launches, _, _ = run_slice("slice", sol, N_CELLS, N_STEPS, p.dt, force,
                               ["pour", "lattice_pair"],
                               precompute=B.precompute)
    del sol

    # ---- the 5k sorting path: its kernels, then the slice -----------------
    sort_k = sorting_kernel_checks(dev)
    sorting_gpu_vs_cpu(dev)
    launches.update(sorting_slices(dev))

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
    for name, src, tpu in (
            ("central_pair", "central_pair.cu", "central_mxu.py:268"),
            ("tile_pair", "tile_pair.cu", "tile_pallas.py:118")):
        err, ms, plain_ms = sort_k[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"yalla_tpu_torch/csrc/{src}",
                        "replaces": f"yalla_tpu/ops/{tpu}",
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
