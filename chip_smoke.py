#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``yalla_tpu_torch/csrc`` and drives
the port's three paths: the branching model's Heun step at 500k cells on
the dense cube lattice, rebuilt before every pass, at the settings
``bench.py`` certifies (``bench_state.json``, ``branching_500000``), and
the 5k sorting model's Heun step on the all-pairs engine
(``sorting_5000``), each from its settled state in ``.bench_cache``; and
the growth_w_wall model's step at 100k cells on the Gabriel engine
(``models/growth_w_wall.py``, the engine settings and synthetic tissue of
``benchmarks/bench_gabriel_lattice.py``).  Phases, each reported on its
own line:

1. the card's name and power limit, and the kernel build time;
2. the pour kernel (K2) against its plain version on the main path's
   500k build: bit-exact, nothing unrouted; its device time (every kernel
   its wrapper launches) from a short ``torch.profiler`` window; beside
   it, the time of ``index_put_`` placing the same entries (the one
   PyTorch call that computes K2's function, timed here and never called
   by the port) into a buffer zeroed once beforehand, and of
   ``torch.zeros`` + ``index_put_`` (the zero fill is part of K2's
   function); the kernel's registers and spills;
3. the lattice pair kernel (K1) against its plain version on one layout of
   that state: counters and flags exact, the other sums within
   ``|kernel - plain| <= RTOL * |plain| + ATOL * max(1, max|plain|)`` per
   channel (f32 rounding of FMA-contracted force arithmetic and a
   different summation order); its device time per pass (lattice plus
   extras kernels) from a short ``torch.profiler`` window, and each
   kernel's registers and spills from the kept nvcc log;
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
   distance, which the exact friction sum rests on; its device time per
   pass (pair plus reduce kernels), registers and spills; then the same
   with the neighbour count ``nbs`` as an aux channel, exact;
7. the tile all-pairs kernel (K3) against its plain version on the same
   state with the hand-written adhesion (friction sum exact), and on the
   600-cell branching state with its polarity channels (friction sum and
   ``epi_nbs`` exact); its device time per pass (pair plus reduce
   kernels) from a short ``torch.profiler`` window, registers and spills;
8. the 5k slice, 2 steps of ``TileEngine(mxu=True)`` (central adhesion)
   and of ``TileEngine(pallas=True)`` (hand-written adhesion) on the GPU
   against the same steps through the plain versions on the CPU, every
   field within the reference's ``isclose``;
9. the 5k slice at ``bench_state.json`` ``sorting_5000``:
   ``Solution(n_pad=5120)`` with ``bench_engine(cfg)`` for ``N5`` steps
   after one warm-up step, flags 0, state finite, K4 launched 2 * N5
   times; then the same with ``TileEngine(pallas=True)`` and the
   hand-written adhesion, K3 launched 2 * N5 times; ms/step and
   cell-steps/s of each;
10. the Gabriel lattice kernel (K5) against its plain version on one pass
    of the 100k half-space tissue with the growth_w_wall force and
    friction: the friction sum (kept non-wall pairs) exact, every flag 0
    and equal, F and sum_v within ``compare_sums``'s tolerance; ms per
    pass of each, and of the lattice build inside them; its device time
    (every kernel and fill its wrapper launches after the build),
    registers and spills; the same comparison at NC 4 on the 2,000-cell
    tissue, where most points overflow their compact set (the flags
    equal, the sums equal on the overflowed points and on the rest); and
    K2 on that lattice build, bit-exact, with its device time;
11. the small Gabriel slice: 2 steps of the growth_w_wall loop on the
    2,000-cell tissue (gs 16, C 8, NC 20; the protrusion draws made from a
    numpy seed) on the GPU against the same steps on the CPU plain path,
    every field within the reference's ``isclose``;
12. the 100k growth_w_wall slice: ``Solution`` + ``GabrielEngine(
    lattice=True, **GABRIEL_100K)`` and ``Links``, ``NG`` steps of
    ``Links.update`` + ``take_step`` after one warm-up step, every flag 0,
    the state finite, K5 and K2 launched 2 * NG times; ms/step and
    cell-steps/s.

It then prints the kernels' JSON record (each kernel's ``device_ms`` is
its profiler time on its path's main shapes) and, last, the device
record.
Each kernel's ``bound_ms`` is the least time the card could take for its
function on this run's inputs: the larger of the bytes it must move (each
input read once, each output written once) over 3.35 TB/s and the
operations it must do over 67 TFLOP/s (f32 outside the tensor cores),
``bound_by`` saying which; the operations per pair are counted from
``csrc/forces.cuh`` (``OPS_PER_PAIR``) and the pairs from this run's data.
Any failure raises and exits non-zero, a profiler window that shows no
device time for a kernel included.  Without a CUDA device it exits
non-zero at once and prints no result.
"""
import json
import re
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
NG_CELLS = 100_000
NG = 20
# the 100k slice's engine settings are kernel_profile.GABRIEL_100K
GABRIEL_SMALL = dict(grid_size=16, capacity=8, max_candidates=20)
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations per evaluated pair, counted from csrc/forces.cuh and
# csrc/central_pair.cu: pair_dist (3 differences, 3 products, 2 sums and
# the square root) plus the functor's pair term with its friction
OPS_DIST = 9
OPS_PER_PAIR = {"branching": OPS_DIST + 100, "sorting": OPS_DIST + 32,
                "central": OPS_DIST + 29, "wall_relu": OPS_DIST + 16}
# K5's midpoint test of one candidate against another (midpoint, three
# differences, products and sums, the compare)
OPS_MIDPOINT = 14


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


def bound(n_bytes, n_ops):
    """(bound ms, "bytes" or "operations"): the larger of ``n_bytes`` over
    the card's memory rate and ``n_ops`` over its f32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def profiled_ms(fn, names, calls=5):
    """Device milliseconds per call of ``fn`` spent in each kernel whose
    name contains one of ``names``, from a ``torch.profiler`` window of
    ``calls`` calls after one warm-up call
    (``yalla_tpu_torch/kernel_profile.py``); raises if the profiler shows
    no device time for one of them."""
    from yalla_tpu_torch.kernel_profile import device_window, named
    per = named(device_window(fn, calls)[0], names)
    missing = [k for k, v in per.items() if not v > 0]
    if missing:
        raise AssertionError(f"torch.profiler shows no device time for "
                             f"{missing}")
    return per


def device_ms(fn, calls=10):
    """Device milliseconds per call of every kernel and copy ``fn``
    launches, from a ``torch.profiler`` window (raises if it shows
    none)."""
    from yalla_tpu_torch.kernel_profile import device_window
    return device_window(fn, calls)[1]


def check_pour(tag, cs, grid, capacity):
    """K2 against its plain version on one build's sort ``cs``: the same
    bits in every slot, ``n_unrouted`` 0.  Returns the max abs error."""
    import torch
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas, pour_plain
    got = pour_pallas(cs.S, cs.row_starts, grid, capacity)
    want = pour_plain(cs.S, cs.row_starts, grid, capacity)
    torch.cuda.synchronize()
    # bit for bit: +0.0 in empty slots
    for name, a, b in zip(("out", "live"), got, want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"pour {tag} {name}: kernel != plain")
    if not torch.equal(got[2], want[2]) or int(got[2]):
        raise AssertionError(f"pour {tag}: {int(got[2])} entries unrouted")
    print(f"K2 pour on the {tag} build: bit-exact vs plain (out, live), "
          f"n_unrouted 0, {int(got[1].sum())} slots live")
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def ptxas_report(names):
    """Registers and spill bytes of each compiled kernel whose mangled name
    contains one of ``names``, from nvcc's kept log (``-Xptxas -v``)."""
    from yalla_tpu_torch import _build
    log = _build.build().with_suffix(".log").read_text()
    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([A-Za-z0-9_]+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or not any(k in current for k in names):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report.setdefault(current, {})["spills"] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(current, {})["registers"] = int(m[1])
    for name, r in sorted(report.items()):
        print(f"ptxas {name}: {r.get('registers')} registers, spill "
              f"stores/loads {r.get('spills')} bytes")
    if not all(any(k in name for name in report) for k in names):
        raise AssertionError(f"nvcc log names no kernel among {names}")
    return report


def stencil_candidates(cube, gx, gy, gz):
    """Sum over the points of the live points in the 27 cubes around each
    point's cube (the candidates a lattice pass must test), itself
    included.  ``cube``: int64 cube ids of the live points."""
    import torch
    counts = torch.bincount(cube, minlength=gx * gy * gz).reshape(
        gz, gy, gx).to(torch.float64)
    pad = torch.nn.functional.pad(counts, (1, 1, 1, 1, 1, 1))
    near = sum(pad[dz:dz + gz, dy:dy + gy, dx:dx + gx]
               for dz in range(3) for dy in range(3) for dx in range(3))
    return float((counts * near).sum())


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
    from yalla_tpu_torch.ops.gabriel_pallas import gabriel_lattice_pallas
    from yalla_tpu_torch.ops.lattice_pallas import lattice_pairwise_pallas
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas
    from yalla_tpu_torch.ops.tile_pallas import tile_pairwise_pallas
    return {"pour": pour_pallas, "lattice_pair": lattice_pairwise_pallas,
            "central_pair": central_pairwise_mxu,
            "tile_pair": tile_pairwise_pallas,
            "gabriel_pair": gabriel_lattice_pallas}


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
    {kernel: (max abs err, ms, plain ms, bound ms, bound by, device
    ms)}."""
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
        functor = "central" if name == "central_pair" else "sorting"
        # the n points' fields and old_v read, 7 sums per row written
        n_bytes = (len(X) + 3) * 4 * n + 7 * 4 * X.x.shape[0]
        out[name] = (err, ms, plain_ms,
                     *bound(n_bytes, n * (n - 1) * OPS_PER_PAIR[functor]))
        print(f"{name} on the settled 5k sorting state ({X.x.shape[0]} "
              f"rows): sum_f exact, max abs err {err:.3g} (rtol {RTOL}, "
              f"atol {atol} x max(1, max|plain|)); {ms:.4f} ms/pass vs "
              f"plain {plain_ms:.4f} ms/pass; bound {out[name][3]:.4f} ms "
              f"({out[name][4]})")
        names = {"central_pair": ["central_pair_kernel",
                                  "central_reduce_kernel"],
                 "tile_pair": ["tile_pair_kernel", "tile_reduce_kernel"]}
        dev_ms = profiled_ms(k, names[name])
        out[name] += (sum(dev_ms.values()),)
        print(f"{name} device time per 5k pass (torch.profiler): "
              f"{out[name][-1]:.4f} ms = " + " + ".join(
                  f"{v:.4f} {k}" for k, v in dev_ms.items()))
        ptxas_report(names[name])

    # K4 with the neighbour count as its aux channel
    counting = S.make_adhesion_central(sp, count_neighbours=True)
    got = central_pairwise_mxu(counting, friction_w_neighbour, X, ov, n)
    want = central_pairwise_plain(counting, friction_w_neighbour, X, ov, n)
    torch.cuda.synchronize()
    err = compare_sums("central_pair nbs 5k", flatten(got, "", n),
                       flatten(want, "", n), {"sum_f", "nbs"}, K4_ATOL)
    print(f"central_pair with the nbs aux on the settled 5k state: sum_f and "
          f"nbs exact ({int(want[3]['nbs'][:n].sum())} neighbour pairs), "
          f"max abs err {err:.3g}")
    err4, *rest = out["central_pair"]
    out["central_pair"] = (max(err4, err), *rest)

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
    err5, *rest = out["tile_pair"]
    out["tile_pair"] = (max(err5, err), *rest)
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


def gabriel_overflow_check(dev):
    """K5 against its plain version where the compact set overflows: NC 4
    on the 2,000-cell half-space tissue.  The per-point overflow flags
    equal, and the sums equal on the points that overflowed (which rest on
    the first NC candidates in stencil order) and on those that did
    not.  Returns the max abs error."""
    import torch
    from yalla_tpu_torch.kernel_profile import gabriel_tissue
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.gabriel_pallas import (gabriel_lattice_pallas,
                                                    gabriel_lattice_plain)
    X, ov, n = gabriel_tissue(2000, dev)
    kw = dict(GABRIEL_SMALL, max_candidates=4)
    args = (W.relu_force, W.wall_friction, X, ov, n, W.r_max)
    got, want = (flatten(fn(*args, **kw), "", n)
                 for fn in (gabriel_lattice_pallas, gabriel_lattice_plain))
    torch.cuda.synchronize()
    over = want["__err_gabriel_candidates"] > 0
    n_over = int(over.sum())
    if not 0 < n_over < n:
        raise AssertionError(f"K5 NC 4: {n_over} of {n} points overflow; the "
                             f"check needs both kinds")
    exact = {"sum_f", "__err_gabriel_candidates", "__err_lattice_dropped",
             "__err_out_of_grid"}
    err = 0.0
    for tag, rows in (("overflowed", over), ("within NC", ~over)):
        def pick(d, rows=rows):
            return {k: a if a.shape != rows.shape else a[rows]
                    for k, a in d.items()}
        err = max(err, compare_sums(f"K5 NC 4 {tag}", pick(got), pick(want),
                                    exact))
    print(f"K5 Gabriel lattice at NC 4 on the 2,000-cell tissue ({n} cells): "
          f"{n_over} points overflow, flags equal, sum_f exact "
          f"({int(want['sum_f'][over].sum())} kept pair ends on the "
          f"overflowed points), max abs err {err:.3g}")
    return err


def gabriel_kernel_check(dev):
    """Phase 10: K5 against its plain version on the 100k tissue and where
    its compact set overflows, and K2 on its lattice build.  Returns ((max
    abs err, ms, plain ms, bound ms, bound by, device ms) of K5, K2's max
    abs err)."""
    import torch
    from yalla_tpu_torch.kernel_profile import (GABRIEL_100K, device_window,
                                                gabriel_after_build,
                                                gabriel_tissue, named)
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.common import cube_ids
    from yalla_tpu_torch.ops.gabriel_pallas import (gabriel_lattice_pallas,
                                                    gabriel_lattice_plain)
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas
    from yalla_tpu_torch.ops.lattice_xla import lattice_build, sort_by_cube
    X, ov, n = gabriel_tissue(NG_CELLS, dev)
    n_pad = X.x.shape[0]
    args = (W.relu_force, W.wall_friction, X, ov, n, W.r_max)

    def k5():
        return gabriel_lattice_pallas(*args, **GABRIEL_100K)

    def k5_plain():
        return gabriel_lattice_plain(*args, **GABRIEL_100K)
    got, want = k5(), k5_plain()
    torch.cuda.synchronize()
    flags = {k: float(v.max()) for k, v in want[3].items()}
    if any(flags.values()):
        raise AssertionError(f"K5 100k: flags set on the tissue: {flags}")
    exact = {"sum_f", *want[3]}
    err = compare_sums("K5 100k", flatten(got, "", n), flatten(want, "", n),
                       exact)
    kept = int(want[1][:n].sum())
    ms, plain_ms = cuda_ms(k5, 20), cuda_ms(k5_plain, 3)
    # the work this tissue needs: every live slot of the 27 cubes tested
    # for reach, every within-reach candidate against every other (the
    # midpoint test), the force on every kept pair
    cand = torch.zeros(n, dtype=torch.float64, device=dev)
    P = torch.stack([a[:n] for a in X], 1)
    for i0 in range(0, n, 1024):
        d2 = ((P[i0:i0 + 1024, None, :] - P[None, :, :]) ** 2).sum(-1)
        cand[i0:i0 + 1024] = (d2 < W.r_max ** 2).sum(1) - 1
    del P
    gs, C = GABRIEL_100K["grid_size"], GABRIEL_100K["capacity"]
    live_cube = cube_ids(X, n, W.r_max, gs)[:n]
    n_ops = stencil_candidates(live_cube, gs, gs, gs) * OPS_DIST + \
        float((cand ** 2).sum()) * OPS_MIDPOINT + \
        kept * OPS_PER_PAIR["wall_relu"]
    # the bytes: the occupancy as the lattice holds it, each cube's live
    # stable ids and the empty slot that ends them (8 bytes each; a full
    # cube has none), the live points' positions and old_v, and the 8 rows
    # written (F, sum_f, sum_v and the candidate flag)
    per_cube = torch.bincount(live_cube, minlength=gs ** 3)
    id_bytes = 8 * int(torch.clamp(per_cube + 1, max=C).sum())
    n_bytes = id_bytes + nbytes(*X, *ov) * n // n_pad + nbytes(
        *got[0], got[1], *got[2], got[3]["__err_gabriel_candidates"])
    bound_ms, bound_by = bound(n_bytes, n_ops)
    build_ms = cuda_ms(lambda: lattice_build(X, ov, n, W.r_max, gs, C), 20)
    # every kernel and fill the wrapper launches after its lattice build
    with gabriel_after_build(X, ov, n, **GABRIEL_100K) as k5_built:
        per, dev_ms, n_kernels = device_window(k5_built, 10)
    pair_ms = named(per, ["gabriel_pair_kernel"])["gabriel_pair_kernel"]
    if not pair_ms > 0:
        raise AssertionError("torch.profiler shows no device time for "
                             "gabriel_pair_kernel")
    # K2 on this path's lattice build
    cs = sort_by_cube(X, ov, n, W.r_max, gs, C)
    pour_err = check_pour("100k Gabriel", cs, gs, C)
    pour_dev = device_ms(lambda: pour_pallas(cs.S, cs.row_starts, gs, C))
    print(f"K2 pour device time per 100k build (torch.profiler): "
          f"{pour_dev:.4f} ms")
    print(f"K5 Gabriel lattice on the 100k half-space tissue ({n} cells in "
          f"{n_pad} rows, gs {gs}, C {C}, NC "
          f"{GABRIEL_100K['max_candidates']}): {kept} kept non-wall pair "
          f"ends, sum_f and flags {flags} exact, max abs err {err:.3g} (rtol "
          f"{RTOL}, atol {ATOL} x max(1, max|plain|)); {ms:.4f} ms/pass vs "
          f"plain {plain_ms:.4f} ms/pass, of which the lattice build "
          f"{build_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_bytes / 1e6:.2f} MB of which {id_bytes / 1e6:.2f} MB of "
          f"stable ids, {n_ops / 1e9:.3f} GFLOP)")
    print(f"K5 device time per 100k pass after the build (torch.profiler): "
          f"{dev_ms:.4f} ms in {n_kernels:g} kernels = {pair_ms:.4f} "
          f"gabriel_pair_kernel + {dev_ms - pair_ms:.4f} for the fill of "
          f"the sums and the casts of the flags; bound "
          f"{100 * bound_ms / dev_ms:.1f} % of it")
    ptxas_report(["gabriel_pair_kernel"])
    err = max(err, gabriel_overflow_check(dev))
    return (err, ms, plain_ms, bound_ms, bound_by, dev_ms), pour_err


def gabriel_run(device, n_cells, engine, n_steps, seed, links_seed=None):
    """A growth_w_wall Solution and its Links on ``device`` after
    ``n_steps`` steps of the example's loop (``Links.update`` then
    ``take_step``).  With ``seed`` the protrusion draws come from a numpy
    generator of that seed, so two devices see the same draws; without,
    from the Links' own generator (seeded ``links_seed``)."""
    import numpy as np
    import torch
    from yalla_tpu_torch.links import Draws, Links, link_wall_forces
    from yalla_tpu_torch.models import growth_w_wall as W
    sol = W.half_space_solution(n_cells, engine, device)
    links = Links(n_cells, W.protrusion_strength, seed=links_seed,
                  device=device)
    links.set_d_n(sol.h_n)
    rng = np.random.default_rng(seed) if seed is not None else None
    aux = {}

    def step():
        draws = None
        if rng is not None:
            m = links.n_pad
            draws = Draws(*(torch.as_tensor(a, device=device) for a in (
                rng.integers(0, 27, m), rng.random(m, np.float32),
                rng.random(m, np.float32))))
        links.update(W.update_protrusions_wall, sol, draws=draws)
        return sol.take_step(W.dt, W.relu_force, pw_friction=W.wall_friction,
                             gen_forces=link_wall_forces(links, W.WALL))
    for _ in range(n_steps):
        aux = step()
    return sol, step, aux


def gabriel_gpu_vs_cpu(dev):
    """Phase 11: the small Gabriel slice, GPU against CPU."""
    import numpy as np
    from yalla_tpu_torch.solvers import GabrielEngine
    engine = GabrielEngine(lattice=True, **GABRIEL_SMALL)
    ends = {}
    for d in ("cpu", dev):
        sol, _, _ = gabriel_run(d, 2000, engine, 2, seed=5)
        ends[d] = sol.copy_to_host()
    n = sol.h_n
    for f in "xyz":
        a, b = (getattr(ends[d], f)[:n] for d in (dev, "cpu"))
        if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all():
            raise AssertionError(f"small Gabriel slice field {f}: GPU and "
                                 f"CPU disagree (max abs err "
                                 f"{np.abs(a - b).max():g})")
    print(f"small Gabriel slice: {n} cells, 2 steps of Links.update + "
          f"take_step on the GPU within atol 1e-6 + rtol 1e-2 of the CPU "
          f"plain path in every field")


def growth_w_wall_slice(dev):
    """Phase 12: the 100k growth_w_wall slice.  Returns the launch counts
    of its timed run."""
    import numpy as np
    import torch
    from yalla_tpu_torch.dtypes import Float3
    from yalla_tpu_torch.kernel_profile import GABRIEL_100K
    from yalla_tpu_torch.solvers import GabrielEngine, Solution
    engine = GabrielEngine(lattice=True, **GABRIEL_100K)
    # the solver name reaches the same engine class
    assert isinstance(Solution(Float3, 10, solver="gabriel",
                               device=dev).engine, GabrielEngine)
    sol, step, _ = gabriel_run(dev, NG_CELLS, engine, 1, seed=None,
                               links_seed=15)          # one warm-up step
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NG):
        aux = step()     # take_step raises on any __err_ flag
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    flags = {k: float(v.max()) for k, v in aux.items()
             if k.startswith("__err_")}
    if any(flags.values()):
        raise AssertionError(f"growth_w_wall slice flags set: {flags}")
    X_end = sol.copy_to_host()
    for f, a in zip(X_end._fields, X_end):
        if not np.isfinite(a).all():
            raise AssertionError(f"growth_w_wall slice field {f} is not "
                                 f"finite")
    for name in ("gabriel_pair", "pour"):
        if launches[name] != 2 * NG:
            raise AssertionError(f"growth_w_wall slice: {name} launched "
                                 f"{launches[name]} times in {NG} steps, "
                                 f"expected {2 * NG}")
    n = sol.h_n
    ms, rate = dt_s * 1e3 / NG, n * NG / dt_s
    print(f"growth_w_wall slice: {n} cells, {NG} steps of Links.update + "
          f"take_step, flags {flags}, state finite, launches {launches}; "
          f"{ms:.3f} ms/step, {rate:.6g} cell-steps/s")
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
    from yalla_tpu_torch.ops.common import cube_ids, friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                    lattice_pairwise_plain)
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas, pour_plain
    from yalla_tpu_torch.ops.lattice_xla import lattice_build, sort_by_cube
    from yalla_tpu_torch.solvers import LatticeEngine, augment

    from yalla_tpu_torch.kernel_profile import card
    dev = torch.device("cuda")
    print(card())
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
    cs = sort_by_cube(X, old_v, N_CELLS, cube, gs, C)
    pour_err = check_pour("500k", cs, gs, C)

    def k2():
        return pour_pallas(cs.S, cs.row_starts, gs, C)
    pour_ms = cuda_ms(k2, 20)
    pour_plain_ms = cuda_ms(
        lambda: pour_plain(cs.S, cs.row_starts, gs, C), 20)
    # every kernel the wrapper launches (the pour and the sum of its
    # per-block counts), by the profiler
    pour_dev = device_ms(k2)
    # the library calls: index_put_ of the placed entries (slot-major rows,
    # with the live flag as their last channel), into a buffer zeroed once
    # outside the timing as before, and with the zero fill that K2's
    # function includes
    S = cs.S
    placed = (S[-1] >= 0) & (S[-1] < n_slots)
    dst = S[-1][placed].to(torch.int64)
    rows = torch.cat([S[:-1, placed], torch.ones_like(S[:1, placed])]).T \
        .contiguous()
    lib_out = torch.zeros((n_slots, S.shape[0]), device=dev)

    def put():
        return lib_out.index_put_((dst,), rows)

    def zeros_put():
        return torch.zeros((n_slots, S.shape[0]), device=dev).index_put_(
            (dst,), rows)
    pour_lib_ms, pour_fill_ms = cuda_ms(put, 20), cuda_ms(zeros_put, 20)
    lib_dev, fill_dev = device_ms(put), device_ms(zeros_put)
    want = pour_plain(cs.S, cs.row_starts, gs, C)
    if not torch.equal(lib_out[:, :-1].T, want[0]) or \
            not torch.equal(zeros_put()[:, :-1].T, want[0]):
        raise AssertionError("pour: index_put_ disagrees with plain")
    pour_bound = bound(nbytes(S) + nbytes(*want[:2]), 0)
    print(f"K2 pour per 500k build: {pour_ms:.4f} ms/call (device "
          f"{pour_dev:.4f}, torch.profiler) vs plain {pour_plain_ms:.4f} "
          f"ms/call; index_put_ alone {pour_lib_ms:.4f} ms/call (device "
          f"{lib_dev:.4f}), torch.zeros + index_put_ {pour_fill_ms:.4f} "
          f"ms/call (device {fill_dev:.4f}); bound {pour_bound[0]:.4f} ms "
          f"({pour_bound[1]}), {100 * pour_bound[0] / pour_dev:.1f} % of "
          f"the device time")
    ptxas_report(["pour_kernel"])
    del lib_out, rows, dst, placed, want, S, cs

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
    # the work this layout needs: the live cells' 12 channels and the
    # occupancy read, 13 sums per slot and extra written; every live cell
    # of the 27 cubes tested for reach, the force on every pair in reach
    # (the friction sum counts them: cutoff and r_max are both 1)
    n_live = int((lay.pid < lay.slot_of.shape[0]).sum()) + int(lay.n_extras)
    live_cube = torch.cat([
        torch.nonzero(lay.pid < lay.slot_of.shape[0]).squeeze(1) // C,
        cube_ids(lay.E, engine.extras_cap, cube, gs)[
            lay.epid < lay.slot_of.shape[0]]])
    in_reach = float(want[1].sum() + want[4][1].sum())
    candidates = stencil_candidates(live_cube, *gs)
    pair_bound = bound(
        n_live * 12 * 4 + n_slots + (n_slots + engine.extras_cap) * 13 * 4,
        candidates * OPS_DIST + in_reach * OPS_PER_PAIR["branching"])
    print(f"K1 work: {candidates / n_live:.2f} live candidates (self "
          f"included) and {in_reach / n_live:.2f} partners in reach per "
          f"cell, {n_live} cells")
    pair_dev = profiled_ms(k1, ["lattice_pair_kernel", "extras_pair_kernel"])
    print(f"K1 lattice pair: {int(lay.n_extras)} live extras, counters and "
          f"flags exact, max abs err {pair_err:.3g} (rtol {RTOL}, atol "
          f"{ATOL} x max(1, max|plain|)); {pair_ms:.3f} ms/pass vs plain "
          f"{pair_plain_ms:.3f} ms/pass; bound {pair_bound[0]:.4f} ms "
          f"({pair_bound[1]})")
    print(f"K1 device time per 500k pass (torch.profiler): "
          f"{sum(pair_dev.values()):.4f} ms = " + " + ".join(
              f"{v:.4f} {k}" for k, v in pair_dev.items()))
    ptxas_report(["lattice_pair_kernel", "extras_pair_kernel"])
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

    # ---- the 100k growth_w_wall path: K5, the small slice, the slice -----
    k5, pour_err100k = gabriel_kernel_check(dev)
    pour_err = max(pour_err, pour_err100k)
    gabriel_gpu_vs_cpu(dev)
    launches["gabriel_pair"] = growth_w_wall_slice(dev)["gabriel_pair"]

    kernels = [
        {"name": "pour", "route": "cuda",
         "source": "yalla_tpu_torch/csrc/pour.cu",
         "replaces": "yalla_tpu/ops/lattice_pour.py:244",
         "launches": launches["pour"], "max_abs_err": pour_err,
         "ms": pour_ms, "device_ms": pour_dev, "plain_ms": pour_plain_ms,
         "bound_ms": pour_bound[0], "bound_by": pour_bound[1],
         "library_ms": pour_lib_ms, "library_with_fill_ms": pour_fill_ms},
        {"name": "lattice_pair", "route": "cuda",
         "source": "yalla_tpu_torch/csrc/lattice_pair.cu",
         "replaces": "yalla_tpu/ops/lattice_pallas.py:672",
         "launches": launches["lattice_pair"], "max_abs_err": pair_err,
         "ms": pair_ms, "device_ms": sum(pair_dev.values()),
         "plain_ms": pair_plain_ms,
         "bound_ms": pair_bound[0], "bound_by": pair_bound[1],
         "library_ms": None},
    ]
    for name, src, tpu, (err, ms, plain_ms, bound_ms, bound_by, dev_ms) in (
            ("central_pair", "central_pair.cu", "central_mxu.py:268",
             sort_k["central_pair"]),
            ("tile_pair", "tile_pair.cu", "tile_pallas.py:118",
             sort_k["tile_pair"]),
            ("gabriel_pair", "gabriel_pair.cu", "gabriel_pallas.py:271",
             k5)):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"yalla_tpu_torch/csrc/{src}",
                        "replaces": f"yalla_tpu/ops/{tpu}",
                        "launches": launches[name], "max_abs_err": err,
                        "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
