"""Device time of the port's kernels K1 to K5 and of the steps around
them, by ``torch.profiler``, on one GPU.

    python3 yalla_tpu_torch/kernel_profile.py [ROOT ...]

ROOT is a checkout of the repository (default: this one).  For each ROOT in
turn, each in a process of its own that imports ``yalla_tpu_torch`` and
reads ``.bench_cache`` and ``bench_state.json`` from that ROOT, it prints
one JSON line:

* ``k1``: device ms per pass of each K1 kernel on the settled 500k
  branching state at ``bench_state.json`` ``branching_500000``;
* ``k2``: device ms per 500k build of the pour wrapper (``busy_ms``: every
  kernel and copy it launches, ``kernels`` of them) and of the pour kernel
  itself (``pour_kernel``), on the same state's cube sort;
* ``k3``: device ms per pass of each K3 kernel on the settled 5k sorting
  state with the hand-written adhesion;
* ``k4``: device ms per pass of each K4 kernel on the same state with the
  central adhesion;
* ``k5``: device ms per pass of the Gabriel lattice wrapper on the 100k
  half-space tissue (gs 48, C 16, NC 32) after its lattice build
  (``busy_ms``: every kernel and fill it launches then, ``kernels`` of
  them) and of the pair kernel itself (``gabriel_pair_kernel``);
* ``step_500k``, ``step_5k_tile``, ``step_5k_central``, ``step_100k``
  and ``step_iwg``: per step of the 500k slice, of the 5k slice on
  ``TileEngine(pallas=True)`` and ``TileEngine(mxu=True)``, of the 100k
  growth_w_wall slice (``Links.update`` + ``take_step``) and of the
  intercalation_w_gradient example at full width (its ``step``; the
  link forces' ``index_add`` kernels named beside K1; only in trees
  that have the example), the device busy
  ms (the sum of every kernel's and copy's device time in a profiled
  window, over its steps), the device kernels launched, and the wall ms
  of each of ``WALL_WINDOWS`` unprofiled windows.

    python3 yalla_tpu_torch/kernel_profile.py --k1 [ROOT ...]

prints instead, per ROOT, one JSON line of ``k1`` alone (as above); with
two trees in alternation, the verdict line as below.

    python3 yalla_tpu_torch/kernel_profile.py --step-500k [ROOT ...]

prints instead, per ROOT, one JSON line of ``k1`` and ``step_500k``
alone (as above); with two trees in alternation, the verdict line as
below.

    python3 yalla_tpu_torch/kernel_profile.py --k1-xsplit [ROOT ...]

prints instead, per ROOT, one JSON line of ``k1_xsplit``: device ms per
pass of each K1 kernel on the thin x-cubes of the settled 500k state
(``THIN_500K``: grid 128 x 64 x 64 of half-width x-cubes, C 5, the build
of ``chip_smoke.py`` phase 27), null in a tree whose K1 has no thin
cubes; with two trees in alternation, the verdict line as below.

Every device time is the mean of ``DEVICE_WINDOWS`` profiled windows; the
windows' own values of the entry's metric stand beside it (``windows_ms``:
the named kernels' sum for ``k1``, ``k3`` and ``k4``, else ``busy_ms``).

    python3 yalla_tpu_torch/kernel_profile.py --plans [ROOT]

prints instead one JSON line of the launch plans around the ones the
wrappers take: the pour's device ms per build at 1, 2, 4 and 8 rows of
slots per block (``pour_plan``) on the 500k and the 100k growth_w_wall
builds, the central kernels' device ms per 5k pass at 26, 52, 53 and
66 splits of j (``central_plan``), and the Gabriel lattice kernel's device
ms per 100k pass at other bricks of cubes (``gabriel_plan``).

A root named more than once runs each time, so two trees compare in one
call in turns: ``A B A B A B``.  Given exactly two trees in alternation,
it then prints one JSON line of verdicts, per metric: ``better`` or
``worse`` (the second tree against the first) where every pair agrees and
each pair's difference of medians exceeds the spread of both runs'
windows (device and wall windows alike), else ``unresolved``.  The card's
name and power limit lead every line.  Exits non-zero without a CUDA
device, or if a window shows no device time.
"""
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# run as a script, this file's directory leads sys.path; the package is
# imported from ROOT instead
if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)

K1_KERNELS = ("lattice_pair_kernel", "extras_pair_kernel")
K3_KERNELS = ("tile_pair_kernel", "tile_reduce_kernel")
K4_KERNELS = ("central_pair_kernel", "central_reduce_kernel")
WALL_WINDOWS = 5
DEVICE_WINDOWS = 3
# profiler windows a device time may take (a chip_smoke.py run on an
# H100 saw four in a row come back without device events)
WINDOW_TRIES = 8
# The 100k growth_w_wall slice's engine.  benchmarks/
# bench_gabriel_lattice.py:43-58 at 100k cells has grid 48, C 8 and NC 20,
# certified there with dead links.  Live protrusions contract the tissue:
# the largest candidate count grows from 16 to 22 in 21 steps and a cube
# fills to 9 by step 23, so the slice takes C 16 (the grid stays 48) and
# NC 32.
GABRIEL_100K = dict(grid_size=48, capacity=16, max_candidates=32)
# Thin x-cubes on the settled 500k state (x_split 2: x binned at half the
# cube size, 128 of them across): the fullest half-cube holds 7, so C 5
# spills 136 cells into a 2048-entry extras list
THIN_500K = dict(grid_size=(128, 64, 64), capacity=5, z_block=2,
                 extras_cap=2048, extras_block_cap=24, x_split=2)


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_window(fn, calls):
    """Profile ``calls`` calls of ``fn`` after one warm-up; returns
    ({kernel or copy name: device ms per call}, device ms per call of all
    kernels and copies, device kernels per call).  Only the device's own
    events count: a host op's row carries the device time of the kernels
    it launched, which their own rows already hold, a host span (the
    program's ``utils.profiling`` spans) is mirrored on the device's
    timeline under its own name, and CUPTI's buffer requests are the
    profiler's.  A window whose device events did not
    arrive (CUPTI drops one now and then, at times several in a row) is
    taken again after a pause, ``WINDOW_TRIES`` windows in all; raises if
    the profiler still shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(WINDOW_TRIES):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per, busy, kernels = {}, 0.0, 0
        host = {e.name for e in prof.events()
                if e.device_type == DeviceType.CPU}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CPU or e.key in host or \
                    e.key == "Activity Buffer Request":
                continue
            self_us = e.self_device_time_total
            if self_us > 0:
                per[e.key] = self_us / 1e3 / calls
                busy += self_us / 1e3 / calls
                kernels += e.count
        if busy > 0:
            return per, busy, kernels / calls
        print("kernel_profile: a profiler window without device events, "
              "taken again", file=sys.stderr)
    raise RuntimeError("torch.profiler shows no device time")


def named(per, names):
    """ms of the keys containing each of ``names`` (0 where none does)."""
    return {n: sum(v for k, v in per.items() if n in k) for n in names}


def gabriel_tissue(n_cells, dev):
    """The half-space tissue of ``n_cells`` with a small seeded old_v, on
    ``dev``: ``(X, old_v, n)``."""
    import torch
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.solvers import Solution
    n_pad = Solution(W.Float3, n_cells, device=dev).n_pad
    h, n = W.half_space_tissue(n_cells, n_pad)
    X = W.Float3(*(torch.as_tensor(h[f], device=dev) for f in "xyz"))
    g = torch.Generator().manual_seed(0)
    ov = W.Float3(*(0.01 * torch.randn(n_pad, generator=g).to(dev)
                    for _ in range(3)))
    return X, ov, n


@contextlib.contextmanager
def gabriel_after_build(X, ov, n, **engine):
    """The Gabriel lattice wrapper with the growth_w_wall force on
    ``(X, ov, n)`` as a function of no arguments, its lattice build left
    out: inside the context the wrapper is handed the layout built once
    beforehand, so a window around the function holds every kernel and
    fill the wrapper launches after the build."""
    from unittest import mock

    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops import gabriel_pallas
    lay = gabriel_pallas.lattice_build(X, ov, n, W.r_max,
                                       engine["grid_size"],
                                       engine["capacity"], 0)
    with mock.patch.object(gabriel_pallas, "lattice_build",
                           lambda *_: lay):
        yield lambda: gabriel_pallas.gabriel_lattice_pallas(
            W.relu_force, W.wall_friction, X, ov, n, W.r_max, **engine)


def _device_windows(fn, calls, names=(), of_names=False, fresh=False):
    """``DEVICE_WINDOWS`` windows of :func:`device_window` as one entry of
    the JSON line: the mean device ms per call of all kernels and copies
    (``busy_ms``), their count (``kernels``), the mean of each kernel in
    ``names``, and the entry's metric per window (``windows_ms``: the sum
    of ``names`` if ``of_names``, else the busy time).  With ``fresh``,
    ``fn`` makes the function to profile, anew for every window, so that
    the windows of a state that changes as it runs cover the same steps."""
    runs = [device_window(fn() if fresh else fn, calls)
            for _ in range(DEVICE_WINDOWS)]
    per = [named(r[0], names) for r in runs]
    return {"busy_ms": statistics.mean(r[1] for r in runs),
            "kernels": statistics.mean(r[2] for r in runs),
            **{k: statistics.mean(p[k] for p in per) for k in names},
            "windows_ms": [sum(p.values()) if of_names else r[1]
                           for p, r in zip(per, runs)]}


def growth_w_wall_step(dev, n_cells, engine, links_seed):
    """A function that takes one step of the growth_w_wall loop
    (``Links.update``, then ``take_step`` with the link and wall forces)
    on a fresh half-space tissue of ``n_cells``."""
    from yalla_tpu_torch.links import Links, link_wall_forces
    from yalla_tpu_torch.models import growth_w_wall as W
    sol = W.half_space_solution(n_cells, engine, dev)
    links = Links(n_cells, W.protrusion_strength, seed=links_seed,
                  device=dev)
    links.set_d_n(sol.h_n)

    def step():
        links.update(W.update_protrusions_wall, sol)
        sol.take_step(W.dt, W.relu_force, pw_friction=W.wall_friction,
                      gen_forces=link_wall_forces(links, W.WALL))
    return step


def iwg_step(dev):
    """A function that takes one step of the intercalation_w_gradient
    example (rewiring, the Heun step with the link forces, divisions) from
    its initial state (``sphere_ic.vtk``, 11,557 cells in 151,552 rows)."""
    from yalla_tpu_torch.examples import intercalation_w_gradient as m
    sol = m.setup(dev)
    state = m.start(sol)
    return lambda: m.step(sol, state)


def _wall_ms(fn, calls):
    """Wall ms per call of ``fn`` in each of ``WALL_WINDOWS`` windows of
    ``calls`` calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(WALL_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / calls)
    return out


def _one(root):
    """The measurements of one tree, as a dict."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import yalla_tpu_torch
    assert Path(yalla_tpu_torch.__file__).resolve().is_relative_to(root)
    from yalla_tpu_torch import _build
    from yalla_tpu_torch.interop import (bench_config, bench_engine,
                                         load_settled)
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.models import sorting as S
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.central_mxu import central_pairwise_mxu
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas
    from yalla_tpu_torch.ops.lattice_xla import sort_by_cube
    from yalla_tpu_torch.ops.tile_pallas import tile_pairwise_pallas
    from yalla_tpu_torch.solvers import GabrielEngine, Solution, TileEngine
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    out = {"root": str(root), "card": card(),
           "build_s": time.perf_counter() - t0}
    cache = root / ".bench_cache"

    def solution(path, n, engine, cube_size, Cell, n_pad=None):
        X, ov = load_settled(path, Cell, dev)
        sol = Solution(Cell, n, engine=engine, cube_size=cube_size,
                       device=dev, n_pad=n_pad)
        sol.h_X = Cell(*(a.cpu().numpy() for a in X))
        sol.h_n = n
        sol.copy_to_device()
        sol.d_old_v = ov
        return sol

    # K1 and the 500k slice
    cfg = bench_config(root / "bench_state.json", "branching_500000")
    engine = bench_engine(cfg)
    cube, gs, C = float(cfg["cube"]), engine.grid_size, engine.capacity
    settled = cache / "settled_branching_500000_s0_v1.npz"
    X, ov = load_settled(settled, B.Cell, dev)
    out["k1"] = _k1_500k(root)
    cs = sort_by_cube(X, ov, 500_000, cube, gs, C)
    if hasattr(cs, "row_starts"):
        def pour():
            pour_pallas(cs.S, cs.row_starts, gs, C)
    else:            # trees whose pour took (S, n_slots)
        def pour():
            pour_pallas(cs.S, gs[0] * gs[1] * gs[2] * C)
    out["k2"] = _device_windows(pour, 20, ("pour_kernel",))
    del X, ov, cs
    out["step_500k"] = _step_500k(root)

    # K3 and the 5k slice on it
    sp = S.Params()
    settled5k = cache / "settled_sorting_p5120_5000_s0_v1.npz"
    X, ov = load_settled(settled5k, S.Cell, dev)
    adhesion = S.make_adhesion(sp)
    out["k3"] = _device_windows(lambda: tile_pairwise_pallas(
        adhesion, friction_w_neighbour, X, ov, 5000), 20, K3_KERNELS, True)
    central = S.make_adhesion_central(sp)
    out["k4"] = _device_windows(lambda: central_pairwise_mxu(
        central, friction_w_neighbour, X, ov, 5000), 20, K4_KERNELS, True)
    for tag, engine, force, names in (
            ("tile", TileEngine(pallas=True), adhesion, K3_KERNELS),
            ("central", TileEngine(mxu=True), central, K4_KERNELS)):
        sol = solution(settled5k, 5000, engine, sp.r_max, S.Cell,
                       n_pad=5120)

        def step5k():
            sol.take_steps(1, sp.dt, force)
        out[f"step_5k_{tag}"] = {**_device_windows(step5k, 20, names),
                                 "wall_ms": _wall_ms(step5k, 100)}
    del sol, X, ov

    # K5 and the 100k growth_w_wall slice.  The tissue contracts as it
    # runs (its busy time falls by a quarter in 10 steps, and the
    # candidate count nears NC after some 30), so every profiled window
    # and the wall windows start from a fresh tissue
    k5_kernels = ("gabriel_pair_kernel",)
    with gabriel_after_build(*gabriel_tissue(100_000, dev),
                             **GABRIEL_100K) as k5:
        out["k5"] = _device_windows(k5, 10, k5_kernels)
    engine = GabrielEngine(lattice=True, **GABRIEL_100K)
    out["step_100k"] = {
        **_device_windows(
            lambda: growth_w_wall_step(dev, 100_000, engine, 15), 3,
            k5_kernels, fresh=True),
        "wall_ms": _wall_ms(growth_w_wall_step(dev, 100_000, engine, 15),
                            3)}

    # the intercalation_w_gradient example at full width, each window
    # from its initial state (trees that have the example)
    if (root / "yalla_tpu_torch" / "examples"
            / "intercalation_w_gradient.py").exists():
        out["step_iwg"] = {
            **_device_windows(lambda: iwg_step(dev), 3,
                              ("lattice_pair_kernel", "indexFuncLargeIndex"),
                              fresh=True),
            "wall_ms": _wall_ms(iwg_step(dev), 5)}
    return out


def _k1_500k(root):
    """Device ms per pass of each K1 kernel on the settled 500k state at
    ``bench_state.json`` ``branching_500000`` (the tree at ``root``
    imported)."""
    import torch
    from yalla_tpu_torch.interop import (bench_config, bench_engine,
                                         load_settled)
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_pallas import lattice_pairwise_pallas
    from yalla_tpu_torch.ops.lattice_xla import lattice_build
    from yalla_tpu_torch.solvers import augment
    cfg = bench_config(root / "bench_state.json", "branching_500000")
    engine = bench_engine(cfg)
    cube, gs, C = float(cfg["cube"]), engine.grid_size, engine.capacity
    X, ov = load_settled(root / ".bench_cache" /
                         "settled_branching_500000_s0_v1.npz", B.Cell,
                         torch.device("cuda"))
    lay = lattice_build(X, ov, 500_000, cube, gs, C, engine.extras_cap)
    lay = lay._replace(T=augment(lay.T, 500_000, B.precompute),
                       E=augment(lay.E, 500_000, B.precompute))
    return _device_windows(lambda: lattice_pairwise_pallas(
        B.make_force(B.Params()), friction_w_neighbour, lay, 500_000, cube,
        grid_size=gs, capacity=C, z_block=engine.z_block,
        extras_block_cap=engine.extras_block_cap), 10, K1_KERNELS, True)


def _step_500k(root):
    """Device busy ms, kernels and wall ms per step of the 500k slice
    (``take_steps(1)`` on ``bench_state.json`` ``branching_500000``'s
    engine, the tree at ``root`` imported)."""
    import torch
    from yalla_tpu_torch.interop import (bench_config, bench_engine,
                                         load_settled)
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.solvers import Solution
    dev = torch.device("cuda")
    cfg = bench_config(root / "bench_state.json", "branching_500000")
    engine = bench_engine(cfg)
    X, ov = load_settled(root / ".bench_cache" /
                         "settled_branching_500000_s0_v1.npz", B.Cell, dev)
    sol = Solution(B.Cell, 500_000, engine=engine,
                   cube_size=float(cfg["cube"]), device=dev)
    sol.h_X = B.Cell(*(a.cpu().numpy() for a in X))
    sol.h_n = 500_000
    sol.copy_to_device()
    sol.d_old_v = ov
    force, dt = B.make_force(B.Params()), B.Params().dt

    def step():
        sol.take_steps(1, dt, force, precompute=B.precompute)
    return {**_device_windows(step, 4, K1_KERNELS),
            "wall_ms": _wall_ms(step, 10)}


def _k1(root):
    """Device ms of K1 on the 500k state, as a dict."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from yalla_tpu_torch import _build
    _build.library()
    return {"root": str(root), "card": card(), "k1": _k1_500k(root)}


def _k1_step(root):
    """Device ms of K1 on the 500k state and the 500k step's, as a
    dict."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from yalla_tpu_torch import _build
    _build.library()
    return {"root": str(root), "card": card(), "k1": _k1_500k(root),
            "step_500k": _step_500k(root)}


def _k1_xsplit(root):
    """Device ms of K1 on the thin x-cubes of the 500k state, as a dict
    (``k1_xsplit`` None where the tree's K1 has no ``x_split``)."""
    import inspect
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    from yalla_tpu_torch import _build
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_pallas import lattice_pairwise_pallas
    from yalla_tpu_torch.ops.lattice_xla import lattice_build
    from yalla_tpu_torch.solvers import augment
    _build.library()
    out = {"root": str(root), "card": card(), "k1_xsplit": None}
    if "x_split" not in inspect.signature(lattice_pairwise_pallas).parameters:
        return out
    e = THIN_500K
    X, ov = load_settled(root / ".bench_cache" /
                         "settled_branching_500000_s0_v1.npz", B.Cell,
                         torch.device("cuda"))
    lay = lattice_build(X, ov, 500_000, 1.0, e["grid_size"], e["capacity"],
                        e["extras_cap"], x_split=e["x_split"])
    lay = lay._replace(T=augment(lay.T, 500_000, B.precompute),
                       E=augment(lay.E, 500_000, B.precompute))
    out["k1_xsplit"] = _device_windows(lambda: lattice_pairwise_pallas(
        B.make_force(B.Params()), friction_w_neighbour, lay, 500_000, 1.0,
        grid_size=e["grid_size"], capacity=e["capacity"],
        z_block=e["z_block"], extras_block_cap=e["extras_block_cap"],
        x_split=e["x_split"]), 10, K1_KERNELS, True)
    return out


def _plans(root):
    """Device ms of K2, K4 and K5 at other launch plans than their own."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from unittest import mock

    import torch
    from yalla_tpu_torch.interop import (bench_config, bench_engine,
                                         load_settled)
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.models import sorting as S
    from yalla_tpu_torch.ops import (central_mxu, gabriel_pallas,
                                     lattice_pour)
    from yalla_tpu_torch.ops.common import friction_w_neighbour, grid_dims
    from yalla_tpu_torch.ops.lattice_xla import sort_by_cube
    from yalla_tpu_torch.ops.tile_pallas import TilePlan
    dev = torch.device("cuda")
    out = {"root": str(root), "card": card(), "k2": {}, "k4": {}, "k5": {}}
    cfg = bench_config(root / "bench_state.json", "branching_500000")
    engine = bench_engine(cfg)
    X, ov = load_settled(root / ".bench_cache" /
                         "settled_branching_500000_s0_v1.npz", B.Cell, dev)
    builds = {"500k": (sort_by_cube(X, ov, 500_000, float(cfg["cube"]),
                                    engine.grid_size, engine.capacity),
                       engine.grid_size, engine.capacity)}
    tissue = gabriel_tissue(100_000, dev)
    builds["100k"] = (sort_by_cube(*tissue, W.r_max, 48, 16), 48, 16)
    for tag, (cs, grid, C) in builds.items():
        gx, gy, gz = grid_dims(grid)
        ms = {}
        for rows in (1, 2, 4, 8):
            plan = (rows, -(-gy * gz // rows))
            with mock.patch.object(lattice_pour, "pour_plan",
                                   lambda *_, plan=plan: plan):
                ms[f"{rows * gx * C} slots"] = device_window(
                    lambda: lattice_pour.pour_pallas(cs.S, cs.row_starts,
                                                     grid, C), 20)[1]
        out["k2"][tag] = ms
    X, ov = load_settled(root / ".bench_cache" /
                         "settled_sorting_p5120_5000_s0_v1.npz", S.Cell, dev)
    central = S.make_adhesion_central(S.Params())
    for splits in (26, 52, 53, 66):
        chunk = -(-5000 // splits)
        plan = TilePlan(4, splits, chunk, (10, splits), (splits, 8, 5120))
        with mock.patch.object(central_mxu, "central_plan",
                               lambda *_, plan=plan: plan):
            per, _, _ = device_window(lambda: central_mxu.
                                      central_pairwise_mxu(
                                          central, friction_w_neighbour,
                                          X, ov, 5000), 20)
        out["k4"][f"{splits} splits"] = sum(named(per, K4_KERNELS).values())
    C, NC = GABRIEL_100K["capacity"], GABRIEL_100K["max_candidates"]
    for brick in ((2, 2, 4), (2, 4, 4), (4, 4, 4), (4, 4, 8), (4, 8, 8)):
        bz, by, bx = brick
        plan = gabriel_pallas.GabrielPlan(
            brick, gabriel_pallas.gabriel_smem_bytes(brick, C, NC),
            -(-48 // bz) * -(-48 // by) * -(-48 // bx))
        with mock.patch.object(gabriel_pallas, "gabriel_plan",
                               lambda *_, plan=plan: plan):
            with gabriel_after_build(*tissue, **GABRIEL_100K) as k5:
                out["k5"]["x".join(map(str, brick))] = device_window(k5,
                                                                     10)[1]
    return out


def _metrics(run):
    """{metric: list of values} of one run: the windows of each."""
    steps = [t for t in ("500k", "5k_tile", "5k_central", "100k", "iwg")
             if f"step_{t}" in run]
    kernels = [k for k in ("k1", "k2", "k3", "k4", "k5", "k1_xsplit")
               if run.get(k)]
    return {**{f"{k}_ms": run[k]["windows_ms"] for k in kernels},
            **{f"busy_{t}_ms": run[f"step_{t}"]["windows_ms"] for t in steps},
            **{f"wall_{t}_ms": run[f"step_{t}"]["wall_ms"] for t in steps}}


def verdicts(first, second):
    """{metric: "better" | "worse" | "unresolved"} of the runs of the
    second tree against those of the first, taken in pairs in order, for
    the metrics both trees have."""
    out = {}
    for m in _metrics(first[0]).keys() & _metrics(second[0]).keys():
        signs = set()
        for a, b in zip(first, second):
            va, vb = _metrics(a)[m], _metrics(b)[m]
            diff = statistics.median(vb) - statistics.median(va)
            spread = max(max(va) - min(va), max(vb) - min(vb))
            signs.add(0 if abs(diff) <= spread else (1 if diff > 0 else -1))
        out[m] = ("worse" if signs == {1} else "better" if signs == {-1}
                  else "unresolved")
    return out


def main(argv):
    if argv[:1] == ["--plans"]:
        print(json.dumps(_plans(argv[1] if len(argv) > 1 else
                                Path(__file__).resolve().parent.parent)))
        return
    ones = {"--one": _one, "--one-k1": _k1, "--one-k1-xsplit": _k1_xsplit,
            "--one-step-500k": _k1_step}
    if len(argv) >= 2 and argv[0] in ones:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("kernel_profile: no CUDA device")
        print(json.dumps(ones[argv[0]](argv[1])))
        return
    mode = "--one"
    if argv[:1] in (["--k1"], ["--k1-xsplit"], ["--step-500k"]):
        mode, argv = "--one" + argv[0][1:], argv[1:]
    roots = argv or [str(Path(__file__).resolve().parent.parent)]
    runs = []
    for root in roots:
        line = subprocess.run([sys.executable, __file__, mode, root],
                              check=True, stdout=subprocess.PIPE,
                              text=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    pair = roots[:2]
    if len(set(roots)) == 2 and len(roots) % 2 == 0 and \
            roots == pair * (len(roots) // 2):
        print(json.dumps({"card": runs[0]["card"], "first": pair[0],
                          "second": pair[1], "pairs": len(roots) // 2,
                          "verdicts": verdicts(runs[0::2], runs[1::2])}))


if __name__ == "__main__":
    main(sys.argv[1:])
