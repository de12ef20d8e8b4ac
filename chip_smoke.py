#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``yalla_tpu_torch/csrc`` and drives
the port's four paths: the flagship growing frame (proliferation, lineage,
Heun step, VTK output; phases 13 to 16 below), the branching model's Heun
step at 500k cells on
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
    cell-steps/s;
13. the all-pairs kernel (K3) with the ``inits_relu`` functor (the force
    the initial conditions relax under) against ``tile_pairwise`` on a
    500-point ``random_sphere(0.6, ...)``: the friction count exact, the
    forces and ``sum_v`` within ``compare_sums``'s tolerance; its device
    time per pass and its bound;
14. ``LatticeEngine.pairwise`` (a build with K2, the pair pass K1, the
    sums back in stable-id order, the extras merged) on the card against
    itself on the CPU, on the settled 600-cell state on the lattice the
    flagship starts on (``default_engine`` at the first tier: grid 24,
    C 16, a 4096-entry extras list): counters and flags exact, the other
    sums within ``compare_sums``'s tolerance;
15. the flagship from a seed: ``init_state(500, next_tier(500, 500000),
    seed=42)`` on the card (the relaxation on K3, the neighbour pre-pass
    on K1 and K2), then ``SEED_FRAMES`` frames of 11 substeps, each
    written by ``write_frame`` asynchronously into a temporary directory:
    every flag 0, ``n`` grows, one lineage node per division, the last
    file parses and holds ``n`` points, and a file queued before the state
    moved on holds the state as it was; then K2 and K1 against their plain
    versions as in phases 2 and 3, on that tier's lattice and the dividing
    tissue the frames left;
16. the flagship at full width: the settled 500k state as a ``State`` with
    a fresh lineage, re-padded to the rows of ``FULL_N_MAX`` cells (room
    for the divisions of the frames run), on
    ``default_engine(FULL_N_MAX, FULL_N_MAX)``; first K2 and K1 against
    their plain versions as in phases 2 and 3 at this lattice (grid 88,
    C 16, 10.9M slots: another brick plan and shared-memory size than the
    500k build's), with their times and bounds, the record's
    ``pour[flagship]`` and ``lattice_pair[flagship]``; ``FULL_FRAMES``
    frames of 11 substeps, one asynchronous ``write_frame`` each; a frame
    that flags
    is redone on ``engine_for_state``'s engine, as the example does, and
    that is printed; every flag 0 at the end.  Printed: the engine, the
    divisions, ms per frame and per substep, cell-steps/s, the seconds in
    ``write_frame`` and in ``drain`` (beside a frame with no writer at
    work and a file written synchronously), K1 and K2 launches per
    substep, the readbacks per frame (counted by
    ``torch.cuda.set_sync_debug_mode``), and a frame's device time and
    kernels by the profiler.

17. the all-pairs kernel (K3) with each all-pairs example's functor
    (``spring``, ``gradient_diffusion``, ``bending_layer``,
    ``relu_migration`` on migration's and on random_walk's state,
    ``wnt_diffusion``) against ``tile_pairwise`` on the example's own
    initial state at its published size (``setup`` on the card, a seeded
    old_v): the friction count exact, the source row's w exactly 0 in
    both (gradient, wnt), every dF field within ``RTOL`` of the plain
    value plus ``ATOL`` x max(1, max|plain|) plus ``COND`` of the row's
    sum of term magnitudes (at bending's cells on a polarity pole the phi
    force is a sum of terms of +-1.8e6 that comes to -4).  A gate that
    decided otherwise than the plain version (the band, the source, the
    migration dot products against +-0.15, wnt's r.w <= 0) would add a
    term of order 0.1, far past that.  Its wrapper and plain ms, device ms
    per pass (pair plus reduce) by the profiler, bound and share,
    registers and spills;
18. each all-pairs example from that initial state on the card against
    the same steps on the CPU: 2 steps (bending 1: its pole cells' phi is
    rounding noise from the second step on, and is left out), every field
    within the reference's ``isclose``; random_walk with the same draws;
19. the examples' path: each all-pairs example's ``run`` for ``EX_STEPS``
    steps at its published size, a VTK frame a step written into a
    temporary directory, the launch counts set to 0 just before and read
    just after: K3 launched twice a step and no other kernel, every flag
    0, the state finite; ms a step with its frame, and of ``EX_STEPS``
    more steps without output;
20. the six grid examples (``GridEngine``, plain torch operations) on the
    card at their published sizes for ``GRID_STEPS`` steps each: no
    kernel launched, every flag 0, the state finite, ms a step with its
    frames and without;
21. the lattice pair kernel (K1) with the ``intercalation_w_gradient``
    functor (16 channels: the example's fields and the seven polarity
    precompute channels, with old_v) against ``lattice_pairwise_plain``
    on the example's initial state (the 11,557 cells of
    ``examples/sphere_ic.vtk`` in 151,552 rows, on the example's lattice:
    grid 40, C 16): ``sum_f``, ``epi_nbs`` and
    ``mes_nbs`` exact, the rest within ``RTOL``, ``ATOL`` and ``COND`` as
    in phase 17; its plan beside branching's on that lattice (branching's
    plan of the 500k lattice unchanged), the work per cell, ms per pass of
    the wrapper and the plain version, device ms, bound and share,
    registers and spills (the branching functor's K1 is held against its
    plain version at its states in phases 3, 15 and 16, as before);
22. the intercalation_w_gradient example at full width: ``IWG_STEPS``
    steps of its ``step`` (rewiring, the Heun step with the link forces
    and the precompute, flags checked, divisions) after one warm-up, K1
    and K2 launched twice a step and no other kernel, the state finite;
    ms a step, the cells gained, device ms and kernels a step by the
    profiler, and ms a step of ``run`` with a VTK frame each step;
23. one step of that example from its initial state on the card and on
    the CPU with the same draws: links and divisions equal, every field
    within the reference's ``isclose`` (phi of the pole cells left out);
24. the other nine new examples (sorting, sorting_prot, intercalation,
    passive_growth, lineage_tracing, model_features_sequential_addition,
    growth_w_wall with K5, teapot, write_vtk_w_mask) from one initial
    state on the card against the CPU with the same draws: links and
    counts equal, every field within ``isclose`` after 2 steps, the same
    teapot points kept, the same masked VTK bytes;
25. their runs on the card at their published sizes, frames into a
    temporary directory, the launch counts set to 0 just before and read
    just after (growth_w_wall: K5 and K2 twice a step; the others none),
    flags 0, the state finite; ms a step with frames and without; the
    teapot's 70,000-point cut;
26. growth_w_wall from one relaxed state with the same draws on the
    gather Gabriel path and on K5 at C 16 and C 8 (the fullest cube each
    step, the flags of each run); then the published run, 501 steps with
    its frames through the example's entry points, flags 0 every step,
    with the fullest cube and the most candidates in reach;
27. thin x-cubes on the settled 500k state (``kernel_profile.THIN_500K``:
    half-width x-cubes, grid 128 x 64 x 64, C 5, ``x_split`` 2): K2 and
    K1 at an x reach of 2 cubes against their plain versions on its
    build, as in phases 2 and 3, with K1's plan, registers and spills
    (these checks run right after phase 3's); then ``N_STEPS`` steps
    through ``Solution.take_steps``, every flag 0, K1 and K2 launched
    twice a step (the record's ``lattice_pair[branching,x_split=2]``);
28. slot-space rebinning before every pass (``rebin_per_pass``, a mover
    list of ``REBIN_M_CAP``) at the main path's lattice and on phase 27's
    thin cubes, ``CADENCE_STEPS`` steps each: every flag 0,
    ``__err_rebin_overflow`` included, K1 twice a step and K2 once; the
    largest mover count and ms a step;
29. the resident cadence (``RESIDENT_500K``: a build every 4 steps, cube
    1.1, C 10, ``force_r_max`` 1.0), ``RESIDENT_STEPS`` steps through
    ``Solution.take_steps``, then the same rebinned per chunk: the
    staleness measures and ``__err_stale`` printed, every other flag 0;
    the gap deficit of the final state's per-cube extrema on the card
    and on the CPU, bit for bit;
30. those cadences on the settled 600-cell state against the CPU, 4
    steps each: a build every 4 steps with ``force_r_max``, rebinning per
    step and per pass, thin x-cubes, mover routing with extras, 300
    seeded links as a generic force; every field within ``isclose``,
    every flag equal;
31. K1 with ``z_halo`` on the settled 500k state at grid 64 and the
    smallest capacity that drops nothing, split into 2 and into 4
    z-slabs, the halo planes from the whole lattice: against its plain
    version (counters exact, the rest within ``compare_sums``'s
    tolerance), and each slab equal to the whole lattice's pass on it;
    device ms per slab pass, the bound from the slab's bytes and
    operations, registers and spills (the record's
    ``lattice_pair[branching,z_halo]``; these checks run right after
    phase 27's, early in the process);
32. the z-slab path at full width: ``lattice_sharded_heun_steps(
    pallas=True)`` on two ranks sharing the card (processes over gloo,
    CUDA tensors staged through host memory), the branching force on the
    settled 500k state, a build every 2 steps, ``ZSLAB_STEPS`` steps:
    every flag 0, K1 twice a step on a rank, positions within atol 5e-5
    of the single-process ``lattice_heun_steps``; ms a step beside the
    transport's; then the same run with ``pallas=False`` (JAX's default,
    which selects nothing on the slab path): every flag 0, K1 twice a
    step on a rank, every field equal to the ``pallas=True`` run's, its
    ms a step;
33. the cells-axis step on two ranks: ``make_sharded_step`` on the 5k
    sorting state with ``TileEngine`` (the windowed plain pass) against
    the single-process steps, every field within ``isclose``;
34. ``dryrun_multichip(2)`` and ``dryrun_multichip(4)`` on the card, K1
    launched in each z-slab frame (the third with ``pallas=False``);
35. the windowed Gabriel pass (``ops/grid_xla.gabriel_windowed``, plain
    torch on the card): (a) one pass at the 100k half-space tissue
    (``GABRIEL_100K``'s grid and NC, the JAX engine's window settings)
    against K5 and against the gather form, no kernel launched, every
    flag 0, the friction sums and shared flags exact, the other sums
    within ``compare_sums``'s tolerance; (b) ``RELAX_STEPS`` steps of the
    growth_w_wall example's relaxation engine (500 cells in 102,400 rows)
    windowed against gather: flags equal, positions within ``isclose``;
    ms a pass and a step of each form by CUDA events;
36. ``lattice_heun_steps(pallas=False)`` (the JAX package's XLA route,
    which has no overflow extras; the port runs it through K2 and K1 as
    it runs ``pallas=True``) on the settled 500k state at grid 64, the
    smallest capacity that drops nothing (phase 31's), cube 1.0, rebuild
    1, ``PLAIN_STEPS`` steps, against ``pallas=True`` with
    ``extras_cap=0`` at the same settings: ``extras_cap`` refused on
    ``pallas=False``, K1 and K2 twice a step on each route, flags equal
    and 0, positions within ``compare_sums``'s tolerance; ms a step of
    each.

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
N_SEEDS = 500
SEED_FRAMES = 5
SUBSTEPS = 11
FULL_N_MAX = 900_000
FULL_FRAMES = 2
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
                "central": OPS_DIST + 29, "wall_relu": OPS_DIST + 16,
                "inits_relu": OPS_DIST + 29}
# K5's midpoint test of one candidate against another (midpoint, three
# differences, products and sums, the compare)
OPS_MIDPOINT = 14
# the all-pairs examples (yalla_tpu_torch/examples): (K3 functor, example,
# the force that declares it), and the functor's struct in csrc/forces.cuh
EXAMPLES_K3 = (("spring", "springs", "spring"),
               ("gradient_diffusion", "gradient", "diffusion"),
               ("bending_layer", "bending", "layer_force"),
               ("relu_migration", "migration", "relu_w_migration"),
               ("relu_migration", "random_walk", "relu_w_migration"),
               ("wnt_diffusion", "wnt", "diffusion"))
FUNCTOR_STRUCTS = {"spring": "6Spring",
                   "gradient_diffusion": "GradientDiffusion",
                   "bending_layer": "BendingLayer",
                   "relu_migration": "ReluMigration",
                   "wnt_diffusion": "WntDiffusion"}
GRID_EXAMPLES = ("epithelium", "polarization", "apical_constriction",
                 "epithelia_double_polarity", "turing", "turing_w_noise")
# each grid example's force (epithelia_double_polarity: its second half's)
GRID_FORCES = {"epithelium": "layer_force", "polarization": "polarization",
               "apical_constriction": "constriction_force",
               "epithelia_double_polarity": "force_B",
               "turing": "epithelium_w_turing",
               "turing_w_noise": "epithelium_w_turing"}
EX_STEPS = 20
GRID_STEPS = 10
# an example's dF against plain: this much of the row's sum of term
# magnitudes on top of RTOL and ATOL (the rounding of a sum of up to ~12
# near terms taken in another order)
COND = 2e-6
# f32 operations per pair of the examples' functors, counted from
# csrc/forces.cuh (a libm call -- sinf, acosf, atan2f -- counted as one
# operation): on every pair beside OPS_DIST, the functor's ungated part
# with friction_w_neighbour; per pair within r_max (OPS_NEAR); per pair
# through wnt's r.w <= 0 gate; per pulled and per pushed migration pair
OPS_PER_PAIR.update({"spring": 20, "gradient_diffusion": 14,
                     "bending_layer": 9, "relu_migration": 9,
                     "wnt_diffusion": 9})
OPS_NEAR = {"gradient_diffusion": 0, "bending_layer": 110,
            "relu_migration": 47, "wnt_diffusion": 5}
OPS_WNT_ALIGN = 38
OPS_PULL, OPS_PUSH = 39, 42
# the lattice kernel's intercalation_w_gradient functor (csrc/forces.cuh
# IntercalationWGradient), beside OPS_DIST for every candidate: per pair
# in reach its distance again and its ungated part (friction, band,
# forces, counts); per pair with a mesenchymal i the diffusion of w and
# f; per pair of epithelial cells the bending
OPS_PER_PAIR["intercalation_w_gradient"] = OPS_DIST + 37
OPS_IWG_MES, OPS_IWG_BEND = 6, 62
# the intercalation_w_gradient example at full width: steps timed, and
# the steps of its GPU-against-CPU check
IWG_STEPS = 10
# steps of the growth_w_wall example on each engine of phase 26
GWW_STEPS = 14
# the extras sidecar's rows for phase 21's C 4 layout of the embryo (174
# of its cells overflow 4 a cube)
IWG_EXTRAS_CAP = 256
# phases 27-28's thin x-cubes on the 500k state are
# kernel_profile.THIN_500K
# phases 28-29: the rebin mover list (bench.py's rule at rebin_scale 2)
# and the steps of each timed rebin run
REBIN_M_CAP = 131_072
CADENCE_STEPS = 6
# phase 29: the resident cadence, cube 1.1 at C 10 (42 cells spill)
RESIDENT_500K = dict(grid_size=64, capacity=10, z_block=2, rebuild_every=4,
                     extras_cap=2048, extras_block_cap=24, force_r_max=1.0)
RESIDENT_CUBE = 1.1
RESIDENT_STEPS = 8
# phase 32: the z-slab path's steps, and its capacity above phase 31's
# (the smallest that drops nothing of the settled state) for the cells
# the steps move
ZSLAB_STEPS = 10
# phase 35 (b): steps of the growth_w_wall relaxation on each Gabriel form
RELAX_STEPS = 5
# phase 36: steps of lattice_heun_steps on each route
PLAIN_STEPS = 2
ZSLAB_HEADROOM = 2


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


def stencil_candidates(cube, gx, gy, gz, x_split=1, z_range=None):
    """Sum over the points of the live points in the cubes of each point's
    stencil (3 x 3 in z and y by 2 x_split + 1 in x: the candidates a
    lattice pass must test), itself included; with ``z_range`` (z0, z1)
    over the points of those planes only.  ``cube``: int64 cube ids of
    the live points."""
    import torch
    k = x_split
    counts = torch.bincount(cube, minlength=gx * gy * gz).reshape(
        gz, gy, gx).to(torch.float64)
    pad = torch.nn.functional.pad(counts, (k, k, 1, 1, 1, 1))
    near = sum(pad[dz:dz + gz, dy:dy + gy, dx:dx + gx]
               for dz in range(3) for dy in range(3)
               for dx in range(2 * k + 1))
    z0, z1 = z_range or (0, gz)
    return float((counts * near)[z0:z1].sum())


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


def lattice_kernel_checks(tag, X, old_v, n, cube, engine, plain_reps=2):
    """K2, then K1, against their plain versions on one build of the
    state's first ``n`` cells on ``engine``'s lattice, each with its
    times, its bound and (K2) its library calls.

    K2: the same bits in every slot; its wrapper's time, its device time
    (every kernel the wrapper launches) by the profiler, and beside them
    ``index_put_`` placing the same entries into a buffer zeroed once
    beforehand, and ``torch.zeros`` + ``index_put_`` (the zero fill is part
    of K2's function).  K1: ``sum_f``, ``epi_nbs`` and the extras flag
    exact, the other sums within ``compare_sums``'s tolerance.  Returns
    {"pour": record, "lattice_pair": record}, the keys of the kernels'
    JSON record that are measured here."""
    import torch
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import (cube_ids, friction_w_neighbour,
                                            grid_dims)
    from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                    lattice_pairwise_plain,
                                                    lattice_plan)
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas, pour_plain
    from yalla_tpu_torch.ops.lattice_xla import lattice_build, sort_by_cube
    from yalla_tpu_torch.solvers import augment
    dev = X.x.device
    gs, C, xs = engine.grid_size, engine.capacity, engine.x_split
    dims = grid_dims(gs)
    n_slots = dims[0] * dims[1] * dims[2] * C
    force = B.make_force(B.Params())

    # ---- K2: pour kernel against its plain version -----------------------
    cs = sort_by_cube(X, old_v, n, cube, gs, C, x_split=xs)
    pour_err = check_pour(tag, cs, gs, C)

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
    # outside the timing, and with the zero fill that K2's function
    # includes
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
        raise AssertionError(f"pour {tag}: index_put_ disagrees with plain")
    pour_bound = bound(nbytes(S) + nbytes(*want[:2]), 0)
    print(f"K2 pour per {tag} build: {pour_ms:.4f} ms/call (device "
          f"{pour_dev:.4f}, torch.profiler) vs plain {pour_plain_ms:.4f} "
          f"ms/call; index_put_ alone {pour_lib_ms:.4f} ms/call (device "
          f"{lib_dev:.4f}), torch.zeros + index_put_ {pour_fill_ms:.4f} "
          f"ms/call (device {fill_dev:.4f}); bound {pour_bound[0]:.4f} ms "
          f"({pour_bound[1]}), {100 * pour_bound[0] / pour_dev:.1f} % of "
          f"the device time")
    del lib_out, rows, dst, placed, want, S, cs

    # ---- K1: lattice pair kernel against its plain version ---------------
    lay = lattice_build(X, old_v, n, cube, gs, C, engine.extras_cap,
                        x_split=xs)
    lay = lay._replace(T=augment(lay.T, n, B.precompute),
                       E=augment(lay.E, n, B.precompute))
    kw = dict(grid_size=gs, capacity=C, z_block=engine.z_block,
              extras_block_cap=engine.extras_block_cap, x_split=xs)

    def k1():
        return lattice_pairwise_pallas(force, friction_w_neighbour, lay,
                                       n, cube, **kw)

    def k1_plain():
        return lattice_pairwise_plain(force, friction_w_neighbour, lay,
                                      n, cube, **kw)
    got, want = k1(), k1_plain()
    torch.cuda.synchronize()
    exact = {"sum_f", "epi_nbs", "E.sum_f", "E.epi_nbs",
             "E.__err_extras_block"}
    pair_err = max(
        compare_sums(f"K1 lattice {tag}", flatten(got, ""),
                     flatten(want, ""), exact),
        compare_sums(f"K1 extras {tag}", flatten(got[4], "E."),
                     flatten(want[4], "E."), exact))
    pair_ms = cuda_ms(k1, 10)
    pair_plain_ms = cuda_ms(k1_plain, plain_reps)
    # the work this layout needs: the live cells' 12 channels and the
    # occupancy read, 13 sums per slot and extra written; every live cell
    # of the 27 cubes tested for reach, the force on every pair in reach
    # (the friction sum counts them: cutoff and r_max are both 1)
    n_live = int((lay.pid < lay.slot_of.shape[0]).sum()) + int(lay.n_extras)
    live_cube = torch.cat([
        torch.nonzero(lay.pid < lay.slot_of.shape[0]).squeeze(1) // C,
        cube_ids(lay.E, engine.extras_cap, cube, gs, xs)[
            lay.epid < lay.slot_of.shape[0]]])
    in_reach = float(want[1].sum() + want[4][1].sum())
    candidates = stencil_candidates(live_cube, *dims, xs)
    pair_bound = bound(
        n_live * 12 * 4 + n_slots + (n_slots + engine.extras_cap) * 13 * 4,
        candidates * OPS_DIST + in_reach * OPS_PER_PAIR["branching"])
    print(f"K1 work on the {tag} build: {candidates / n_live:.2f} live "
          f"candidates (self included) and {in_reach / n_live:.2f} partners "
          f"in reach per cell, {n_live} cells in {n_slots} slots (grid "
          f"{gs}, C {C}, x_split {xs}, plan "
          f"{lattice_plan(dims, C, 12, xs)})")
    pair_dev = profiled_ms(k1, ["lattice_pair_kernel", "extras_pair_kernel"])
    print(f"K1 lattice pair on the {tag} build: {int(lay.n_extras)} live "
          f"extras, counters and flags exact, max abs err {pair_err:.3g} "
          f"(rtol {RTOL}, atol {ATOL} x max(1, max|plain|)); {pair_ms:.3f} "
          f"ms/pass vs plain {pair_plain_ms:.3f} ms/pass; bound "
          f"{pair_bound[0]:.4f} ms ({pair_bound[1]})")
    print(f"K1 device time per {tag} pass (torch.profiler): "
          f"{sum(pair_dev.values()):.4f} ms = " + " + ".join(
              f"{v:.4f} {k}" for k, v in pair_dev.items()))
    return {
        "pour": {"max_abs_err": pour_err, "ms": pour_ms,
                 "device_ms": pour_dev, "plain_ms": pour_plain_ms,
                 "bound_ms": pour_bound[0], "bound_by": pour_bound[1],
                 "library_ms": pour_lib_ms,
                 "library_with_fill_ms": pour_fill_ms},
        "lattice_pair": {"max_abs_err": pair_err, "ms": pair_ms,
                         "device_ms": sum(pair_dev.values()),
                         "plain_ms": pair_plain_ms,
                         "bound_ms": pair_bound[0],
                         "bound_by": pair_bound[1], "library_ms": None}}


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


KERNELS = ("pour", "lattice_pair", "central_pair", "tile_pair",
           "gabriel_pair")


def launch_counts():
    """Each ported kernel's launches since :func:`reset_launches`, by the
    kernel's name in the JSON record (the ``kernels.<name>`` counters of
    ``yalla_tpu_torch.utils.profiling``; :func:`main` runs traced)."""
    from yalla_tpu_torch.utils import profiling
    c = profiling.counters()
    return {k: c.get(f"kernels.{k}", 0) for k in KERNELS}


def run_slice(tag, sol, n_cells, n_steps, dt, force, expect,
              precompute=None):
    """One warm-up step, then ``n_steps`` steps with every launch count
    set to 0 just before and read just after.  Checks that every flag is
    0, the state is finite, and each kernel named in ``expect`` launched
    2 * n_steps times.  Returns (launches, ms/step, cell-steps/s)."""
    import numpy as np
    import torch
    sol.take_steps(1, dt, force, precompute=precompute)   # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = sol.take_steps(n_steps, dt, force, precompute=precompute)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = launch_counts()
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


def gabriel_bound(X, ov, n, got, kept, gs, C):
    """(bound ms, bound by, bytes, bytes of stable ids, operations) of one
    K5 pass on the state's first ``n`` points, with ``got`` its outputs
    and ``kept`` its kept pair ends.  The work this state needs: every
    live slot of the 27 cubes tested for reach, every within-reach
    candidate against every other (the midpoint test), the force on every
    kept pair.  The bytes: the occupancy as the lattice holds it, each
    cube's live stable ids and the empty slot that ends them (8 bytes
    each; a full cube has none), the live points' positions and old_v,
    and the 8 rows written (F, sum_f, sum_v and the candidate flag)."""
    import torch
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.common import cube_ids
    n_pad = X.x.shape[0]
    cand = torch.zeros(n, dtype=torch.float64, device=X.x.device)
    P = torch.stack([a[:n] for a in X], 1)
    for i0 in range(0, n, 1024):
        d2 = ((P[i0:i0 + 1024, None, :] - P[None, :, :]) ** 2).sum(-1)
        cand[i0:i0 + 1024] = (d2 < W.r_max ** 2).sum(1) - 1
    del P
    live_cube = cube_ids(X, n, W.r_max, gs)[:n]
    n_ops = stencil_candidates(live_cube, gs, gs, gs) * OPS_DIST + \
        float((cand ** 2).sum()) * OPS_MIDPOINT + \
        kept * OPS_PER_PAIR["wall_relu"]
    per_cube = torch.bincount(live_cube, minlength=gs ** 3)
    id_bytes = 8 * int(torch.clamp(per_cube + 1, max=C).sum())
    n_bytes = id_bytes + nbytes(*X, *ov) * n // n_pad + nbytes(
        *got[0], got[1], *got[2], got[3]["__err_gabriel_candidates"])
    return (*bound(n_bytes, n_ops), n_bytes, id_bytes, n_ops)


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
    gs, C = GABRIEL_100K["grid_size"], GABRIEL_100K["capacity"]
    bound_ms, bound_by, n_bytes, id_bytes, n_ops = gabriel_bound(
        X, ov, n, got, kept, gs, C)
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
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NG):
        aux = step()     # take_step raises on any __err_ flag
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    launches = launch_counts()
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


def reset_launches():
    """Set every kernel's launch count to 0."""
    from yalla_tpu_torch.utils import profiling
    profiling.clear()


def relax_kernel_check(dev):
    """Phase 13: K3 with the ``inits_relu`` functor against the plain
    all-pairs pass on a 500-point random ball.  Returns (max abs err, ms,
    plain ms, bound ms, bound by, device ms)."""
    import numpy as np
    import torch
    from yalla_tpu_torch import inits
    from yalla_tpu_torch.dtypes import Float3
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.tile_pallas import (tile_pairwise_pallas,
                                                 tile_pairwise_plain)
    from yalla_tpu_torch.solvers import Solution, TileEngine
    n = N_SEEDS
    sol = Solution(B.Cell, n, engine=TileEngine(), device=dev)
    inits.random_sphere(0.6, sol, rng=np.random.default_rng(42))
    X, n_pad = sol.d_X, sol.n_pad
    g = torch.Generator().manual_seed(1)
    ov = Float3(*(0.01 * torch.randn(n_pad, generator=g).to(dev)
                  for _ in range(3)))

    def k3():
        return tile_pairwise_pallas(inits.relu_force, friction_w_neighbour,
                                    X, ov, n)

    def plain():
        return tile_pairwise_plain(inits.relu_force, friction_w_neighbour,
                                   X, ov, n)
    got, want = k3(), plain()
    torch.cuda.synchronize()
    err = compare_sums("tile_pair inits_relu", flatten(got, "", n),
                       flatten(want, "", n), {"sum_f"})
    for f in B.Cell._fields[3:]:
        if getattr(got[0], f).any():
            raise AssertionError(f"tile_pair inits_relu: dF.{f} is not zero")
    ms, plain_ms = cuda_ms(k3, 50), cuda_ms(plain, 10)
    # x, y, z and old_v of the n points read, 7 sums per row written
    bound_ms, bound_by = bound(6 * 4 * n + 7 * 4 * n_pad,
                               n * (n - 1) * OPS_PER_PAIR["inits_relu"])
    per = profiled_ms(k3, ["tile_pair_kernel", "tile_reduce_kernel"], 20)
    dev_ms = sum(per.values())
    print(f"tile_pair with inits_relu on a {n}-point random_sphere(0.6) "
          f"({n_pad} rows): sum_f exact ({int(want[1][:n].sum())} pair ends "
          f"within 1), max abs err {err:.3g} (rtol {RTOL}, atol {ATOL} x "
          f"max(1, max|plain|)); {ms:.4f} ms/pass vs plain {plain_ms:.4f} "
          f"ms/pass; device {dev_ms:.4f} ms = " + " + ".join(
              f"{v:.4f} {k}" for k, v in per.items())
          + f"; bound {bound_ms:.6f} ms ({bound_by})")
    return err, ms, plain_ms, bound_ms, bound_by, dev_ms


def lattice_engine_gpu_vs_cpu(dev):
    """Phase 14: one pass of ``LatticeEngine.pairwise`` on the card against
    the same pass on the CPU (the plain versions), on the lattice the
    flagship starts on."""
    import torch
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.solvers import augment
    p = B.Params()
    engine = B.default_engine(N_SEEDS, B.next_tier(N_SEEDS, N_CELLS), p,
                              device=dev)
    force = B.make_force(p)
    outs = {}
    reset_launches()
    for d in ("cpu", dev):
        X, ov = load_settled(SETTLED_SMALL, B.Cell, d)
        outs[d] = flatten(engine.pairwise(
            force, friction_w_neighbour, augment(X, N_SMALL, B.precompute),
            ov, N_SMALL, p.r_max), "", N_SMALL)
    torch.cuda.synchronize()
    launched = launch_counts()
    if (launched["pour"], launched["lattice_pair"]) != (1, 1):
        raise AssertionError("LatticeEngine.pairwise on the card did not "
                             "launch K2 and K1 once each")
    flags = {k for k in outs[dev] if k.startswith("__err_")}
    got = {k: v.cpu() for k, v in outs[dev].items()}
    err = compare_sums("LatticeEngine.pairwise", got, outs["cpu"],
                       {"sum_f", "epi_nbs", "mes_nbs", *flags})
    if not outs["cpu"]["sum_f"].any():
        raise AssertionError("LatticeEngine.pairwise: no pair in reach")
    print(f"LatticeEngine.pairwise on the settled {N_SMALL}-cell state on "
          f"{engine}: card against CPU, sum_f, epi_nbs and flags "
          f"{sorted(flags)} exact, max abs err {err:.3g}")


def flagship_from_seed(dev):
    """Phase 15: the flagship from a seed, at the first tier.  Returns the
    launch counts of the whole phase (relaxation, pre-pass and frames)."""
    import tempfile

    import numpy as np
    import torch
    from yalla_tpu_torch.examples.branching import fused_errs
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.vtkio import Vtk_input, Vtk_output
    p = B.Params()
    tier = B.next_tier(N_SEEDS, N_CELLS)
    reset_launches()
    t0 = time.perf_counter()
    state, cells, engine = B.init_state(N_SEEDS, tier, p, seed=42,
                                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = launch_counts()
    if init_launches["tile_pair"] < 2000 or init_launches["pour"] != 2 \
            or init_launches["lattice_pair"] != 2:
        raise AssertionError(f"init_state launches: {init_launches}")
    n_epi = int(state.X.ctype.sum())
    if not 0 < n_epi < N_SEEDS:
        raise AssertionError(f"init_state: {n_epi} epithelial cells")
    frame = B.make_frame(p, engine, substeps=SUBSTEPS)
    counts = [state.n]
    with tempfile.TemporaryDirectory() as tmp:
        with Vtk_output("branching", tmp, verbose=False,
                        async_write=True) as output:
            t0 = time.perf_counter()
            for t in range(SEED_FRAMES):
                cells.d_X, cells.d_old_v, cells.d_n = \
                    state.X, state.old_v, state.n
                output.write_frame(
                    cells, polarity=True, fields=("u", "v"),
                    properties=(("type", state.X.ctype, np.int32),
                                ("cell_clone", state.lineage.cell_clone,
                                 np.int32)))
                # the worker may still hold this frame when the state moves
                # on: its file must hold the state as it was
                held = state
                state, errs = frame(state, t / SEED_FRAMES)
                bad, flags = fused_errs(errs)
                if bad:
                    raise AssertionError(f"flagship from a seed, frame {t}: "
                                         f"flags set: {flags}")
                counts.append(state.n)
            torch.cuda.synchronize()
            frames_s = time.perf_counter() - t0
        last = Vtk_input(f"{tmp}/branching_{SEED_FRAMES - 1}.vtk")
        back = type(cells)(B.Cell, tier, engine=engine, device="cpu")
        last.read_positions(back)
        last.read_field(back, "u")
    launches = launch_counts()
    n = state.n
    if not all(b >= a for a, b in zip(counts, counts[1:])) or n <= N_SEEDS:
        raise AssertionError(f"flagship from a seed: counts {counts}")
    if state.lineage.n_nodes != n - N_SEEDS:
        raise AssertionError(f"flagship from a seed: {state.lineage.n_nodes} "
                             f"lineage nodes for {n - N_SEEDS} divisions")
    if last.n_points != held.n:
        raise AssertionError(f"the last VTK file holds {last.n_points} "
                             f"points, the state it was written from "
                             f"{held.n}")
    for f in ("x", "y", "z", "u"):
        a = getattr(back.h_X, f)[:held.n]
        b = getattr(held.X, f)[:held.n].cpu().numpy()
        if not np.allclose(a, b, rtol=1e-6, atol=0):
            raise AssertionError(f"the last VTK file's {f} is not the "
                                 f"state's it was written from")
    if not torch.isfinite(torch.stack(list(state.X))).all():
        raise AssertionError("flagship from a seed: state not finite")
    per_sub = SEED_FRAMES * SUBSTEPS
    expect = init_launches["pour"] + 2 * per_sub
    if launches["pour"] != expect or launches["lattice_pair"] != expect:
        raise AssertionError(f"flagship from a seed: launches {launches}, "
                             f"expected {expect} of K1 and K2")
    print(f"flagship from a seed: init_state({N_SEEDS}, {tier}, seed=42) in "
          f"{init_s:.2f} s ({n_epi} epithelial cells; launches "
          f"{init_launches}), engine {engine}; {SEED_FRAMES} frames x "
          f"{SUBSTEPS} substeps with async write_frame in {frames_s:.2f} s "
          f"({1e3 * frames_s / per_sub:.2f} ms/substep): n {counts}, "
          f"{state.lineage.n_nodes} lineage nodes, every flag 0, the last "
          f"file holds {last.n_points} points as written; launches "
          f"{launches}")
    # K2 and K1 against their plain versions on this tier's lattice, on the
    # dividing tissue the frames left
    lattice_kernel_checks("first-tier", state.X, state.old_v, state.n,
                          p.r_max, engine)
    return launches


def full_width_state(dev, n_pad):
    """The settled 500k state as a flagship ``State`` of ``n_pad`` rows
    with a fresh lineage."""
    import torch
    from yalla_tpu_torch.growth import lineage_init
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    X, old_v = load_settled(SETTLED, B.Cell, dev)
    rows = X.x.shape[0]
    key = torch.Generator(device=dev)
    key.manual_seed(0)
    state = B.State(X=X, old_v=old_v, n=N_CELLS,
                    lineage=lineage_init(2 * n_pad, rows, N_CELLS,
                                         device=dev),
                    epi_nbs=torch.zeros(rows, device=dev),
                    mes_nbs=torch.zeros(rows, device=dev), key=key)
    return B.repad_state(state, n_pad)


def count_readbacks(fn):
    """The synchronizing calls ``fn`` makes on the host, as
    ``torch.cuda.set_sync_debug_mode`` warns of them."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def flagship_full_width(dev):
    """Phase 16: the flagship frame at full width.  Returns the launch
    counts of its measured frames, and its lattice's kernel checks."""
    import tempfile

    import numpy as np
    import torch
    from yalla_tpu_torch.examples.branching import fused_errs
    from yalla_tpu_torch.kernel_profile import card, device_window, named
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.solvers import Solution, _pad_size
    from yalla_tpu_torch.vtkio import Vtk_input, Vtk_output
    p = B.Params()
    n_pad = _pad_size(FULL_N_MAX)
    engine = B.default_engine(FULL_N_MAX, FULL_N_MAX, p, device=dev)
    state = full_width_state(dev, n_pad)
    cells = Solution(B.Cell, FULL_N_MAX, engine=engine, cube_size=p.r_max,
                     device=dev)
    assert cells.n_pad == n_pad == state.X.x.shape[0]
    frame = B.make_frame(p, engine, substeps=SUBSTEPS)
    print(f"flagship at full width: {state.n} cells in {n_pad} rows (room "
          f"for {FULL_N_MAX}), engine {engine}")
    # K2 and K1 against their plain versions at this path's shapes
    checks = lattice_kernel_checks("full-width", state.X, state.old_v,
                                   state.n, p.r_max, engine, plain_reps=1)

    # a frame's device time and kernels (the frame leaves the state it is
    # given as it was, so it can be taken again), then its readbacks
    per, busy_ms, n_kernels = device_window(lambda: frame(state, 0.0), 1)
    pair = named(per, ["lattice_pair_kernel", "extras_pair_kernel",
                       "pour_kernel"])

    def one_frame():
        fused_errs(frame(state, 0.0)[1])
    readbacks = count_readbacks(one_frame)

    def write(output, state):
        """Queue (or, synchronously, write) the state's frame; returns the
        seconds the call took."""
        cells.d_X, cells.d_old_v, cells.d_n = state.X, state.old_v, state.n
        w0 = time.perf_counter()
        output.write_frame(
            cells, polarity=True, fields=("u", "v"),
            properties=(("type", state.X.ctype, np.int32),
                        ("cell_clone", state.lineage.cell_clone, np.int32)))
        return time.perf_counter() - w0

    # beside the measured frames: a frame with no writer at work, and a
    # frame's file written synchronously (what the worker thread hides)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_frame()
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        with Vtk_output("sync", tmp, verbose=False) as output:
            sync_write_s = write(output, state)

    reset_launches()
    counts, resized = [state.n], 0
    write_s = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        with Vtk_output("branching", tmp, verbose=False,
                        async_write=True) as output:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(FULL_FRAMES):
                write_s += write(output, state)
                prev = state
                state, errs = frame(prev, t / FULL_FRAMES)
                bad, flags = fused_errs(errs)
                if bad:
                    engine = B.engine_for_state(prev, FULL_N_MAX, p)
                    resized += 1
                    print(f"flagship at full width: frame {t} flagged "
                          f"{ {k: v for k, v in flags.items() if v} }; redone "
                          f"on {engine}")
                    frame = B.make_frame(p, engine, substeps=SUBSTEPS)
                    state, errs = frame(prev, t / FULL_FRAMES)
                    bad, flags = fused_errs(errs)
                if bad:
                    raise AssertionError(f"flagship at full width, frame "
                                         f"{t}: flags set: {flags}")
                counts.append(state.n)
            torch.cuda.synchronize()
            frames_s = time.perf_counter() - t0
            d0 = time.perf_counter()
            output.drain()
            drain_s = time.perf_counter() - d0
        last = Vtk_input(f"{tmp}/branching_{FULL_FRAMES - 1}.vtk")
        size_mb = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 1e6
    launches = launch_counts()
    if last.n_points != counts[-2]:
        raise AssertionError(f"the last VTK file holds {last.n_points} "
                             f"points, its state {counts[-2]}")
    if state.lineage.n_nodes != state.n - N_CELLS:
        raise AssertionError(f"{state.lineage.n_nodes} lineage nodes for "
                             f"{state.n - N_CELLS} divisions")
    if not torch.isfinite(torch.stack(list(state.X))).all():
        raise AssertionError("flagship at full width: state not finite")
    substeps = FULL_FRAMES * SUBSTEPS
    runs = substeps + resized * SUBSTEPS      # a redone frame ran twice
    if launches["pour"] != 2 * runs or launches["lattice_pair"] != 2 * runs:
        raise AssertionError(f"flagship at full width: launches {launches} "
                             f"in {runs} substeps")
    if len(readbacks) != SUBSTEPS + 1:
        raise AssertionError(f"a frame made {len(readbacks)} readbacks, "
                             f"expected {SUBSTEPS + 1}: {readbacks}")
    cell_steps = SUBSTEPS * sum(counts[:-1])
    print(f"flagship at full width on {card()}: {FULL_FRAMES} frames x "
          f"{SUBSTEPS} substeps, n {counts} ({state.n - N_CELLS} divisions, "
          f"{state.lineage.n_nodes} lineage nodes), every flag 0, "
          f"{resized} engine resizes; {1e3 * frames_s / FULL_FRAMES:.1f} "
          f"ms/frame, {1e3 * frames_s / runs:.2f} ms/substep, "
          f"{cell_steps / frames_s:.6g} cell-steps/s with the writes "
          f"queued; write_frame {write_s:.4f} s for {FULL_FRAMES} calls, "
          f"drain {drain_s:.3f} s, {size_mb:.1f} MB written (a frame with "
          f"no writer at work: {1e3 * alone_s:.1f} ms; the first frame's "
          f"file written synchronously: {sync_write_s:.3f} s); K1 and K2 "
          f"{launches['lattice_pair'] / runs:g} and "
          f"{launches['pour'] / runs:g} launches per substep; "
          f"{len(readbacks)} readbacks per frame")
    print(f"flagship frame from the settled state (torch.profiler): device "
          f"{busy_ms:.2f} ms and {n_kernels:g} kernels per frame, "
          f"{busy_ms / SUBSTEPS:.3f} ms and {n_kernels / SUBSTEPS:.0f} per "
          f"substep; of it " + ", ".join(f"{v:.3f} ms {k}"
                                         for k, v in pair.items()))
    return launches, checks


def example_states(dev):
    """Each all-pairs example's initial state on the card: {example:
    (module, Solution)}, from its ``setup`` with the initial conditions'
    generator seeded (the relaxations of migration and random_walk run
    on K3's ``inits_relu``)."""
    import importlib

    from yalla_tpu_torch import inits
    out = {}
    for _, name, _ in EXAMPLES_K3:
        m = importlib.import_module(f"yalla_tpu_torch.examples.{name}")
        inits.set_seed(0)
        out[name] = (m, m.setup(dev))
    return out


def example_ops(functor, X, n, m):
    """(f32 operations, pairs within r_max) of one K3 pass of an example's
    functor on the state ``X``: every pair's distance and ungated terms,
    and the terms of the pairs that this state's data lets through each
    gate (``OPS_*``)."""
    import torch
    from yalla_tpu_torch.dtypes import Polarity
    from yalla_tpu_torch.polarity import pol_dot_product, pt_to_pol
    Xi = type(X)(*(a[:n, None] for a in X))
    r = Xi - type(X)(*(a[None, :n] for a in X))
    dist = torch.sqrt(r.x * r.x + r.y * r.y + r.z * r.z)
    ops = n * (n - 1) * (OPS_DIST + OPS_PER_PAIR[functor])
    if functor not in OPS_NEAR:
        return ops, 0
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    near = (dist <= m.r_max) & ~eye
    ops += int(near.sum()) * OPS_NEAR[functor]
    if functor == "wnt_diffusion":
        ops += int((near & (r.w <= 0)).sum()) * OPS_WNT_ALIGN
    if functor == "relu_migration":
        r_hat = pt_to_pol(r, torch.where(near, dist, 1.0))
        pull = near & ((Xi.phi != 0) | (Xi.theta != 0)) \
            & (pol_dot_product(Xi, r_hat) <= -0.15)
        pj = Polarity(Xi.theta - r.theta, Xi.phi - r.phi)
        push = near & ((pj.phi > 1e-10) | (pj.theta > 1e-10)) \
            & (pol_dot_product(pj, r_hat) >= 0.15)
        ops += int(pull.sum()) * OPS_PULL + int(push.sum()) * OPS_PUSH
    return ops, int(near.sum())


def example_kernel_checks(dev, states):
    """Phase 17: K3 with each example's functor against the plain all-pairs
    pass on the example's initial state.  Returns {functor: (max abs
    err, ms, plain ms, bound ms, bound by, device ms)}, each functor at
    its first example's state."""
    import torch
    from yalla_tpu_torch.dtypes import Float3
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.functors import PAIR_FUNCTORS
    from yalla_tpu_torch.ops.tile_pallas import (tile_pairwise_pallas,
                                                 tile_pairwise_plain)
    out = {}
    for functor, name, force_name in EXAMPLES_K3:
        m, sol = states[name]
        force = getattr(m, force_name)
        X, n, n_pad = sol.d_X, sol.d_n, sol.n_pad
        g = torch.Generator().manual_seed(1)
        ov = Float3(*(0.01 * torch.randn(n_pad, generator=g).to(dev)
                      for _ in range(3)))

        def k3(force=force, X=X, ov=ov, n=n):
            return tile_pairwise_pallas(force, friction_w_neighbour, X, ov,
                                        n)

        def plain(force=force, X=X, ov=ov, n=n):
            return tile_pairwise_plain(force, friction_w_neighbour, X, ov, n)

        def magnitudes(force=force, X=X, ov=ov, n=n):
            def mag(*args):
                dF = force(*args)
                return type(dF)(*(a.abs() for a in dF))
            return tile_pairwise_plain(mag, friction_w_neighbour, X, ov, n)
        got, want, mags = k3(), plain(), magnitudes()[0]
        torch.cuda.synchronize()
        tag = f"tile_pair[{functor}] on {name}"
        if not torch.equal(got[1][:n], want[1][:n]):
            raise AssertionError(f"{tag}: sum_f differs")
        err = max(float((a - b)[:n].abs().max()) for a, b in
                  zip(list(got[0]) + list(got[2]),
                      list(want[0]) + list(want[2])))
        for f, a, b, c in zip(X._fields, got[0], want[0], mags):
            a, b, c = a[:n], b[:n], c[:n]
            tol = RTOL * b.abs() + ATOL * max(1.0, float(b.abs().max())) \
                + COND * c
            if not bool(((a - b).abs() <= tol).all()):
                raise AssertionError(f"{tag} F.{f}: kernel and plain "
                                     f"disagree (max abs err "
                                     f"{float((a - b).abs().max()):g})")
        for a, b in zip(got[2], want[2]):
            a, b = a[:n], b[:n]
            if not bool(((a - b).abs() <= RTOL * b.abs() + ATOL).all()):
                raise AssertionError(f"{tag}: sum_v disagrees")
        if hasattr(m, "SOURCE") and (float(got[0].w[m.SOURCE]) != 0.0
                                     or float(want[0].w[m.SOURCE]) != 0.0):
            raise AssertionError(f"{tag}: the source row's w moved")
        ms, plain_ms = cuda_ms(k3, 50), cuda_ms(plain, 5)
        spec = PAIR_FUNCTORS[functor]
        sums = len(spec["dF"]) + 4
        ops, near = example_ops(functor, X, n, m)
        bound_ms, bound_by = bound(
            (len(spec["fields"]) + 3) * 4 * n + sums * 4 * n_pad, ops)
        per = profiled_ms(k3, ["tile_pair_kernel", "tile_reduce_kernel"],
                          20)
        dev_ms = sum(per.values())
        print(f"{tag} ({n} cells in {n_pad} rows, {near} pairs within "
              f"r_max): sum_f exact ({int(want[1][:n].sum())} pair ends "
              f"within 1), max abs err {err:.3g} (rtol {RTOL}, atol {ATOL} "
              f"x max(1, max|plain|) + {COND} x sum|terms|); {ms:.4f} "
              f"ms/pass vs plain {plain_ms:.4f}; device {dev_ms:.4f} ms = "
              + " + ".join(f"{v:.4f} {k}" for k, v in per.items())
              + f"; bound {bound_ms:.6f} ms ({bound_by}, {ops} operations),"
              f" share {bound_ms / dev_ms:.2%}")
        rec = (err, ms, plain_ms, bound_ms, bound_by, dev_ms)
        if functor in out:   # the second state of a functor: keep the worst
            rec = (max(err, out[functor][0]),) + out[functor][1:]
        out[functor] = rec
    ptxas_report(list(FUNCTOR_STRUCTS.values()))
    return out


def iwg_kernel_check(dev):
    """Phase 21: K1 with the ``intercalation_w_gradient`` functor against
    ``lattice_pairwise_plain`` on the example's initial state (the
    11,557-cell embryo of ``sphere_ic.vtk`` in 151,552 rows, the
    example's lattice, a seeded old_v), the 16 channels the
    example's augmented state gives the build; then the same cells at C 4
    with an extras sidecar of ``IWG_EXTRAS_CAP`` rows.  Exact, in the
    lattice's slots and in the extras' rows: ``sum_f``, ``epi_nbs``,
    ``mes_nbs`` and every ``__err_*`` flag (the same keys on both sides;
    the build's dropped and out-of-grid counts beside them, 0 on the
    example's lattice); the other sums within ``RTOL`` of the plain
    value plus ``ATOL`` x max(1, max|plain|) plus ``COND`` of the slot's
    sum of term magnitudes (phi's bending term divides by sin theta).
    Prints the plan (beside branching's on the same lattice), the work,
    ms per pass of the wrapper and the plain version, the device time by
    the profiler, the bound, registers and spills.  First K2 on the same
    build (20 rows: the augmented fields, old_v, id and target) against
    its plain version, bit for bit, and its device time.  Returns the
    kernel's record."""
    import torch
    from yalla_tpu_torch.dtypes import Float3
    from yalla_tpu_torch.examples import intercalation_w_gradient as m
    from yalla_tpu_torch.ops.common import (friction_w_neighbour,
                                            grid_dims)
    from yalla_tpu_torch.ops.functors import PAIR_FUNCTORS
    from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                    lattice_pairwise_plain,
                                                    lattice_plan)
    from yalla_tpu_torch.ops.lattice_pour import pour_pallas
    from yalla_tpu_torch.ops.lattice_xla import lattice_build, sort_by_cube
    from yalla_tpu_torch.solvers import augment
    sol = m.setup(dev)
    sol._ensure_device()
    e, n, cube = sol.engine, sol.d_n, sol.cube_size
    gs, C = e.grid_size, e.capacity
    dims = grid_dims(gs)
    n_slots = dims[0] * dims[1] * dims[2] * C
    n_chans = len(PAIR_FUNCTORS["intercalation_w_gradient"]["fields"]) + 3
    plan = lattice_plan(dims, C, n_chans)
    if tuple(lattice_plan(64, 8, 12)) != ((2, 4, 8), 113_316, 4096):
        raise AssertionError("the branching plan of the 500k lattice moved")
    print(f"K1 intercalation_w_gradient: {n} cells in {sol.n_pad} rows, "
          f"engine {e}; plan {plan} at {n_chans} channels (branching's at "
          f"12 on this lattice: {lattice_plan(dims, C, 12)})")
    g = torch.Generator().manual_seed(2)
    ov = Float3(*(0.01 * torch.randn(sol.n_pad, generator=g).to(dev)
                  for _ in range(3)))
    X = augment(sol.d_X, n, m.polarity_precompute)
    # K2 on this build: 15 fields, old_v, the id and the target (K 20)
    cs = sort_by_cube(X, ov, n, cube, gs, C)
    check_pour(f"intercalation_w_gradient (K {cs.S.shape[0]})", cs, gs, C)
    pour_dev = device_ms(lambda: pour_pallas(cs.S, cs.row_starts, gs, C))
    print(f"K2 pour device time per intercalation_w_gradient build "
          f"(torch.profiler): {pour_dev:.4f} ms")
    del cs
    tag = "K1 lattice_pair[intercalation_w_gradient]"

    def mag(*args):
        dF, aux = m.force(*args)
        return type(dF)(*(a.abs() for a in dF)), aux

    def compare(label, lay, kw):
        """The kernel against the plain version on one layout: (max abs
        err, {flag: sum})."""
        def run(force, fn):
            return fn(force, friction_w_neighbour, lay, n, cube, **kw)
        got = run(m.force, lattice_pairwise_pallas)
        want = run(m.force, lattice_pairwise_plain)
        mag_outs = run(mag, lattice_pairwise_plain)
        torch.cuda.synchronize()
        if len(got) != len(want):
            raise AssertionError(f"{tag} {label}: {len(got)} outputs "
                                 f"against {len(want)}")
        # the build's flags, then the lattice's slots and the extras
        # sidecar's rows: epi_nbs, mes_nbs, sum_f and every flag exact
        flags = {"__err_lattice_dropped": float(lay.n_dropped),
                 "__err_out_of_grid": float(lay.n_oob)}
        parts = [("", got, want, mag_outs[0])]
        if len(want) == 5:
            parts.append(("E.", got[4], want[4], mag_outs[4][0]))
        err = 0.0
        for part, g_out, w_out, mags in parts:
            if g_out[3].keys() != w_out[3].keys():
                raise AssertionError(f"{tag} {label} {part}aux: keys "
                                     f"{sorted(g_out[3])} against "
                                     f"{sorted(w_out[3])}")
            for k in w_out[3]:
                if not torch.equal(g_out[3][k], w_out[3][k]):
                    raise AssertionError(f"{tag} {label}: {part}{k} "
                                         f"differs")
                if k.startswith("__err_"):
                    flags[part + k] = float(g_out[3][k].sum())
            if not torch.equal(g_out[1], w_out[1]):
                raise AssertionError(f"{tag} {label}: {part}sum_f differs")
            for f, x, y, c in zip(w_out[0]._fields, g_out[0], w_out[0],
                                  mags):
                tol = RTOL * y.abs() \
                    + ATOL * max(1.0, float(y.abs().max())) + COND * c
                bad = (x - y).abs() > tol
                err = max(err, float((x - y).abs().max()))
                if bool(bad.any()):
                    raise AssertionError(
                        f"{tag} {label} {part}F.{f}: kernel and plain "
                        f"disagree (max abs err "
                        f"{float((x - y).abs().max()):g})")
            err = max(err, compare_sums(
                f"{tag} {label} {part}sum_v",
                {f"v{c}": x for c, x in enumerate(g_out[2])},
                {f"v{c}": x for c, x in enumerate(w_out[2])}, set()))
        return err, flags

    # the example's lattice, no cell dropped; then the same cells at C
    # 4 with an extras sidecar (the IC's fullest cubes hold 6), so that
    # the extras' rows and their flag are held as well
    lay = lattice_build(X, ov, n, cube, gs, C, e.extras_cap)
    if int(lay.n_dropped) or int(lay.n_oob):
        raise AssertionError("K1 intercalation_w_gradient: the build "
                             "dropped cells")
    kw = dict(grid_size=gs, capacity=C, z_block=e.z_block,
              extras_block_cap=e.extras_block_cap)
    err, flags = compare(f"C {C}", lay, kw)
    lay4 = lattice_build(X, ov, n, cube, gs, 4, IWG_EXTRAS_CAP)
    err4, flags4 = compare("C 4 + extras", lay4, dict(kw, capacity=4))
    print(f"{tag} at C 4 with extras ({int(lay4.n_extras)} cells in the "
          f"sidecar, extras_cap {IWG_EXTRAS_CAP}): sum_f, epi_nbs, "
          f"mes_nbs and the flags {flags4} exact, max abs err {err4:.3g}")
    if "E.__err_extras_block" not in flags4 or any(flags.values()):
        raise AssertionError(f"{tag}: flags {flags} at C {C}, {flags4} at "
                             f"C 4")
    del lay4

    def k1():
        return lattice_pairwise_pallas(m.force, friction_w_neighbour, lay, n,
                                       cube, **kw)

    def plain(force=m.force):
        return lattice_pairwise_plain(force, friction_w_neighbour, lay, n,
                                      cube, **kw)
    want = plain()
    ms, plain_ms = cuda_ms(k1, 20), cuda_ms(plain, 3)
    per = profiled_ms(k1, ["lattice_pair_kernel"], 20)
    dev_ms = sum(per.values())
    # the work this layout needs: the live cells' 16 channels and the
    # occupancy read, 13 sums per slot written; every live cell of the 27
    # cubes tested for reach, every pair in reach (the friction sum counts
    # them) its ungated part, the pairs with a mesenchymal i their
    # diffusion, the epithelial pairs their bending
    live = lay.pid < lay.slot_of.shape[0]
    n_live = int(live.sum())
    candidates = stencil_candidates(
        torch.nonzero(live).squeeze(1) // C, *dims)
    in_reach = float(want[1].sum())
    mes_pairs = float((want[1] * (lay.T.ctype == 0) * live).sum())
    epi_pairs = float((want[3]["epi_nbs"] * (lay.T.ctype == 1)).sum())
    ops = candidates * OPS_DIST \
        + in_reach * OPS_PER_PAIR["intercalation_w_gradient"] \
        + mes_pairs * OPS_IWG_MES + epi_pairs * OPS_IWG_BEND
    bound_ms, bound_by = bound(n_live * n_chans * 4 + n_slots
                               + n_slots * 13 * 4, ops)
    print(f"{tag}: {candidates / n_live:.2f} live candidates and "
          f"{in_reach / n_live:.2f} partners in reach per cell "
          f"({mes_pairs:g} pairs with a mesenchymal i, {epi_pairs:g} "
          f"epithelial pairs); sum_f, epi_nbs, mes_nbs and the flags "
          f"{flags} exact, max abs err "
          f"{err:.3g} (rtol {RTOL}, atol {ATOL} x max(1, max|plain|) + "
          f"{COND} x sum|terms|); {ms:.4f} ms/pass vs plain {plain_ms:.4f}; "
          f"device {dev_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}, "
          f"{ops:.4g} operations), share {bound_ms / dev_ms:.2%}")
    ptxas_report(["IntercalationWGradient"])
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def to_device(draws, device):
    """Randoms (None, a tensor or a tuple of them, nested) on
    ``device``."""
    import torch
    if draws is None:
        return None
    if torch.is_tensor(draws):
        return draws.to(device)
    moved = [to_device(d, device) for d in draws]
    return type(draws)(*moved) if hasattr(draws, "_fields") \
        else tuple(moved)


def iwg_full_width(dev):
    """Phase 22: the intercalation_w_gradient example at full width on the
    card: ``setup`` (the 11,557 cells of ``sphere_ic.vtk`` in 151,552
    rows on the example's lattice), one warm-up step, then
    ``IWG_STEPS`` steps of ``step`` (rewiring, the Heun step with the link
    forces, its flags checked, divisions) with the launch counts set to 0
    just before and read just after: K1 and K2 launched twice a step, no
    other kernel, the state finite.  Prints ms a step, the cells gained,
    the device time and kernels a step by the profiler, and ms a step of
    ``run`` with its VTK frame a step.  Returns the launches."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from yalla_tpu_torch.examples import intercalation_w_gradient as m
    from yalla_tpu_torch.kernel_profile import device_window
    sol = m.setup(dev)
    n_0 = sol.d_n
    state = m.start(sol)
    m.step(sol, state)                                  # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IWG_STEPS):
        m.step(sol, state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / IWG_STEPS
    counts = launch_counts()
    want = {k: 2 * IWG_STEPS if k in ("pour", "lattice_pair") else 0
            for k in counts}
    if counts != want:
        raise AssertionError(f"intercalation_w_gradient: launches {counts} "
                             f"in {IWG_STEPS} steps, expected {want}")
    h = sol.copy_to_host()
    for f, a in zip(h._fields, h):
        if not np.isfinite(a[:sol.d_n]).all():
            raise AssertionError(f"intercalation_w_gradient field {f} is "
                                 f"not finite")
    flags = {k: float(v.max()) for k, v in sol.aux.items()
             if k.startswith("__err_")}
    per, busy, kernels = device_window(lambda: m.step(sol, state), 3)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    print(f"intercalation_w_gradient at full width: {n_0} -> {sol.d_n} "
          f"cells in {sol.n_pad} rows after {IWG_STEPS + 1 + 4} steps, "
          f"engine {sol.engine}; flags {flags} (checked every step), state "
          f"finite; launches {counts} in {IWG_STEPS} steps; "
          f"{step_s * 1e3:.3f} ms a step without output; device {busy:.3f} "
          f"ms and {kernels:.0f} kernels a step (torch.profiler), the most: "
          + "; ".join(f"{v:.3f} ms {k[:70]}" for k, v in top))
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run(sol, IWG_STEPS - 1)
        torch.cuda.synchronize()
        run_s = (time.perf_counter() - t0) / IWG_STEPS
        files = len(list(Path("output").glob(
            "intercalation_w_gradient_*.vtk")))
    if files != IWG_STEPS:
        raise AssertionError(f"intercalation_w_gradient: {files} files in "
                             f"{IWG_STEPS} steps of run")
    print(f"intercalation_w_gradient run: {IWG_STEPS} steps with a VTK "
          f"frame each, {run_s * 1e3:.3f} ms a step, {sol.d_n} cells")
    return counts


def same_fields(tag, a_sol, b_sol, skip_poles=False):
    """Equal counts and every field of the active cells of two Solutions
    (card, CPU) within the reference's ``isclose`` (phi of the cells on a
    pole left out where ``skip_poles``)."""
    import numpy as np
    n = a_sol.get_d_n()
    if n != b_sol.get_d_n():
        raise AssertionError(f"{tag}: {n} cells on the card, "
                             f"{b_sol.get_d_n()} on the CPU")
    ha, hb = a_sol.copy_to_host(), b_sol.copy_to_host()
    for f in ha._fields:
        a, b = getattr(ha, f)[:n], getattr(hb, f)[:n]
        keep = np.ones(n, bool)
        if skip_poles and f == "phi":
            keep = np.abs(np.sin(hb.theta[:n].astype(np.float64))) >= 1e-6
        if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b))[keep].all():
            raise AssertionError(f"{tag} field {f}: GPU and CPU disagree "
                                 f"(max abs err "
                                 f"{np.abs(a - b)[keep].max():g})")


def example(name):
    import importlib
    return importlib.import_module(f"yalla_tpu_torch.examples.{name}")


# each example's initial state on the card, made once: name -> (Solution,
# snapshot, seconds its setup took)
SETUPS = {}


def example_setup(name, dev):
    """(a fresh copy of example ``name``'s initial state on ``dev``, the
    seconds its ``setup`` took on the card): the setup runs once, with the
    initial conditions' generator seeded (growth_w_wall's 101-step
    relaxation on the windowed Gabriel pass), and an automatic
    engine is picked then."""
    import torch
    from yalla_tpu_torch import inits
    if name not in SETUPS:
        inits.set_seed(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        src = example(name).setup("cuda")
        src.validate()
        torch.cuda.synchronize()
        SETUPS[name] = (src, snapshot(src), time.perf_counter() - t0)
    src, snap, seconds = SETUPS[name]
    return solution_at(src, snap, dev), seconds


def steps_gpu_vs_cpu(dev, name, n_steps, t0, n_compare, per_step, g):
    """``n_compare`` steps of example ``name`` from step ``t0`` of a run of
    ``n_steps`` on the card and on the CPU: one initial state (its
    ``setup`` on the card, the initial conditions' generator seeded,
    copied to the CPU), the same draws given to both (``m.draw`` on the
    CPU state from ``g``).  The kernels launched on the card are
    ``per_step`` a step; links and counts equal, every field within the
    reference's ``isclose`` (phi of the cells on a pole left out)."""
    import torch
    m = example(name)
    sols = {d: example_setup(name, d)[0] for d in (dev, "cpu")}
    states = {d: m.start(s, n_steps) for d, s in sols.items()}
    for state in states.values():
        state.t = t0
    before = launch_counts()
    for _ in range(n_compare):
        draws = m.draw(sols["cpu"], states["cpu"], g)
        for d, s in sols.items():
            m.step(s, states[d], to_device(draws, d))
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    want = {k: per_step.get(k, 0) * n_compare for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} in {n_compare} "
                             f"steps on the card, expected {want}")
    links = {d: getattr(st, "links", None) for d, st in states.items()}
    if links[dev] is not None and not (
            torch.equal(links[dev].d_a.cpu(), links["cpu"].d_a) and
            torch.equal(links[dev].d_b.cpu(), links["cpu"].d_b)):
        raise AssertionError(f"{name}: links differ between the card and "
                             f"the CPU")
    same_fields(name, sols[dev], sols["cpu"], skip_poles=True)
    print(f"{name}: {n_compare} steps on the GPU from step {t0}, "
          f"{sols['cpu'].get_d_n()} cells on both"
          + (", links equal" if links[dev] is not None else "")
          + f", every field within atol 1e-6 + rtol 1e-2 of the CPU plain "
          f"path (phi of the cells on a pole left out); launches {counts}")


def iwg_gpu_vs_cpu(dev):
    """Phase 23: one step of the intercalation_w_gradient example from its
    initial state on the card and on the CPU (:func:`steps_gpu_vs_cpu`):
    K1 and K2 twice on the card, the links and divisions equal."""
    import torch
    steps_gpu_vs_cpu(dev, "intercalation_w_gradient", None, 0, 1,
                     {"lattice_pair": 2, "pour": 2},
                     torch.Generator().manual_seed(5))


# the other stepping examples of the last ten on the card: name -> (run's
# n_steps, the step the card-against-CPU steps start at, the kernels
# launched a step on the card)
MORE_RUNS = {
    "sorting": (EX_STEPS - 1, 0, {}),
    "sorting_prot": (EX_STEPS - 1, 0, {}),
    "intercalation": (EX_STEPS - 1, 0, {}),
    # divisions start after step 100
    "passive_growth": (EX_STEPS - 1, 101, {}),
    "lineage_tracing": (EX_STEPS - 1, 101, {}),
    # 5 parts of 4 steps; steps 15 and 16: part 4's last (divisions),
    # part 5's first (protrusions)
    "model_features_sequential_addition": (3, 15, {}),
    "growth_w_wall": (EX_STEPS - 1, 0, {"gabriel_pair": 2, "pour": 2}),
}


def more_examples_gpu_vs_cpu(dev):
    """Phase 24: each of ``MORE_RUNS``, 2 steps card against CPU
    (:func:`steps_gpu_vs_cpu`; growth_w_wall on K5 on the card); teapot's
    cut of its 70,000-point cuboid (the same points kept) and
    write_vtk_w_mask's file (the same bytes)."""
    import contextlib
    import io
    import tempfile

    import torch
    from yalla_tpu_torch import inits
    g = torch.Generator().manual_seed(7)
    for name, (n_steps, t0, per_step) in MORE_RUNS.items():
        steps_gpu_vs_cpu(dev, name, n_steps, t0, 2, per_step, g)
    # teapot: the same cut on both devices' points
    m = example("teapot")
    kept = {}
    for d in (dev, "cpu"):
        inits.set_seed(3)
        points, mesh = m.setup(d)
        t0 = time.perf_counter()
        kept[d] = (m.cut(points, mesh), points.d_X.x[:m.cut(points, mesh)]
                   .cpu())
        cut_s = time.perf_counter() - t0
    if kept[dev][0] != kept["cpu"][0] or \
            not torch.equal(kept[dev][1], kept["cpu"][1]):
        raise AssertionError("teapot: the card's cut differs from the CPU's")
    print(f"teapot: {points.h_n} of the cuboid's points kept on both "
          f"devices, the same points ({cut_s * 1e3:.1f} ms for two cuts on "
          f"the CPU state)")
    # write_vtk_w_mask: the same bytes from either device
    m = example("write_vtk_w_mask")
    data = {}
    for d in (dev, "cpu"):
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
                contextlib.redirect_stdout(io.StringIO()):
            m.main(device=d)
            data[d] = [p.read_bytes() for p in
                       sorted(Path("output").glob("test_vtk_*.vtk"))]
    if not data[dev] or data[dev] != data["cpu"]:
        raise AssertionError("write_vtk_w_mask: the card's file differs")
    print(f"write_vtk_w_mask: the card's file equals the CPU's "
          f"({len(data[dev][0])} bytes)")


def k5_example_check(sol, capacity=None):
    """K5 against its plain version at a growth_w_wall example's state on
    the card (``sol``) on its growth engine (grid 64, C ``CAPACITY`` = 16,
    NC 100), or at ``capacity`` cells a cube: ``sum_f`` and the flags
    exact, the rest within ``compare_sums``'s tolerance; ms per pass of
    the wrapper (its lattice build included) and the plain version,
    device ms after the build, the bound.  Returns the kernel's
    record."""
    import torch
    from yalla_tpu_torch.kernel_profile import (device_window,
                                                gabriel_after_build)
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.gabriel_pallas import (gabriel_lattice_pallas,
                                                    gabriel_lattice_plain)
    e = sol.engine
    engine = dict(grid_size=e.grid_size, capacity=capacity or e.capacity,
                  max_candidates=e.max_candidates)
    X, ov, n = sol.d_X, sol.d_old_v, sol.get_d_n()
    args = (W.relu_force, W.wall_friction, X, ov, n, W.r_max)

    def k5():
        return gabriel_lattice_pallas(*args, **engine)

    def k5_plain():
        return gabriel_lattice_plain(*args, **engine)
    got, want = k5(), k5_plain()
    torch.cuda.synchronize()
    flags = {k: float(v.max()) for k, v in want[3].items()}
    if any(flags.values()):
        raise AssertionError(f"K5 growth_w_wall: flags set: {flags}")
    err = compare_sums("K5 growth_w_wall", flatten(got, "", n),
                       flatten(want, "", n), {"sum_f", *want[3]})
    kept = int(want[1][:n].sum())
    ms, plain_ms = cuda_ms(k5, 20), cuda_ms(k5_plain, 3)
    bound_ms, bound_by, n_bytes, _, n_ops = gabriel_bound(
        X, ov, n, got, kept, engine["grid_size"], engine["capacity"])
    with gabriel_after_build(X, ov, n, **engine) as k5_built:
        _, dev_ms, n_kernels = device_window(k5_built, 10)
    print(f"K5 at the growth_w_wall example's state ({n} cells in "
          f"{sol.n_pad} rows, grid {engine['grid_size']}, C "
          f"{engine['capacity']}, NC {engine['max_candidates']}): {kept} "
          f"kept pair ends, sum_f and flags exact, max abs err {err:.3g}; "
          f"{ms:.4f} ms/pass with its build vs plain {plain_ms:.4f}; device "
          f"{dev_ms:.4f} ms after the build in {n_kernels:g} kernels; bound "
          f"{bound_ms:.6f} ms ({bound_by}: {n_bytes / 1e6:.3f} MB, "
          f"{n_ops / 1e6:.3f} MFLOP), share {bound_ms / dev_ms:.2%}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def gww_capacity(dev):
    """Phase 26: the growth_w_wall example's growth lattice holds
    ``CAPACITY`` = 16 cells a cube, where the JAX example leaves the
    engine's 8.  From one relaxed state (:func:`example_setup`),
    ``GWW_STEPS`` steps with the same draws (made on the card from a
    seeded generator) on three engines: the gather Gabriel path
    (``lattice=False, windowed=False``, plain torch, which reads no
    capacity), K5 at C 16
    and K5 at C 8.  Prints, for each, the most cells in one cube of the
    64-cube grid in the state each step starts from, counted by
    ``torch.bincount`` (no kernel), and the step at which the C 8 run's
    flags raise (the run stops there).  K5 at C 8 against its plain
    version on the relaxed state, where 8 still hold, with its times
    (:func:`k5_example_check`).  Returns K5's C 8 record."""
    import dataclasses

    import torch
    from yalla_tpu_torch.ops.common import cube_ids
    from yalla_tpu_torch.solvers import SimulationError
    m = example("growth_w_wall")
    src = example_setup("growth_w_wall", dev)[0]
    gs = src.engine.grid_size

    def fullest(sol):
        n = sol.get_d_n()
        return int(torch.bincount(
            cube_ids(sol.d_X, n, sol.cube_size, gs)[:n]).max())
    relaxed = fullest(src)
    snap = snapshot(src)
    runs = {"gather": dataclasses.replace(src.engine, lattice=False,
                                          windowed=False),
            "C 16": dataclasses.replace(src.engine, capacity=16),
            "C 8": dataclasses.replace(src.engine, capacity=8)}
    sols, states, seen, raised = {}, {}, {}, None
    for k, engine in runs.items():
        sols[k] = solution_at(src, snap, dev, engine)
        states[k], seen[k] = m.start(sols[k]), []
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    for t in range(GWW_STEPS):
        draws = m.draw(sols["gather"], states["gather"], g)
        for k in list(sols):
            seen[k].append(fullest(sols[k]))
            try:
                m.step(sols[k], states[k], draws)
            except SimulationError as err:
                if k != "C 8" or "lattice_dropped" not in str(err):
                    raise
                raised = (t, str(err))
                del sols[k]
    if "C 16" not in sols or "gather" not in sols:
        raise AssertionError("growth_w_wall: the gather or C 16 run "
                             "stopped")
    print(f"growth_w_wall capacity: the relaxed state's fullest cube holds "
          f"{relaxed} cells; the fullest cube at the start of steps 0-"
          f"{GWW_STEPS - 1} (the same draws on each engine): "
          + "; ".join(f"{k}: {v}" for k, v in seen.items())
          + "; the C 8 run's flags "
          + (f"raised at step {raised[0]} ({raised[1][:90]})" if raised
             else f"stayed 0 for {GWW_STEPS} steps"))
    if relaxed > 8:
        raise AssertionError(f"growth_w_wall: {relaxed} cells in a cube "
                             f"of the relaxed state")
    return k5_example_check(src, capacity=8)


def gww_published(dev, seed=None):
    """Phase 26 (b): the published growth_w_wall run (``n_time_steps`` + 1
    steps from ``n_0`` cells, a frame every ``n_time_steps // 100`` steps)
    through the example's ``setup``, ``start``, ``step`` and
    ``write_frame`` on the card, from ``seed`` (the published ``SEED``
    by default), its frames into a temporary directory.  ``take_step``
    checks the flags every step (a flag raises).  Before each step it
    reads the fullest cube of the growth lattice's grid and the most
    cells within ``r_max`` of one cell (K5's candidates); prints them with
    the final count and the run's seconds (the readings' syncs
    included).  Returns (final count, fullest cube, most candidates)."""
    import tempfile

    import torch
    from yalla_tpu_torch.ops.common import cube_ids
    from yalla_tpu_torch.vtkio import Vtk_output
    m = example("growth_w_wall")
    seed = m.SEED if seed is None else seed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cells = m.setup(dev, seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state = m.start(cells, seed=seed)
    cell_type = m.cell_types(cells)
    e = cells.engine
    fullest = cand = 0
    skip = max(1, state.n_steps // 100)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            Vtk_output("growth_w_wall", tmp, verbose=False) as out:
        for t in range(state.n_steps + 1):
            n = cells.get_d_n()
            X = cells.d_X
            fullest = max(fullest, int(torch.bincount(
                cube_ids(X, n, cells.cube_size, e.grid_size)[:n]).max()))
            P = torch.stack([a[:n] for a in X], 1)
            reach2 = cells.cube_size ** 2
            for i0 in range(0, n, 2048):
                d2 = ((P[i0:i0 + 2048, None, :] - P[None]) ** 2).sum(-1)
                cand = max(cand, int((d2 < reach2).sum(1).max()) - 1)
            m.step(cells, state)
            if t % skip == 0:
                m.write_frame(out, cells, state, cell_type)
        files = len(list(Path(tmp).glob("*.vtk")))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n = cells.get_d_n()
    print(f"phase 26 (b) the published growth_w_wall run from seed {seed}: "
          f"setup {setup_s:.2f} s, {state.t} steps and {files} frames in "
          f"{run_s:.2f} s with the readings; {m.n_0} -> {n} cells in "
          f"{cells.n_pad} rows, flags 0 every step; the fullest cube held "
          f"{fullest} (capacity {e.capacity}), the most candidates in reach "
          f"{cand} (max_candidates {e.max_candidates})")
    return n, fullest, cand


def more_example_runs(dev):
    """Phase 25: each of ``MORE_RUNS``'s ``run`` on the card at its
    published size (from :func:`example_setup`: growth_w_wall's
    relaxation on the windowed Gabriel pass, passive_growth's ball
    relaxed on K3), its
    frames written into a temporary directory, the launch counts set to 0
    just before ``run`` and read just after (growth_w_wall: K5 and K2
    twice a step, the others no kernel), the state finite; ms a step with
    its frames, then as many steps without output from the table's start
    step (the steps with draws from the run's generators on the card);
    teapot's cut of 70,000 points and its two frames; K5 against its
    plain version at growth_w_wall's state after its run
    (:func:`k5_example_check`).  Returns ({kernel: launches}, K5's
    record at that state)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from yalla_tpu_torch import inits
    launches = {}
    for name, (n_steps, t0, per_step) in MORE_RUNS.items():
        m = example(name)
        sol, setup_s = example_setup(name, dev)
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
                contextlib.redirect_stdout(io.StringIO()):
            reset_launches()
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            steps = m.run(sol, n_steps).t
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_start
            counts = launch_counts()
            files = len(list(Path("output").glob("*.vtk")))
        want = {k: per_step.get(k, 0) * steps for k in counts}
        if counts != want or not files:
            raise AssertionError(f"{name}: launches {counts} and {files} "
                                 f"files in {steps} steps, expected {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        h = sol.copy_to_host()
        for f, a in zip(h._fields, h):
            if not np.isfinite(a[:sol.get_d_n()]).all():
                raise AssertionError(f"{name} field {f} is not finite")
        # as many steps without output, from the table's start step
        state = m.start(sol, n_steps)
        state.t = t0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for _ in range(steps):
            m.step(sol, state)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t_start
        flags = {k: float(v.max()) for k, v in sol.aux.items()
                 if k.startswith("__err_")}
        if any(flags.values()):
            raise AssertionError(f"{name}: flags {flags}")
        if name == "growth_w_wall":
            k5_rec = k5_example_check(sol)
        print(f"{name} on the card: setup {setup_s:.2f} s, {sol.get_d_n()} "
              f"cells, {steps} steps of run with {files} VTK files, "
              f"launches {counts}, flags 0, state finite; "
              f"{run_s * 1e3 / steps:.3f} ms a step with its frames, "
              f"{bare_s * 1e3 / steps:.3f} ms a step without (from step "
              f"{t0})")
    m = example("teapot")
    inits.set_seed(2)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        points, mesh = m.setup(dev)
        n_box = points.h_n
        m.run(points, mesh)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_start
        files = len(list(Path("output").glob("teapot_*.vtk")))
    if files != 2 or not 0 < points.h_n < n_box:
        raise AssertionError(f"teapot: {files} files, {points.h_n} of "
                             f"{n_box} points kept")
    print(f"teapot on the card: {n_box} points in the cuboid, {points.h_n} "
          f"inside the mesh, {run_s:.3f} s for setup, cut and both frames")
    return launches, k5_rec


def snapshot(sol):
    """(host fields, count, host old_v) of a Solution's device state."""
    return (sol.pt_type(*(a.cpu().numpy().copy() for a in sol.d_X)),
            sol.d_n, [a.cpu().numpy().copy() for a in sol.d_old_v])


def solution_at(sol, snap, device, engine=None):
    """A Solution like ``sol`` (point type, rows, engine unless another
    is given) on ``device`` holding the state ``snap``."""
    import torch
    from yalla_tpu_torch.dtypes import Float3
    from yalla_tpu_torch.solvers import Solution
    h, n, ov = snap
    out = Solution(sol.pt_type, sol.n_max, engine=engine or sol.engine,
                   device=device, n_pad=sol.n_pad)
    out.h_X = sol.pt_type(*(a.copy() for a in h))
    out.h_n = n
    out.copy_to_device()
    out.d_old_v = Float3(*(torch.as_tensor(a, device=device) for a in ov))
    return out


def example_gpu_vs_cpu(dev, states):
    """Phase 18: each all-pairs example from its initial state, 2 steps on
    the card against the same steps on the CPU (bending 1 step, without
    its pole cells' phi)."""
    import numpy as np
    import torch
    for _, name, force_name in EXAMPLES_K3:
        m, sol = states[name]
        snap = snapshot(sol)
        steps = 1 if name == "bending" else 2
        draws = None
        if name == "random_walk":
            g = torch.Generator(device=dev)
            g.manual_seed(m.SEED)
            draws = [m.draw(g) for _ in range(steps)]
        ends = {}
        for d in (dev, "cpu"):
            s = solution_at(sol, snap, d)
            for k in range(steps):
                if draws is not None:
                    s.d_X = m.update_polarity(s.d_X, type(draws[k])(
                        *(t.to(d) for t in draws[k])))
                s.take_step(m.dt, getattr(m, force_name))
            ends[d] = s.copy_to_host()
        n = snap[1]
        for f in sol.pt_type._fields:
            a, b = (getattr(ends[d], f)[:n] for d in (dev, "cpu"))
            keep = np.ones(n, bool)
            if name == "bending" and f == "phi":
                keep = np.abs(np.sin(snap[0].theta[:n].astype(
                    np.float64))) >= 1e-6
            a, b = a[keep], b[keep]
            if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all():
                raise AssertionError(f"{name} field {f}: GPU and CPU "
                                     f"disagree (max abs err "
                                     f"{np.abs(a - b).max():g})")
        print(f"{name}: {steps} step(s) on the GPU within atol 1e-6 + rtol "
              f"1e-2 of the CPU plain path in every field"
              + (" (phi of the cells on a pole left out)"
                 if name == "bending" else ""))


def example_runs(dev, states):
    """Phase 19: each all-pairs example's ``run`` on the card for
    ``EX_STEPS`` steps, its files in a temporary directory, the launch
    counts set to 0 just before and read just after.  Returns {functor:
    K3 launches}."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    launches = {}
    for functor, name, force_name in EXAMPLES_K3:
        m, sol = states[name]
        m.n_time_steps = EX_STEPS - 1     # run takes n_time_steps + 1
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
                contextlib.redirect_stdout(io.StringIO()):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.run(sol)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = launch_counts()
            files = len(list(Path("output").glob(f"{name}_*.vtk")))
        flags = {k: float(v.max()) for k, v in sol.aux.items()
                 if k.startswith("__err_")}
        if any(flags.values()):
            raise AssertionError(f"{name} flags set: {flags}")
        h = sol.copy_to_host()
        for f, a in zip(h._fields, h):
            if not np.isfinite(a).all():
                raise AssertionError(f"{name} field {f} is not finite")
        others = {k: v for k, v in counts.items() if k != "tile_pair" and v}
        if counts["tile_pair"] != 2 * EX_STEPS or others or \
                files != EX_STEPS:
            raise AssertionError(f"{name}: launches {counts} and {files} "
                                 f"files in {EX_STEPS} steps, expected "
                                 f"tile_pair {2 * EX_STEPS} and "
                                 f"{EX_STEPS} files")
        launches[functor] = launches.get(functor, 0) + counts["tile_pair"]
        force = getattr(m, force_name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EX_STEPS):
            sol.take_step(m.dt, force)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        print(f"{name} ({functor}): {sol.d_n} cells, {EX_STEPS} steps of "
              f"run, flags {flags}, state finite, launches {counts}, "
              f"{files} files; {run_s * 1e3 / EX_STEPS:.3f} ms a step with "
              f"its frame, {bare_s * 1e3 / EX_STEPS:.3f} ms a step without")
    return launches


def grid_examples(dev):
    """Phase 20: the six grid examples on the card at their published
    sizes, ``GRID_STEPS`` steps each through ``run`` (files into a
    temporary directory): no kernel launched, every flag 0, the state
    finite; then ``GRID_STEPS`` more steps without output, timed."""
    import contextlib
    import importlib
    import io
    import tempfile

    import numpy as np
    import torch
    from yalla_tpu_torch import GenericForce, inits
    from yalla_tpu_torch.ops.common import friction_on_background
    for name in GRID_EXAMPLES:
        m = importlib.import_module(f"yalla_tpu_torch.examples.{name}")
        inits.set_seed(0)
        sol = m.setup(dev)
        kwargs = {}
        if name in ("epithelium", "polarization"):
            m.n_time_steps = GRID_STEPS - 1
        elif name == "epithelia_double_polarity":
            m.skip_step = GRID_STEPS // 2
            kwargs["n_steps"] = GRID_STEPS
        else:   # one frame of skip_steps steps
            m.skip_steps = GRID_STEPS
            if name == "apical_constriction":
                m.n_time_steps = 0
            else:
                kwargs["n_steps"] = 0
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
                contextlib.redirect_stdout(io.StringIO()):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.run(sol, **kwargs)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            counts = launch_counts()
        flags = {k: float(v.max()) for k, v in sol.aux.items()
                 if k.startswith("__err_")}
        if any(flags.values()) or any(counts.values()):
            raise AssertionError(f"{name}: flags {flags}, launches {counts}")
        h = sol.copy_to_host()
        for f, a in zip(h._fields, h):
            if not np.isfinite(a).all():
                raise AssertionError(f"{name} field {f} is not finite")
        force = getattr(m, GRID_FORCES[name])
        friction = {"pw_friction": friction_on_background} \
            if name in ("epithelium", "apical_constriction") else {}
        gen = {}
        if name == "turing_w_noise":
            gen["gen_forces"] = GenericForce(m.noise_force, torch.rand(
                sol.n_pad, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRID_STEPS):
            sol.take_step(m.dt, force, **friction, **gen)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        print(f"{name} on GridEngine: {sol.d_n} cells, {GRID_STEPS} steps, "
              f"flags {flags}, no kernel launched, state finite; "
              f"{run_s * 1e3 / GRID_STEPS:.3f} ms a step with its frames, "
              f"{bare_s * 1e3 / GRID_STEPS:.3f} ms a step without")


def thin_cube_checks(dev):
    """Phase 27's kernel checks: K2 and K1 at ``xr = 2`` against their
    plain versions on the thin x-cubes' build of the 500k state
    (``kernel_profile.THIN_500K``: grid 128 x 64 x 64 of half-width
    x-cubes, C 5), as in phases 2 and 3, with K1's plan, registers and
    spills.  ``main`` runs them beside phase 3: late in a long process
    torch.profiler has returned eight windows in a row without device
    events.  Returns the kernels' records."""
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.kernel_profile import THIN_500K
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.solvers import LatticeEngine
    X, old_v = load_settled(SETTLED, B.Cell, dev)
    checks = lattice_kernel_checks("500k thin (x_split 2)", X, old_v,
                                   N_CELLS, 1.0, LatticeEngine(**THIN_500K))
    ptxas_report(["lattice_pair_kernel", "extras_pair_kernel"])
    return checks


def thin_cubes(dev):
    """Phase 27: thin x-cubes on the 500k state at the per-pass rebuild,
    ``N_STEPS`` steps of ``Solution.take_steps`` with every flag 0, K1
    and K2 launched twice a step (their checks: :func:`thin_cube_checks`).
    Returns the launch counts."""
    from yalla_tpu_torch.kernel_profile import THIN_500K
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.solvers import LatticeEngine
    p = B.Params()
    engine = LatticeEngine(**THIN_500K)
    print(f"thin x-cubes: {engine}")
    sol = solution(SETTLED, N_CELLS, engine, dev, 1.0)
    launches, _, _ = run_slice("thin x-cubes slice", sol, N_CELLS, N_STEPS,
                               p.dt, B.make_force(p),
                               ["pour", "lattice_pair"],
                               precompute=B.precompute)
    return launches


def movers(lay, cube, grid_size, capacity, x_split):
    """The lattice cells whose cube changed since ``lay`` was binned: the
    mover count ``lattice_rebin`` bounds by its ``m_cap`` (0-d tensor)."""
    import torch
    from yalla_tpu_torch.ops.common import cube_coord, grid_dims
    gx, gy, gz = grid_dims(grid_size)
    T = lay.T
    occ = lay.pid < lay.slot_of.shape[0]
    cid = (cube_coord(T.z, cube, gz) * gy + cube_coord(T.y, cube, gy)) \
        * gx + cube_coord(T.x, cube / x_split, gx)
    home = torch.arange(occ.shape[0], device=occ.device) // capacity
    return (occ & (cid != home)).sum()


def cadence_run(tag, engine, cube, n_steps, rebuild_every, rebin_m_cap,
                rebin_per_pass, expect_k2, check=True):
    """``n_steps`` of ``lattice_heun_steps`` on the settled 500k state
    with ``engine``'s lattice at a rebin cadence, twice: once with every
    ``lattice_rebin`` call counting its movers (the largest printed),
    once timed with the launch counts set to 0 just before and read just
    after (K1 twice a step, K2 ``expect_k2`` times).  With ``check``
    every flag must be 0.  Returns (aux, launches, ms a step)."""
    import torch
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops import lattice_xla as TL
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    p = B.Params()
    force = B.make_force(p)
    X, old_v = load_settled(SETTLED, B.Cell, torch.device("cuda"))
    e = engine

    def run():
        return TL.lattice_heun_steps(
            n_steps, rebuild_every, force, friction_w_neighbour, "com",
            e.grid_size, e.capacity, e.z_block, X, old_v, N_CELLS, p.dt,
            cube, 0, B.precompute, True, None, None, e.force_r_max,
            e.extras_cap, e.extras_block_cap, rebin_m_cap, rebin_per_pass,
            e.route_movers, e.x_split)
    rebin, most = TL.lattice_rebin, [torch.zeros((), dtype=torch.int64,
                                                 device=X.x.device)]

    def counted(lay, *args, **kw):
        most[0] = torch.maximum(most[0], movers(lay, cube, e.grid_size,
                                                e.capacity, e.x_split))
        return rebin(lay, *args, **kw)
    TL.lattice_rebin = counted
    try:
        run()
    finally:
        TL.lattice_rebin = rebin
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, aux = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    launches = launch_counts()
    flags = {k: float(v.float().max()) for k, v in aux.items()
             if k.startswith("__err_")}
    if check and any(flags.values()):
        raise AssertionError(f"{tag}: flags set {flags}")
    if (launches["lattice_pair"], launches["pour"]) != (2 * n_steps,
                                                        expect_k2):
        raise AssertionError(f"{tag}: launches {launches}")
    print(f"{tag}: {n_steps} steps, largest mover count {int(most[0])} "
          f"(m_cap {rebin_m_cap}), flags {flags}, launches {launches}; "
          f"{ms:.3f} ms/step")
    return aux, launches, ms


def rebin_cadences(dev):
    """Phase 28: slot-space rebinning before every pass (``rebin_per_pass``,
    a mover list of ``REBIN_M_CAP``) at the main path's configuration
    (``bench_state.json`` ``branching_500000``: 64^3, C 8) and on phase
    27's thin x-cubes: every flag 0, ``__err_rebin_overflow`` included;
    the largest mover count and ms a step.  Returns the launch counts."""
    from yalla_tpu_torch.interop import bench_config, bench_engine
    from yalla_tpu_torch.kernel_profile import THIN_500K
    from yalla_tpu_torch.solvers import LatticeEngine
    cfg = bench_config(ROOT / "bench_state.json", BENCH_KEY)
    runs = {}
    for tag, engine, cube in (
            ("rebin per pass (64^3, C 8)", bench_engine(cfg),
             float(cfg["cube"])),
            ("rebin per pass, thin x-cubes (x_split 2)",
             LatticeEngine(**THIN_500K), 1.0)):
        runs[tag] = cadence_run(tag, engine, cube, CADENCE_STEPS, 1,
                                REBIN_M_CAP, True, 1)[1]
    return runs


def resident_cadences(dev):
    """Phase 29: the resident cadence (``RESIDENT_500K``: a build every 4
    steps, cube 1.1 at C 10, ``force_r_max`` 1.0) for ``RESIDENT_STEPS``
    steps of ``Solution.take_steps`` with ``check_errors=False``, then the
    same with slot-space rebinning per chunk (``REBIN_M_CAP``).  Prints
    ``stale_max_disp``, ``stale_shear_closure`` and ``__err_stale``;
    every other flag must be 0.  Then the staleness certificate's gap
    deficit of the final state's per-cube extrema on the card against the
    same extrema moved to the CPU, bit for bit.  Returns the launch
    counts of the ``Solution`` run."""
    import torch
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops import lattice_xla as TL
    from yalla_tpu_torch.solvers import LatticeEngine
    p = B.Params()
    engine = LatticeEngine(**RESIDENT_500K)
    sol = solution(SETTLED, N_CELLS, engine, dev, RESIDENT_CUBE)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = sol.take_steps(RESIDENT_STEPS, p.dt, B.make_force(p),
                         precompute=B.precompute, check_errors=False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / RESIDENT_STEPS
    launches = launch_counts()
    expect = (2 * RESIDENT_STEPS, RESIDENT_STEPS // engine.rebuild_every)
    if (launches["lattice_pair"], launches["pour"]) != expect:
        raise AssertionError(f"resident cadence: launches {launches}")

    def report(tag, aux, ms):
        stale = {k: float(aux[k]) for k in
                 ("stale_max_disp", "stale_shear_closure", "__err_stale")}
        others = {k: float(v.float().max()) for k, v in aux.items()
                  if k.startswith("__err_") and k != "__err_stale"}
        if any(others.values()):
            raise AssertionError(f"{tag}: flags set {others}")
        margin = RESIDENT_CUBE - engine.force_r_max
        print(f"{tag}: {RESIDENT_STEPS} steps, {stale} (binning margin "
              f"{margin:.2f}), other flags {others}; {ms:.3f} ms/step")
    report("resident cadence (rebuild_every 4, cube 1.1, C 10)", aux, ms)
    aux2, _, ms2 = cadence_run(
        "resident cadence, rebin per chunk", engine, RESIDENT_CUBE,
        RESIDENT_STEPS, engine.rebuild_every, REBIN_M_CAP, False, 1,
        check=False)
    report("resident cadence, rebin per chunk", aux2, ms2)
    lay = TL.lattice_build(sol.d_X, sol.d_old_v, N_CELLS, RESIDENT_CUBE,
                           engine.grid_size, engine.capacity,
                           engine.extras_cap)
    P, Q = TL.cube_extrema(lay, lay.T, lay.E, RESIDENT_CUBE,
                           engine.grid_size)
    on_card = TL._gap_deficit(P, Q, engine.grid_size)
    on_cpu = TL._gap_deficit(P.cpu(), Q.cpu(), engine.grid_size)
    if on_card.cpu().numpy().tobytes() != on_cpu.numpy().tobytes():
        raise AssertionError(f"gap deficit: card {float(on_card)!r} != "
                             f"CPU {float(on_cpu)!r}")
    print(f"gap deficit of the final state's extrema: card {float(on_card)!r}"
          f" == CPU {float(on_cpu)!r} bit for bit (closure "
          f"{float(on_card) + RESIDENT_CUBE:.6f})")
    return launches


def cadences_gpu_vs_cpu(dev):
    """Phase 30: the new cadences on the settled 600-cell state (640 rows,
    cube 1.1), 4 steps on the card against the same steps on the CPU
    (the plain versions): a build every 4 steps with ``force_r_max``,
    rebinning per step and per pass, thin x-cubes, mover routing with
    extras at a build every 4 steps, and 300 seeded links as a generic
    force at a build every 4 steps.  Every field within the reference's
    ``isclose``, every flag equal."""
    import numpy as np
    import torch
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.links import Links, link_forces
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_xla import lattice_heun_steps
    p = B.Params()
    force = B.make_force(p)
    rng = np.random.default_rng(0)
    la, lb = (rng.integers(0, N_SMALL, 300) for _ in range(2))
    base = dict(grid=32, C=8, every=4, r_max=1.0, extras=0, block=16,
                m=0, per_pass=False, route=0.0, xs=1, links=False)
    cases = {
        "build every 4, force_r_max": {},
        "rebin per step": dict(every=1, m=4096),
        "rebin per pass": dict(every=1, r_max=None, m=4096, per_pass=True),
        "thin x-cubes": dict(grid=(64, 32, 32), C=4, every=1, r_max=None,
                             extras=64, xs=2),
        "route_movers 2.0, extras": dict(C=4, extras=640, block=640,
                                         route=2.0),
        "300 links": dict(links=True),
    }
    for tag, kw in cases.items():
        c = dict(base, **kw)
        ends = {}
        for d in ("cpu", dev):
            X, ov = load_settled(SETTLED_SMALL, B.Cell, d)
            gen = gen_args = None
            if c["links"]:
                links = Links(300, strength=0.2, seed=0, device=d)
                links.h_a[:300], links.h_b[:300] = la, lb
                links.copy_to_device()
                gen = link_forces(links)
                gen_args = gen.args
            Xe, ove, aux = lattice_heun_steps(
                4, c["every"], force, friction_w_neighbour, "com", c["grid"],
                c["C"], 2, X, ov, N_SMALL, p.dt, 1.1, 0, B.precompute, True,
                gen, gen_args, c["r_max"], c["extras"], c["block"], c["m"],
                c["per_pass"], c["route"], c["xs"])
            ends[d] = (Xe, {k: float(v.float().max()) for k, v in aux.items()
                            if k.startswith("__err_")})
        torch.cuda.synchronize()
        if ends[dev][1] != ends["cpu"][1]:
            raise AssertionError(f"{tag}: flags card {ends[dev][1]} != CPU "
                                 f"{ends['cpu'][1]}")
        for f in B.Cell._fields:
            a = getattr(ends[dev][0], f).cpu().numpy()[:N_SMALL]
            b = getattr(ends["cpu"][0], f).numpy()[:N_SMALL]
            if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all():
                raise AssertionError(f"{tag} field {f}: card and CPU "
                                     f"disagree ({np.abs(a - b).max():g})")
        print(f"{N_SMALL} cells, {tag}: 4 steps on the card within isclose "
              f"of the CPU in every field, flags equal {ends['cpu'][1]}")


def k1_device_ms(fn, windows=3):
    """Device ms per call of ``fn`` in K1's lattice kernel: the largest of
    ``windows`` profiler windows, since a window that lost some of its
    events reads low (a slab pass once read 0.06 ms beside its twin's
    0.30, while CUDA events timed both wrappers at 0.32-0.38 ms)."""
    return max(sum(profiled_ms(fn, ["lattice_pair_kernel"]).values())
               for _ in range(windows))


def min_capacity(X, old_v, n, cube, grid_size, C=8):
    """The smallest capacity from ``C`` up at which a build of the state
    drops no cell."""
    from yalla_tpu_torch.ops.lattice_xla import lattice_build
    while int(lattice_build(X, old_v, n, cube, grid_size, C).n_dropped):
        C += 1
    return C


def zhalo_kernel_checks(dev):
    """Phase 31: K1 with ``z_halo`` against its plain version on the main
    path's settled 500k state at grid 64 and the smallest capacity that
    drops nothing, split into 2 and into 4 z-slabs, each slab's halo
    planes taken from the whole lattice (``lattice_spmd.slab_of``):
    ``sum_f`` and ``epi_nbs`` exact, the other sums within
    ``compare_sums``'s tolerance; each slab's sums equal to the kernel's
    pass over the whole lattice on that slab, bit for bit; device ms per
    slab pass (``k1_device_ms``), wrapper and plain ms, the bound from
    the slab's bytes and operations; registers and spills.  Returns (the
    record of the D 2 slab passes, the capacity)."""
    import torch
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour, grid_dims
    from yalla_tpu_torch.ops.lattice_pallas import (lattice_pairwise_pallas,
                                                    lattice_pairwise_plain)
    from yalla_tpu_torch.ops.lattice_xla import lattice_build
    from yalla_tpu_torch.parallel.lattice_spmd import slab_of
    from yalla_tpu_torch.solvers import augment
    X, old_v = load_settled(SETTLED, B.Cell, dev)
    gs, n = 64, N_CELLS
    C = min_capacity(X, old_v, n, 1.0, gs)
    lay = lattice_build(X, old_v, n, 1.0, gs, C)
    lay = lay._replace(T=augment(lay.T, n, B.precompute))
    n_pad = lay.slot_of.shape[0]
    force = B.make_force(B.Params())
    kw = dict(grid_size=gs, capacity=C, z_block=2)
    whole = flatten(lattice_pairwise_pallas(force, friction_w_neighbour, lay,
                                            n, 1.0, **kw), "")
    live = lay.pid < n_pad
    live_cube = torch.nonzero(live).squeeze(1) // C
    gx, gy, gz = grid_dims(gs)
    plane = gx * gy * C
    exact = {"sum_f", "epi_nbs"}
    record = {}
    for D in (2, 4):
        n_local = gz // D * plane
        errs, dev_ms, ms, plain_ms, bounds = [], [], [], [], []
        for k in range(D):
            shim, halo, gzl = slab_of(lay, gs, C, D, k)
            slab = dict(grid_z=gzl, n_pad=n_pad, z_halo=halo, **kw)

            def k1(shim=shim, slab=slab):
                return lattice_pairwise_pallas(force, friction_w_neighbour,
                                               shim, n, 1.0, **slab)

            def k1_plain(shim=shim, slab=slab):
                return lattice_pairwise_plain(force, friction_w_neighbour,
                                              shim, n, 1.0, **slab)
            got, want = k1(), k1_plain()
            errs.append(compare_sums(f"K1 z_halo D {D} slab {k}",
                                     flatten(got, ""), flatten(want, ""),
                                     exact))
            sl = slice(k * n_local, (k + 1) * n_local)
            for name, a in flatten(got, "").items():
                if not torch.equal(a, whole[name][sl]):
                    raise AssertionError(f"K1 z_halo D {D} slab {k} {name}: "
                                         f"not the whole lattice's pass")
            ms.append(cuda_ms(k1, 10))
            plain_ms.append(cuda_ms(k1_plain, 1))
            dev_ms.append(k1_device_ms(k1))
            # the slab's live cells and its two halo planes' read once
            # (12 channels, the occupancy), 13 sums written per slot; the
            # candidates of the slab's cells, the force on pairs in reach
            n_read = int(live[sl].sum()) + int(halo[4].sum()) + \
                int(halo[5].sum())
            in_reach = float(want[1].sum())
            cands = stencil_candidates(live_cube, gx, gy, gz, 1,
                                       (k * gz // D, (k + 1) * gz // D))
            bounds.append(bound(n_read * 12 * 4 + n_local + 2 * plane
                                + n_local * 13 * 4,
                                cands * OPS_DIST
                                + in_reach * OPS_PER_PAIR["branching"]))
        print(f"K1 z_halo, {D} slabs of {gz // D} planes (grid {gs}, C {C}, "
              f"{n} cells): counters exact and each slab equal to the "
              f"whole lattice's pass on it, max abs err vs plain "
              f"{max(errs):.3g}; device ms per slab pass (torch.profiler) "
              + ", ".join(f"{v:.4f}" for v in dev_ms)
              + "; wrapper ms " + ", ".join(f"{v:.4f}" for v in ms)
              + "; plain ms " + ", ".join(f"{v:.2f}" for v in plain_ms)
              + "; bound ms " + ", ".join(f"{b[0]:.4f} ({b[1]})"
                                          for b in bounds))
        record[D] = {"max_abs_err": max(errs), "ms": max(ms),
                     "device_ms": max(dev_ms), "plain_ms": max(plain_ms),
                     "bound_ms": max(b[0] for b in bounds),
                     "bound_by": bounds[0][1], "library_ms": None,
                     "device_ms_per_slab": dev_ms}
    whole_dev = k1_device_ms(lambda: lattice_pairwise_pallas(
        force, friction_w_neighbour, lay, n, 1.0, **kw))
    print(f"K1 on the whole grid-{gs}, C {C} lattice: {whole_dev:.4f} device "
          f"ms per pass")
    ptxas_report(["lattice_pair_kernel"])
    rec = dict(record[2])
    rec["device_ms_4_slabs"] = record[4]["device_ms_per_slab"]
    rec["whole_lattice_device_ms"] = whole_dev
    return rec, C


def zslab_path(dev, C):
    """Phase 32: the z-slab path at full width, two ranks on the card
    (gloo, staged through host memory): ``lattice_sharded_heun_steps(
    pallas=True)`` with the branching force, ``friction_w_neighbour`` and
    ``polarity_precompute3`` on the settled 500k state, grid 64, capacity
    ``C``, a build every 2 steps, ``ZSLAB_STEPS`` steps: every flag 0, K1
    launched twice a step on the rank, positions within atol 5e-5
    (``tests/test_parallel.py``'s) of the single-process
    ``lattice_heun_steps`` at the same cadence and capacity on the card;
    ms a step beside the transport's seconds.  Then the same run with
    ``pallas=False`` (JAX's default, which selects nothing on the slab
    path): every flag 0, K1 twice a step on the rank, every field equal
    to the ``pallas=True`` run's (max abs err 0), its ms a step.
    Returns K1's launches on the rank in the ``pallas=True`` run."""
    import numpy as np
    import torch
    from yalla_tpu_torch.interop import load_settled, pt_to_numpy
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_xla import lattice_heun_steps
    from yalla_tpu_torch.parallel import dryrun
    from yalla_tpu_torch.parallel._comm import spawn
    p = B.Params()
    X, old_v = load_settled(SETTLED, B.Cell, dev)
    runs = {}
    for pallas in (True, False):
        args = (N_CELLS, p.dt, 1.0, 64, C, 2, ZSLAB_STEPS, 2, pallas)
        got = spawn(dryrun.run_slab, 2, "branching", pt_to_numpy(X),
                    pt_to_numpy(old_v), *args, warmup=True, backend="gloo",
                    device="cuda")
        if any(got["flags"].values()):
            raise AssertionError(f"z-slab path (pallas={pallas}) flags "
                                 f"set: {got['flags']}")
        if got["lattice_pair_launches"] != 2 * ZSLAB_STEPS:
            raise AssertionError(f"z-slab path (pallas={pallas}): K1 "
                                 f"launched {got['lattice_pair_launches']} "
                                 f"times in {ZSLAB_STEPS} steps on a rank")
        runs[pallas] = got
    got = runs[True]
    # pallas=False selects nothing on the slab path: the same kernels on
    # the same inputs, so every field equal to the bit
    same = max(float(np.abs(runs[False][k][f] - got[k][f]).max())
               for k in ("X", "old_v") for f in got[k])
    if same != 0.0:
        raise AssertionError(f"z-slab path: pallas=False differs from "
                             f"pallas=True by {same:g}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xs, _, aux = lattice_heun_steps(
        ZSLAB_STEPS, 2, B.make_force(p), friction_w_neighbour, "com", 64, C,
        2, X, old_v, N_CELLS, p.dt, 1.0, 0, B.precompute)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / ZSLAB_STEPS
    flags = {k: float(v.float().max()) for k, v in aux.items()
             if k.startswith("__err_")}
    if any(flags.values()):
        raise AssertionError(f"single-process run flags set: {flags}")
    err = max(float(np.abs(got["X"][f][:N_CELLS]
                           - getattr(Xs, f)[:N_CELLS].cpu().numpy()).max())
              for f in "xyz")
    if not err <= 5e-5:
        raise AssertionError(f"z-slab path positions: max abs err {err:g} "
                             f"against the single-process run")
    ms = got["seconds"] * 1e3 / ZSLAB_STEPS
    tr = got["transport_seconds"] * 1e3 / ZSLAB_STEPS
    print(f"z-slab path: 2 ranks on the card ({got['transport']}), "
          f"{N_CELLS} cells, grid 64, C {C}, a build every 2 steps, "
          f"{ZSLAB_STEPS} steps: flags {got['flags']}, K1 launched "
          f"{got['lattice_pair_launches']} times on rank 0, positions "
          f"within {err:.3g} of the single-process run; {ms:.3f} ms/step "
          f"on rank 0, of which the transport {tr:.3f} ms "
          f"({got['transport_calls'] / ZSLAB_STEPS:.1f} collectives, "
          f"{got['transport_bytes'] / ZSLAB_STEPS / 1e6:.1f} MB a step); "
          f"the single-process run {single_ms:.3f} ms/step")
    off = runs[False]
    print(f"z-slab path pallas=False: flags {off['flags']}, K1 launched "
          f"{off['lattice_pair_launches']} times on rank 0, every field "
          f"equal to pallas=True's (max abs err {same:g}); "
          f"{off['seconds'] * 1e3 / ZSLAB_STEPS:.3f} ms/step on rank 0 "
          f"(pallas=True {ms:.3f})")
    return got["lattice_pair_launches"]


def cells_axis_path(dev):
    """Phase 33: the cells-axis step, two ranks on the card:
    ``make_sharded_step`` on the settled 5k sorting state (5,120 rows,
    2,560 a rank) with ``TileEngine()`` (the windowed plain pass) and the
    hand-written adhesion, 2 steps, against the single-process steps of
    the plain all-pairs pass on the card: every field within the
    reference's ``isclose`` and atol 1e-5, the flags 0."""
    import numpy as np
    from yalla_tpu_torch.interop import load_settled, pt_to_numpy
    from yalla_tpu_torch.models import sorting as S
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.parallel import dryrun
    from yalla_tpu_torch.parallel._comm import spawn
    from yalla_tpu_torch.solvers import TileEngine, heun_steps
    sp = S.Params()
    X, old_v = load_settled(SETTLED_5K, S.Cell, dev)
    got = spawn(dryrun.run_cells, 2, TileEngine(), "sorting",
                pt_to_numpy(X), pt_to_numpy(old_v), N5_CELLS, sp.dt, 1.0, 2,
                warmup=True, backend="gloo", device="cuda")
    Xs, _, aux = heun_steps(2, TileEngine(pallas=False, mxu=False),
                            S.make_adhesion(sp), friction_w_neighbour,
                            "com", X, old_v, N5_CELLS, sp.dt, 1.0)
    if any(got["flags"].values()):
        raise AssertionError(f"cells-axis path flags set: {got['flags']}")
    worst = 0.0
    for f in S.Cell._fields:
        a = got["X"][f][:N5_CELLS]
        b = getattr(Xs, f)[:N5_CELLS].cpu().numpy()
        worst = max(worst, float(np.abs(a - b).max()))
        if not ((np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all()
                and np.abs(a - b).max() <= 1e-5):
            raise AssertionError(f"cells-axis path field {f}: max abs err "
                                 f"{np.abs(a - b).max():g}")
    print(f"cells-axis path: 2 ranks on the card ({got['transport']}), "
          f"{N5_CELLS} cells in 5120 rows, 2 steps of the windowed plain "
          f"pass: flags {got['flags']}, every field within {worst:.3g} of "
          f"the single-process steps; "
          f"{got['seconds'] * 1e3 / 2:.3f} ms/step on rank 0, transport "
          f"{got['transport_seconds'] * 1e3 / 2:.3f} ms")


def dryruns(dev):
    """Phase 34: ``dryrun_multichip(2)`` and ``dryrun_multichip(4)`` on
    the card (its asserts, K1 launched twice a step in each z-slab frame,
    the last one's ``pallas=False`` included; rank 0 prints its two
    lines)."""
    from yalla_tpu_torch.parallel.dryrun import dryrun_multichip
    for d in (2, 4):
        t0 = time.perf_counter()
        out = dryrun_multichip(d, device="cuda")
        print(f"dryrun_multichip({d}) on the card: {out}, "
              f"{time.perf_counter() - t0:.1f} s with its ranks' start")


def gabriel_windowed_pass(dev):
    """Phase 35 (a): one pass of the windowed Gabriel form at the 100k
    half-space tissue (``GABRIEL_100K``'s grid and NC, the window
    settings of the JAX engine's defaults) against K5 and against the
    gather form: no kernel launched by the windowed pass, every flag 0,
    the friction sums and the flags the forms share exact, F and sum_v
    within ``compare_sums``'s tolerance; ms a pass of each (CUDA
    events).  Returns {form: ms a pass}."""
    import dataclasses

    import torch
    from yalla_tpu_torch.kernel_profile import GABRIEL_100K, gabriel_tissue
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.gabriel_pallas import gabriel_lattice_pallas
    from yalla_tpu_torch.solvers import GabrielEngine
    X, ov, n = gabriel_tissue(NG_CELLS, dev)
    args = (W.relu_force, W.wall_friction, X, ov, n, W.r_max)
    win = GabrielEngine(grid_size=GABRIEL_100K["grid_size"],
                        max_candidates=GABRIEL_100K["max_candidates"],
                        lattice=False)
    gather = dataclasses.replace(win, windowed=False)
    forms = {"windowed": lambda: win.pairwise(*args),
             "gather": lambda: gather.pairwise(*args),
             "K5": lambda: gabriel_lattice_pallas(*args, **GABRIEL_100K)}
    reset_launches()
    outs = {"windowed": forms["windowed"]()}
    torch.cuda.synchronize()
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise AssertionError(f"windowed Gabriel pass launched {launched}")
    outs["gather"], outs["K5"] = forms["gather"](), forms["K5"]()
    for form, out in outs.items():
        flags = {k: float(v.max()) for k, v in out[3].items()}
        if any(flags.values()):
            raise AssertionError(f"Gabriel {form} 100k: flags {flags}")
    errs = {}
    for other in ("K5", "gather"):
        got, want = flatten(outs["windowed"], "", n), \
            flatten(outs[other], "", n)
        common = {k: got[k] for k in want if k in got}
        errs[other] = compare_sums(f"windowed vs {other} 100k", common,
                                   want, {"sum_f", *outs[other][3]})
    ms = {form: cuda_ms(fn, 3 if form == "gather" else 10)
          for form, fn in forms.items()}
    print(f"phase 35 (a) windowed Gabriel pass on the 100k half-space "
          f"tissue ({n} cells in {X.x.shape[0]} rows, grid "
          f"{win.grid_size}, NC {win.max_candidates}, block {win.i_block}, "
          f"subgroup {win.subgroup}, window {win.window_cap}, salvage "
          f"{win.salvage_cap}): no kernel launched, every flag 0, sum_f and "
          f"the shared flags exact against K5 and the gather form, max abs "
          f"err {errs['K5']:.3g} and {errs['gather']:.3g}; ms a pass: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return ms


def relaxation_forms(dev):
    """Phase 35 (b): ``RELAX_STEPS`` steps of the growth_w_wall example's
    relaxation engine (``GabrielEngine(grid_size=64, row_cap=128,
    lattice=False)``, ``windowed`` its default) from the example's seed
    ball (500 cells in 102,400 rows), against the same engine with
    ``windowed=False`` (the gather form): no kernel launched, every flag
    equal and 0, positions within ``isclose``; ms a step of each (CUDA
    events) and the seconds of the example's whole 101-step relaxation on
    the windowed pass (its setup in phase 25).  Returns {form: ms a
    step}."""
    import dataclasses

    import numpy as np
    import torch
    from yalla_tpu_torch import inits
    from yalla_tpu_torch.links import wall_forces
    from yalla_tpu_torch.models import growth_w_wall as W
    from yalla_tpu_torch.ops.common import friction_on_background
    from yalla_tpu_torch.solvers import GabrielEngine
    m = example("growth_w_wall")
    inits.set_seed(2)
    seed = m.seed_ball(dev)
    snap = snapshot(seed)
    relax = GabrielEngine(grid_size=64, row_cap=128, lattice=False)
    engines = {"windowed": relax,
               "gather": dataclasses.replace(relax, windowed=False)}
    ends, flags, ms = {}, {}, {}
    for form, engine in engines.items():
        sol = solution_at(seed, snap, dev, engine)
        reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(RELAX_STEPS):
            aux = sol.take_step(W.dt, W.relu_force,
                                pw_friction=friction_on_background,
                                gen_forces=wall_forces(W.WALL))
        end.record()
        torch.cuda.synchronize()
        ms[form] = start.elapsed_time(end) / RELAX_STEPS
        launched = {k: v for k, v in launch_counts().items() if v}
        if launched:
            raise AssertionError(f"relaxation on the {form} form launched "
                                 f"{launched}")
        flags[form] = {k: float(v.max()) for k, v in aux.items()
                       if k.startswith("__err_")}
        ends[form] = sol.copy_to_host()
    n = seed.h_n
    if flags["windowed"] != {**flags["gather"], "__err_gabriel_window": 0.0} \
            or any(flags["windowed"].values()):
        raise AssertionError(f"relaxation flags: {flags}")
    for f in "xyz":
        a, b = (getattr(ends[k], f)[:n] for k in ("windowed", "gather"))
        if not (np.abs(a - b) <= 1e-6 + 1e-2 * np.abs(b)).all():
            raise AssertionError(f"relaxation field {f}: windowed and "
                                 f"gather disagree (max abs err "
                                 f"{np.abs(a - b).max():g})")
    setup_s = SETUPS["growth_w_wall"][2] if "growth_w_wall" in SETUPS \
        else None
    print(f"phase 35 (b) the growth_w_wall relaxation, {n} cells in "
          f"{seed.n_pad} rows, {RELAX_STEPS} steps on each form: no kernel "
          f"launched, flags {flags['windowed']} (the gather form's equal), "
          f"positions within isclose; ms a step: windowed "
          f"{ms['windowed']:.3f}, gather {ms['gather']:.3f}; the example's "
          f"setup (seed ball and 101 windowed relaxation steps) took "
          + (f"{setup_s:.2f} s" if setup_s is not None else "not run"))
    return ms


def plain_lattice_route(dev, C):
    """Phase 36: ``lattice_heun_steps(pallas=False)`` (JAX's XLA route,
    which has no overflow extras; the port's pour and pair pass still run
    through their kernel wrappers) for ``PLAIN_STEPS`` steps on the
    settled 500k state at grid 64, capacity ``C``, cube 1.0, rebuild 1,
    the branching force, against ``pallas=True`` at the same settings with
    ``extras_cap=0``: ``extras_cap`` refused with ``ValueError`` on
    ``pallas=False``; the launch counts set to 0 just before each route
    and read just after (K1 and K2 twice a step on both), every flag
    equal and 0, x, y and z within ``compare_sums``'s tolerance; ms a step
    of each (CUDA events, after one run of each).  Returns {route: ms a
    step}."""
    import torch
    from yalla_tpu_torch.interop import load_settled
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.ops.common import friction_w_neighbour
    from yalla_tpu_torch.ops.lattice_xla import lattice_heun_steps
    p = B.Params()
    force = B.make_force(p)
    X, ov = load_settled(SETTLED, B.Cell, dev)

    def run(pallas, **kw):
        return lattice_heun_steps(
            PLAIN_STEPS, 1, force, friction_w_neighbour, "com", 64, C, 4, X,
            ov, N_CELLS, p.dt, 1.0, 0, B.precompute, pallas, **kw)
    try:
        run(False, extras_cap=2048)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("phase 36: pallas=False took extras_cap")
    routes = (("pallas=False", False), ("pallas=True", True))
    outs, counts = {}, {}
    for route, pallas in routes:
        reset_launches()
        outs[route] = run(pallas)
        torch.cuda.synchronize()
        counts[route] = {k: v for k, v in launch_counts().items()
                         if v}
    want = {"pour": 2 * PLAIN_STEPS, "lattice_pair": 2 * PLAIN_STEPS}
    if any(c != want for c in counts.values()):
        raise AssertionError(f"phase 36 launches {counts}, expected {want} "
                             f"on each route")
    flags = {route: {k: float(v.max()) for k, v in out[2].items()
                     if k.startswith("__err_")}
             for route, out in outs.items()}
    a, b = (flags[r] for r, _ in routes)
    if a != b or any(a.values()):
        raise AssertionError(f"phase 36 flags: {flags}")
    pos = {route: {f: getattr(out[0], f)[:N_CELLS] for f in "xyz"}
           for route, out in outs.items()}
    err = compare_sums("phase 36 positions, pallas=True vs pallas=False",
                       pos["pallas=True"], pos["pallas=False"], set())
    ms = {route: cuda_ms(lambda: run(pallas), 1) / PLAIN_STEPS
          for route, pallas in routes}
    print(f"phase 36 lattice_heun_steps(pallas=False) at {N_CELLS} cells "
          f"(grid 64, C {C}, cube 1.0, rebuild 1, {PLAIN_STEPS} steps): "
          f"extras_cap refused ({refused}); launches {counts}, flags {a} "
          f"on both routes, positions within the pair-pass tolerance, max "
          f"abs err {err:.3g}; ms a step: pallas=False "
          f"{ms['pallas=False']:.3f}, pallas=True {ms['pallas=True']:.3f}")
    return ms


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
    from yalla_tpu_torch.kernel_profile import card
    from yalla_tpu_torch.models import branching as B
    from yalla_tpu_torch.solvers import LatticeEngine
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
    X, old_v = load_settled(SETTLED, B.Cell, dev)
    print(f"state: {N_CELLS} cells in {X.x.shape[0]} rows; grid "
          f"{engine.grid_size}, C {engine.capacity}, cube {cube}, "
          f"extras_cap {engine.extras_cap}, "
          f"extras_block_cap {engine.extras_block_cap}")

    # ---- K2 and K1 against their plain versions on the 500k build --------
    checks = lattice_kernel_checks("500k", X, old_v, N_CELLS, cube, engine)
    ptxas_report(["pour_kernel"])
    del X, old_v
    thin_checks = thin_cube_checks(dev)
    # phase 31's K1 z_halo checks run here, beside phase 3's: late in the
    # process torch.profiler has returned windows with events missing
    zhalo_check, zhalo_C = zhalo_kernel_checks(dev)

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
    checks["pour"]["max_abs_err"] = max(checks["pour"]["max_abs_err"],
                                        pour_err100k)
    gabriel_gpu_vs_cpu(dev)
    launches["gabriel_pair"] = growth_w_wall_slice(dev)["gabriel_pair"]

    # ---- the flagship growing frame: K3's relaxation functor, the lattice
    # engine's pairwise, the run from a seed, the run at full width --------
    relax_k = relax_kernel_check(dev)
    lattice_engine_gpu_vs_cpu(dev)
    seed_launches = flagship_from_seed(dev)
    full_launches, full_checks = flagship_full_width(dev)

    # ---- the all-pairs examples on K3's functors, then the grid examples -
    states = example_states(dev)
    example_k = example_kernel_checks(dev, states)
    example_gpu_vs_cpu(dev, states)
    example_launches = example_runs(dev, states)
    grid_examples(dev)

    # ---- the last ten examples: K1's intercalation_w_gradient functor,
    # that example at full width, then the other nine -------------------
    iwg_k = iwg_kernel_check(dev)
    iwg_launches = iwg_full_width(dev)
    iwg_gpu_vs_cpu(dev)
    more_examples_gpu_vs_cpu(dev)
    more_launches, k5_example = more_example_runs(dev)
    gww_capacity(dev)
    gww_published(dev)

    # ---- the rest of the lattice integrator: thin x-cubes, slot-space
    # rebinning, the resident cadence, and all of them against the CPU --
    t_cadences = time.perf_counter()
    thin_launches = thin_cubes(dev)
    rebin_cadences(dev)
    resident_cadences(dev)
    cadences_gpu_vs_cpu(dev)
    print(f"phases 27-30: {time.perf_counter() - t_cadences:.1f} s")

    # ---- the multi-device paths: the z-slab path, the cells axis, the dry
    # runs (ranks sharing the card over gloo) -----------------------------
    t_multi = time.perf_counter()
    zslab_launches = zslab_path(dev, zhalo_C + ZSLAB_HEADROOM)
    cells_axis_path(dev)
    dryruns(dev)
    print(f"phases 32-34: {time.perf_counter() - t_multi:.1f} s")

    # ---- the last two routes of the JAX package: the windowed Gabriel
    # pass, and the lattice integrator's XLA route (pallas=False) --------
    t_routes = time.perf_counter()
    gabriel_windowed_pass(dev)
    relaxation_forms(dev)
    plain_lattice_route(dev, zhalo_C)
    print(f"phases 35-36: {time.perf_counter() - t_routes:.1f} s")

    lattice = (("pour", "yalla_tpu_torch/csrc/pour.cu",
                "yalla_tpu/ops/lattice_pour.py:244"),
               ("lattice_pair", "yalla_tpu_torch/csrc/lattice_pair.cu",
                "yalla_tpu/ops/lattice_pallas.py:672"))
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches[name],
                **checks[name]} for name, src, tpu in lattice]
    kernels[1]["z_halo_check"] = "lattice_pair[branching,z_halo]"
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
    err, ms, plain_ms, bound_ms, bound_by, dev_ms = relax_k
    kernels.append({"name": "tile_pair[inits_relu]", "route": "cuda",
                    "source": "yalla_tpu_torch/csrc/tile_pair.cu",
                    "replaces": "yalla_tpu/ops/tile_pallas.py:118",
                    "launches": seed_launches["tile_pair"],
                    "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None})
    # K3 with each all-pairs example's functor, launched by the examples
    for functor, (err, ms, plain_ms, bound_ms, bound_by, dev_ms) in \
            example_k.items():
        kernels.append({"name": f"tile_pair[{functor}]", "route": "cuda",
                        "source": "yalla_tpu_torch/csrc/tile_pair.cu",
                        "replaces": "yalla_tpu/ops/tile_pallas.py:118",
                        "launches": example_launches[functor],
                        "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    # K1 with intercalation_w_gradient's functor, launched by that example
    kernels.append({"name": "lattice_pair[intercalation_w_gradient]",
                    "route": "cuda",
                    "source": "yalla_tpu_torch/csrc/lattice_pair.cu",
                    "replaces": "yalla_tpu/ops/lattice_pallas.py:672",
                    "launches": iwg_launches["lattice_pair"], **iwg_k})
    # K5 at the growth_w_wall example's state, launched by its run
    kernels.append({"name": "gabriel_pair[growth_w_wall]", "route": "cuda",
                    "source": "yalla_tpu_torch/csrc/gabriel_pair.cu",
                    "replaces": "yalla_tpu/ops/gabriel_pallas.py:271",
                    "launches": more_launches["gabriel_pair"],
                    **k5_example})
    # K2 and K1 at the flagship's full width: default_engine's lattice
    kernels += [{"name": f"{name}[flagship]", "route": "cuda", "source": src,
                 "replaces": tpu, "launches": full_launches[name],
                 **full_checks[name]} for name, src, tpu in lattice]
    # K1 at xr = 2 on the thin x-cubes of the 500k state, launched by
    # phase 27's run
    kernels.append({"name": "lattice_pair[branching,x_split=2]",
                    "route": "cuda",
                    "source": "yalla_tpu_torch/csrc/lattice_pair.cu",
                    "replaces": "yalla_tpu/ops/lattice_pallas.py:672",
                    "launches": thin_launches["lattice_pair"],
                    **thin_checks["lattice_pair"]})
    # K1 with z_halo on the 500k lattice in 2 slabs, launched by a rank of
    # phase 32's z-slab run
    kernels.append({"name": "lattice_pair[branching,z_halo]",
                    "route": "cuda",
                    "source": "yalla_tpu_torch/csrc/lattice_pair.cu",
                    "replaces": "yalla_tpu/ops/lattice_pallas.py:672",
                    "launches": zslab_launches, **zhalo_check})
    # each kernel's launches on the flagship's paths and on the examples'
    # runs of phases 22 and 25, beside its own path's
    for k in kernels:
        name = k["name"].split("[")[0]
        k["flagship_seed_launches"] = seed_launches[name]
        k["flagship_full_width_launches"] = full_launches[name]
        k["more_examples_launches"] = iwg_launches[name] \
            + more_launches[name]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from yalla_tpu_torch.utils import profiling
    with profiling.tracing():
        main()
