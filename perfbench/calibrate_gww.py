"""The readings that the growth_w_wall cell's limits of ``correct`` are set
from, at the cell's own size: for each seed, the window's least run of
intervals (one segment), then the compared numbers of the program, of the
control (the reference in bfloat16 in the program's place, and the file's
positions rounded to bfloat16) and of each fault, all against the
float32 reference.  A fault is planted in the program for a second run of
the same loop (:func:`faults`).

    python3 perfbench/calibrate_gww.py --workload <cell> --seeds <n> [<n> ...]
        [--control <k>] [--faults <k>] [--every-step <k>]

One JSON line per seed; the control and the faults run on the first
``k`` seeds.  With ``--every-step``, the first ``k`` seeds also sample
every step of a segment and report each compared number's largest
readings and how many steps read above each of a few thresholds (how
often a sound step reads what).  The benchmark's own runs never run
this.
"""
import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent


def faults(loop):
    """The faults the program can have, each a context manager that plants
    it in the loop's program: a Gabriel neighbour kept that the test
    should prune, or pruned where it should be kept (the coefficient 0.7
    or 0.9 in place of 0.8); the protrusions' forces or the wall's left
    out; the rewiring's draws shifted by one protrusion; old_v returned
    stale by the Heun step; a step's last division dropped."""
    from yalla_tpu_torch import links as L
    from yalla_tpu_torch import solvers
    ex = loop.ex

    @contextlib.contextmanager
    def coefficient(value):
        engine = loop.cells.engine
        loop.cells.engine = dataclasses.replace(engine,
                                                gabriel_coefficient=value)
        try:
            yield
        finally:
            loop.cells.engine = engine

    def forces(make):
        return mock.patch.object(ex, "link_wall_forces", make)

    real_update = L.Links.update

    def shifted(links, rule, cells, draws=None):
        draws = links.draws(rule) if draws is None else draws
        return real_update(links, rule, cells,
                           draws=type(draws)(*(d.roll(1) for d in draws)))

    real_heun = solvers.heun_step

    def stale(*args, **kwargs):
        X, _, aux = real_heun(*args, **kwargs)
        return X, args[5], aux

    real_proliferate = ex.proliferate

    def dropped(*args, **kwargs):
        out = real_proliferate(*args, **kwargs)
        if out[4].n_divided:
            out = (out[0], out[1], out[2] - 1) + tuple(out[3:])
        return out
    return {
        "gabriel_kept": lambda: coefficient(0.7),
        "gabriel_pruned": lambda: coefficient(0.9),
        "links_left_out": lambda: forces(lambda links, wall:
                                         L.wall_forces(wall)),
        "wall_left_out": lambda: forces(lambda links, wall:
                                        L.link_forces(links)),
        "rewiring_shifted": lambda: mock.patch.object(L.Links, "update",
                                                      shifted),
        "old_v_stale": lambda: mock.patch.object(solvers, "heun_step",
                                                 stale),
        "division_dropped": lambda: mock.patch.object(ex, "proliferate",
                                                      dropped)}


def judged(loop, harness):
    """The loop's checks after the window's least run, and its
    reference's outputs."""
    loop.restart()
    harness.window(loop, 0.0)
    refs = loop.reference_outputs()
    out = dict(loop.readings(refs=refs), handoff_gap=loop.handoff_gap(),
               file_gap=loop.file_gap(), failed=float(loop.failed))
    return out, refs


def every_step(loop, harness):
    """The compared numbers of every step of a segment: each number's
    five largest readings and the steps above 1e-6, 1e-4, 1e-3, 1e-2 and
    1e-1."""
    from perfbench.loops.growth_w_wall import compare
    loop.picks = set(range(loop.T + 1))
    loop.restart()
    harness.window(loop, 0.0)
    refs = loop.reference_outputs()
    rows = [compare(after, want, loop.cfg["tolerance"])
            for (*_, after), want in zip(loop.samples, refs)]
    out = {"steps": len(rows)}
    for key in rows[0] if rows else ():
        vals = sorted((r[key] for r in rows), reverse=True)
        out[key] = {"top": vals[:5], "above": {
            str(t): sum(v > t for v in vals)
            for t in (1e-6, 1e-4, 1e-3, 1e-2, 1e-1)}}
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--every-step", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_gww: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        loop = harness.load_cell(ROOT, args.workload, seed, "cuda")[3]
        sound, refs = judged(loop, harness)
        line = {"workload": args.workload, "seed": seed, "program": sound,
                "counts": dict(loop.counts)}
        if k < args.control:
            line["control"] = dict(loop.readings(control=True, refs=refs),
                                   file_gap=loop.file_gap(control=True))
        if k < args.faults:
            line["faults"] = {}
            for name, plant in faults(loop).items():
                with plant():
                    line["faults"][name] = judged(loop, harness)[0]
        if k < args.every_step:
            line["every_step"] = every_step(loop, harness)
        loop.release()
        loop.cleanup()
        del loop, refs
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        raise SystemExit(f"calibrate_gww: loaded {bad}")


if __name__ == "__main__":
    main(sys.argv[1:])
