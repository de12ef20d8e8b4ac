"""The readings that the model_features_sequential_addition cell's limits of
``correct`` are set from, at the cell's own size: for each seed, the
window's least run of intervals (one segment of the published run) once
for each of ``--segments`` draws of the five sampled steps, then the
compared numbers of the program, of the control (the reference in
bfloat16 in the program's place, and the file's values rounded to
bfloat16) and of each fault, all against the float32 reference.  A fault
is planted in the program for a further run of the same loop
(:func:`faults`).

    python3 perfbench/calibrate_mfsa.py --workload <cell> --seeds <n> [<n> ...]
        [--segments <k>] [--control <k>] [--faults <k>] [--every-step <k>]

One JSON line per seed; the control and the faults run on the first
``k`` seeds.  With ``--every-step``, the first ``k`` seeds also sample
every step of a segment and report each compared number's largest
readings and how many steps read above each of a few thresholds (how
often a sound step reads what).  The benchmark's own runs never run
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def faults(loop):
    """The faults the program can have, each a context manager that plants
    it in the loop's program: the protrusions' pull left out; the
    rewiring's draws shifted by one protrusion; old_v returned stale by
    the Heun step; a step's last division dropped; the epithelial bending
    and the decay of w left out of the force; the neighbours' friction in
    the first part in place of the background's; the epithelium taken
    from one mesenchymal neighbour more; and the source reaching x > 0.9.
    """
    import torch
    from yalla_tpu_torch import links as L
    from yalla_tpu_torch import solvers
    from yalla_tpu_torch.dtypes import pt_zeros_like
    ex = loop.ex

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

    def no_pull(links):
        return solvers.GenericForce(fn=lambda X, n, args: pt_zeros_like(X),
                                    args=links.state, fields=("x", "y", "z"))

    real_force = ex.force

    def no_decay(Xi, r, dist, i, j):
        dF, aux = real_force(Xi, r, dist, i, j)
        back = (i == j) & (Xi.ctype == ex.MESENCHYME) & (Xi.w >= 0)
        return dF.replace(w=dF.w + torch.where(back, 0.01 * Xi.w, 0.0)), aux

    real_epithelium = ex.make_epithelium

    def one_more(cells, mes_nbs):
        return real_epithelium(cells, mes_nbs + 1)

    real_source = ex.add_source

    def wider(cells):
        real_source(cells)
        X, n = cells.d_X, cells.get_d_n()
        rows = torch.arange(X.x.shape[0], device=X.x.device)
        cells.d_X = X.replace(w=torch.where(
            (X.x > 0.9) & (rows < n), 1.0, X.w))

    def patch(name, new):
        return lambda: mock.patch.object(ex, name, new)

    return {
        "links_left_out": patch("link_forces", no_pull),
        "rewiring_shifted": lambda: mock.patch.object(L.Links, "update",
                                                      shifted),
        "old_v_stale": lambda: mock.patch.object(solvers, "heun_step",
                                                 stale),
        "division_dropped": patch("proliferate", dropped),
        "bending_left_out": patch(
            "bending_force_fast",
            lambda Xi, r, dist, *a, **k: pt_zeros_like(Xi)),
        "decay_left_out": patch("force", no_decay),
        "background_friction_lost": patch("friction_on_background",
                                          solvers.friction_w_neighbour),
        "surface_shifted": patch("make_epithelium", one_more),
        "source_widened": patch("add_source", wider)}


def every_step(loop, harness):
    """The compared numbers of every step of a segment: each number's
    five largest readings and the steps above 0, 1e-6, 1e-4, 1e-3, 1e-2
    and 1e-1."""
    from perfbench.loops.model_features import compare
    loop.picks = set(range(loop.F))
    loop.restart()
    harness.window(loop, 0.0)
    steps, _ = loop.reference_outputs()
    rows = [compare(after, want, loop.cfg["tolerance"])
            for (*_, after), want in zip(loop.samples, steps)]
    out = {"steps": len(rows)}
    for key in rows[0] if rows else ():
        vals = sorted((r[key] for r in rows), reverse=True)
        out[key] = {"top": vals[:5], "above": {
            str(t): sum(v > t for v in vals)
            for t in (0, 1e-6, 1e-4, 1e-3, 1e-2, 1e-1)}}
    return out


def worst(rows):
    """Each number's largest reading over ``rows`` (None where a row has
    none)."""
    return {k: (None if any(r[k] is None for r in rows)
                else max(r[k] for r in rows)) for k in rows[0]}


def counts(loop):
    """The sampled steps and the cell count before each."""
    return {"picks": sorted(loop.picks), "n_before": [
        before["n"] for _, _, before, _, _ in loop.samples]}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--segments", type=int, default=3)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--every-step", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import harness
    from perfbench.calibrate_gww import judged
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_mfsa: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        loop = harness.load_cell(ROOT, args.workload, seed, "cuda")[3]
        T = loop.T
        rows, picks = [], []
        for r in range(args.segments):
            if r:
                rng = np.random.default_rng([seed, 7, r])
                loop.picks = {int(rng.integers(j * (T + 1), (j + 1) * (T + 1)))
                              for j in range(5)}
            sound, refs = judged(loop, harness)
            rows.append(sound)
            picks.append(counts(loop))
        line = {"workload": args.workload, "seed": seed, "picks": picks,
                "program": worst(rows), "segments": rows,
                "loop": dict(loop.counts)}
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
        raise SystemExit(f"calibrate_mfsa: loaded {bad}")


if __name__ == "__main__":
    main(sys.argv[1:])
