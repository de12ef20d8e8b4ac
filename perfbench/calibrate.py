"""The readings that the limits of ``correct`` are set from, at a cell's
own size: for each seed, the window's least run of intervals, then the
compared numbers of the program, of the control (the reference in
bfloat16 in the program's place, and the file's positions rounded to
bfloat16) and of each fault, all against the float32 reference.  Faults
of a substep's output are planted in the program's output; faults of the
frame's hand-offs run the window again with a frame built from the
program's own that drops a substep, repeats one, or hands old_v on stale.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control <k>] [--faults <k>]

One JSON line per seed; the control and the faults run on the first
``k`` seeds.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def faults(seed):
    """The faults a substep's output can have, each as ``plant(state_in,
    out) -> out``: the state returned unchanged, half the cells left as
    they were, one answer altered where it is produced, old_v zeroed, and
    old_v returned stale (the input's)."""
    import torch
    rng = np.random.default_rng([seed, 11])

    def unchanged(st_in, out):
        return dict(st_in, nodes=0)

    def half(st_in, out):
        n = st_in["n"]
        X = {}
        for f, a in out["X"].items():
            a = a.clone()
            a[:n:2] = st_in["X"][f][:n:2]
            X[f] = a
        return dict(out, X=X)

    def altered(st_in, out):
        k = int(rng.integers(st_in["n"]))
        X = dict(out["X"])
        X["x"] = X["x"].clone()
        X["x"][k] += 1.0
        return dict(out, X=X)

    def old_v_zeroed(st_in, out):
        return dict(out, old_v=[torch.zeros_like(v) for v in out["old_v"]])

    def old_v_stale(st_in, out):
        return dict(out, old_v=list(st_in["old_v"]))
    return {"unchanged": unchanged, "half": half, "altered": altered,
            "old_v_zeroed": old_v_zeroed, "old_v_stale": old_v_stale}


def frame_faults(loop):
    """Frames built from the program's own whose hand-offs are at fault:
    one substep dropped, one repeated, and old_v handed on stale (every
    substep given the frame's input old_v)."""
    import torch
    B, p, e, s = loop.B, loop.p, loop.engine, loop.substeps
    short, long_, one = (B.make_frame(p, e, substeps=k)
                         for k in (s - 1, s + 1, 1))

    def drop(state, t, draws):
        return short(state, t, draws=draws)

    def repeat(state, t, draws):
        return long_(state, t, draws=draws + draws[-1:])

    def stale(state, t, draws):
        st, errs = state, {}
        for k in range(s):
            st, e_k = one(st._replace(old_v=state.old_v), t,
                          draws=draws[k:k + 1])
            errs = {n: torch.maximum(errs[n], v) if n in errs else v
                    for n, v in e_k.items()}
        return st, errs
    return {"substep_dropped": drop, "substep_repeated": repeat,
            "old_v_handed_stale": stale}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False

    def sampled(seed, frame_fault=None):
        """A loop after the window's least run, under ``frame_fault``
        where given, its program state freed."""
        loop = harness.load_cell(ROOT, args.workload, seed, "cuda")[3]
        if frame_fault is not None:
            loop.frame = frame_faults(loop)[frame_fault]
            loop.restart()
        harness.window(loop, 0.0)
        loop.release()
        return loop

    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        loop = sampled(seed)
        refs = loop.reference_outputs()
        line = {"workload": args.workload, "seed": seed,
                "program": dict(loop.readings(refs=refs),
                                handoff_gap=loop.handoff_gap(),
                                file_gap=loop.file_gap())}
        if k < args.control:
            line["control"] = dict(loop.readings(control=True, refs=refs),
                                   file_gap=loop.file_gap(control=True))
        if k < args.faults:
            line["faults"] = {name: loop.readings(plant=plant, refs=refs)
                              for name, plant in faults(seed).items()}
        loop.cleanup()
        del loop, refs
        torch.cuda.empty_cache()
        if k < args.faults:
            for name in ("substep_dropped", "substep_repeated",
                         "old_v_handed_stale"):
                loop = sampled(seed, name)
                line["faults"][name] = dict(loop.readings(),
                                            handoff_gap=loop.handoff_gap())
                loop.cleanup()
                del loop
                torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    bad = harness.forbidden_modules()
    if bad:
        raise SystemExit(f"calibrate: loaded {bad}")


if __name__ == "__main__":
    main(sys.argv[1:])
