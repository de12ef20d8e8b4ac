"""yalla's growth_w_wall example (``examples/growth_w_wall.cu``) as a user
runs it, through the port's example module
(``yalla_tpu_torch/examples/growth_w_wall.py``): the seed ball drawn and
relaxed against the wall (``setup``), then the published run, every step
``step`` (the protrusions rewired, a Heun step on the Gabriel lattice
engine with the wall and the protrusions, the divisions) and every
``frame_every`` steps the frame's file (``write_frame``: positions,
protrusions, cell types) written by a VTK writer as the example's ``run``
makes it, in the calling thread.  The example's ``take_step`` reads the
flags back every step and raises on one.

The window replays segments, each the published run from the held
relaxed state: ``time_steps + 1`` steps, the protrusions' and the
divisions' generators seeded from the run's seed by ``start``, so every
segment makes the same draws.  One interval is one frame: the first of a
segment is step 0 and its file, every other ``frame_every`` steps and
their file.

The check follows the reference (``perfbench/reference/growth_w_wall.py``)
through three steps of the first segment, drawn from the seed: step 0,
one near the middle of the run and one near its end, each from the
program's own state before it, which a spy on ``Links.update``,
``Solution.take_step``, ``proliferate`` (the example's) and
``GabrielEngine.pairwise`` keeps (references only; it fills in the draws
a call would make where the call is given none, from the same generator,
so the stream is the program's).  Whole segments are not compared: the
band's jump at the cutoff and the Gabriel test part two f32 trajectories
within a few steps.  In every frame that holds a sampled step the spy
also checks each hand-off: every call takes what the calls before it
returned, and each is made once a step.  The check reads back the
window's first file.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import os
import shutil
import tempfile
from unittest import mock

import numpy as np
import torch

from perfbench.loops.frames import differs
from perfbench.reference import growth_w_wall as ref

XYZ = ref.XYZ
# the numbers :func:`compare` gives
COMPARED = ("links_gap", "n_gap", "gabriel_gap", "off_share",
            "old_v_share", "pos_gap")
# the engine's settings the configuration states
ENGINE_KEYS = ("grid_size", "row_cap", "capacity", "max_candidates",
               "gabriel_coefficient")


def compare(out, want, tol):
    """The numbers a step is judged by, from the program's state after it
    (``out``) and the reference's (``want``), dicts with ``X``,
    ``old_v``, ``n``, ``a``, ``b`` and ``kept`` (the first pass's kept
    Gabriel neighbours of each cell): the protrusion rows that differ,
    the gap in the count of cells, the kept neighbours that differ summed
    over the cells, the share of cells off in a position beyond
    ``tol["pos"]``, the share whose old_v is off beyond ``tol["old_v"]``
    (relative to ``1 + |old_v|``), and the widest gap of a position."""
    n = min(out["n"], want["n"])
    dev = want["X"]["x"].device
    links = (out["a"] != want["a"]) | (out["b"] != want["b"])
    off = torch.zeros(n, dtype=torch.bool, device=dev)
    gap2 = torch.zeros(n, dtype=torch.float64, device=dev)
    for f in XYZ:
        d = out["X"][f][:n].double() - want["X"][f][:n].double()
        gap2 = gap2 + d * d
        off = off | ~(d.abs() <= tol["pos"])
    v_off = torch.zeros(n, dtype=torch.bool, device=dev)
    for a, b in zip(out["old_v"], want["old_v"]):
        a, b = a[:n].double(), b[:n].double()
        v_off = v_off | ~((a - b).abs() <= tol["old_v"] * (1 + b.abs()))
    kept = (out["kept"].double() - want["kept"].double()).abs()
    return {"links_gap": float(links.sum()),
            "n_gap": float(abs(out["n"] - want["n"])),
            "gabriel_gap": float(kept.sum()),
            "off_share": float(off.double().mean()),
            "old_v_share": float(v_off.double().mean()),
            "pos_gap": float(torch.sqrt(gap2.max()))}


def link_args(gen):
    """The protrusions' ends and count a generic force of ``links.py``
    takes (``link_forces``: the table's state; ``link_wall_forces``: it
    and the wall node's row), None where it takes none."""
    args = getattr(gen, "args", None)
    if isinstance(args, tuple) and len(args) == 2 and \
            isinstance(args[0], tuple):
        args = args[0]
    if isinstance(args, tuple) and len(args) == 4:
        return args[:3]
    return None


class Spy:
    """Watches one frame's calls of ``Links.update``,
    ``Solution.take_step``, the example's ``proliferate`` and
    ``GabrielEngine.pairwise``: keeps what the steps ``ks`` (of the
    segment) take and return, counts the calls, and compares every
    hand-off: each call takes what the calls before it returned, the
    frame's first step the frame's input state, and the frame ends in what
    its last step made."""

    def __init__(self, loop, t0, ks):
        self.loop, self.ks = loop, ks
        self.t = t0               # the step under way
        cells, links = loop.cells, loop.state.links
        # what the next call must take: positions, old_v, count, the
        # protrusions' ends
        self.X, self.old_v, self.n = cells.d_X, cells.d_old_v, cells.d_n
        self.a, self.b, self.n_links = links.d_a, links.d_b, links.d_n
        self.calls = {"update": 0, "take_step": 0, "proliferate": 0,
                      "pairwise": 0}
        self.seen = {}
        self.passes = None
        self.gaps = []

    def record(self, key, value):
        if self.t in self.ks:
            self.seen.setdefault(self.t, {})[key] = value

    def wrap_update(self, real):
        spy = self

        def update(links, rule, cells, draws=None):
            if draws is None:
                draws = links.draws(rule)
            spy.calls["update"] += 1
            spy.gaps.append(differs((cells.d_X, cells.d_n, links.d_a,
                                     links.d_b),
                                    (spy.X, spy.n, spy.a, spy.b)))
            spy.record("before", {"X": cells.d_X, "n": cells.d_n,
                                  "a": links.d_a, "b": links.d_b,
                                  "links_max": links.n_max,
                                  "n_links": links.d_n, "draws": draws})
            out = real(links, rule, cells, draws=draws)
            spy.a, spy.b, spy.n_links = links.d_a, links.d_b, links.d_n
            spy.record("links", (links.d_a, links.d_b))
            return out
        return update

    def wrap_take_step(self, real):
        spy = self

        def take_step(cells, dt, pw_int, **kw):
            spy.calls["take_step"] += 1
            spy.gaps.append(differs(
                (cells.d_X, cells.d_old_v, cells.d_n,
                 link_args(kw.get("gen_forces"))),
                (spy.X, spy.old_v, spy.n, (spy.a, spy.b, spy.n_links))))
            spy.record("old_v", cells.d_old_v)
            spy.passes = []
            try:
                out = real(cells, dt, pw_int, **kw)
            finally:
                spy.record("kept", spy.passes[0] if spy.passes else None)
                spy.passes = None
            spy.X, spy.old_v = cells.d_X, cells.d_old_v
            return out
        return take_step

    def wrap_pairwise(self, real):
        spy = self

        def pairwise(engine, *args, **kwargs):
            out = real(engine, *args, **kwargs)
            spy.calls["pairwise"] += 1
            if spy.passes is not None:
                spy.passes.append(out[1])
            return out
        return pairwise

    def wrap_proliferate(self, real):
        spy = self
        from yalla_tpu_torch.growth import draw

        def proliferate(want_fn, child_fn, X, old_v, n, generator=None,
                        *args, **kwargs):
            if kwargs.get("draws") is None:
                kwargs["draws"] = draw(generator, X.x.shape[0], X.x.device)
            spy.calls["proliferate"] += 1
            spy.gaps.append(differs((X, old_v, n),
                                    (spy.X, spy.old_v, spy.n)))
            spy.record("draws", kwargs["draws"])
            out = real(want_fn, child_fn, X, old_v, n, generator, *args,
                       **kwargs)
            spy.X, spy.old_v, spy.n = out[0], out[1], out[2]
            spy.record("after", out[:3])
            spy.t += 1
            return out
        return proliferate

    def __enter__(self):
        from yalla_tpu_torch.links import Links
        from yalla_tpu_torch.solvers import GabrielEngine, Solution
        ex = self.loop.ex
        self.patches = [
            mock.patch.object(Links, "update",
                              self.wrap_update(Links.update)),
            mock.patch.object(Solution, "take_step",
                              self.wrap_take_step(Solution.take_step)),
            mock.patch.object(GabrielEngine, "pairwise",
                              self.wrap_pairwise(GabrielEngine.pairwise)),
            mock.patch.object(ex, "proliferate",
                              self.wrap_proliferate(ex.proliferate))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()

    def finish(self, steps):
        """The frame's end state against what its last step made, and the
        calls of each name against ``steps`` (``pairwise`` twice a
        step)."""
        cells, links = self.loop.cells, self.loop.state.links
        self.gaps.append(differs(
            (cells.d_X, cells.d_old_v, cells.d_n, links.d_a, links.d_b),
            (self.X, self.old_v, self.n, self.a, self.b)))
        want = {"update": steps, "take_step": steps, "proliferate": steps,
                "pairwise": 2 * steps}
        self.gaps += [abs(self.calls[k] - v) for k, v in want.items()]

    def samples(self):
        """One sample a recorded step: (step, the state before it in the
        reference's form with its draws, the program's state after it)."""
        out = []
        for t, seen in sorted(self.seen.items()):
            if len(seen) < 6 or seen["kept"] is None:
                continue        # a short step: finish() counts its calls
            bf = seen["before"]
            draws = seen["draws"]
            before = {"X": {f: getattr(bf["X"], f) for f in XYZ},
                      "old_v": list(seen["old_v"]), "n": int(bf["n"]),
                      "a": bf["a"], "b": bf["b"],
                      "links_max": bf["links_max"]}
            link_draws = tuple(bf["draws"])
            growth_draws = (draws.rnd, tuple(draws.direction))
            X, old_v, n = seen["after"]
            a, b = seen["links"]
            after = {"X": {f: getattr(X, f) for f in XYZ},
                     "old_v": list(old_v), "n": int(n), "a": a, "b": b,
                     "kept": seen["kept"]}
            out.append((t, before, (link_draws, growth_draws), after))
        return out


def read_vtk(path):
    """(points ``[n, 3]``, protrusions ``[m, 2]``, cell types ``[n]``) of
    a legacy ASCII VTK file of the example's frame; raises where a section
    is missing or malformed."""
    with open(path, "rb") as f:
        words = f.read().split()
    k = words.index(b"POINTS")
    n = int(words[k + 1])
    pts = np.array(words[k + 3:k + 3 + 3 * n], dtype=np.float64)
    k = words.index(b"LINES")
    m = int(words[k + 1])
    lines = np.array(words[k + 3:k + 3 + 3 * m], dtype=np.int64).reshape(
        m, 3)
    if m and not (lines[:, 0] == 2).all():
        raise ValueError(f"{path}: a LINES entry is not a pair")
    k = words.index(b"cell_type")
    types = np.array(words[k + 4:k + 4 + n], dtype=np.int64)
    return pts.reshape(n, 3), lines[:, 1:], types


class Loop:
    """One cell's run of the example: set up (the relaxed state, the
    writer, a warm-up segment) on construction, then :meth:`interval`
    per frame."""

    def __init__(self, cfg, traffic, seed, device):
        from yalla_tpu_torch.solvers import SimulationError
        from yalla_tpu_torch.vtkio import Vtk_output
        self.SimulationError = SimulationError
        self.ex = ex = importlib.import_module(
            "yalla_tpu_torch.examples.growth_w_wall")
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.dev = torch.device(device)
        self.T = int(cfg["time_steps"])
        self.every = int(cfg["frame_every"])
        published = {"n_0": ex.n_0, "n_max": ex.n_max,
                     "time_steps": ex.n_time_steps,
                     "relax_steps": ex.relax_steps,
                     "frame_every": max(1, ex.n_time_steps // 100)}
        stated = {k: cfg[k] for k in published}
        if stated != published:
            raise ValueError(f"the configuration states {stated}, the "
                             f"example runs {published}")
        self.cells = cells = ex.setup(device, self.seed)
        engine = {k: getattr(cells.engine, k) for k in ENGINE_KEYS}
        if engine != cfg["engine"]:
            raise ValueError(f"the configuration states the engine "
                             f"{cfg['engine']}, the example runs {engine}")
        # the growth runs on the Gabriel lattice pass: kernel K5 on the
        # card (where the example's engine resolves to it), its plain
        # version on the CPU
        cells.engine = dataclasses.replace(cells.engine, lattice=True)
        self.held = (cells.d_X, cells.d_old_v, cells.get_d_n())
        self.cell_type = ex.cell_types(cells)
        self.F = self.T // self.every + 1
        rng = np.random.default_rng([self.seed, 7])
        T, w = self.T, self.T // 50
        self.picks = {0, int(rng.integers(T // 2 - w, T // 2 + w + 1)),
                      int(rng.integers(T - 2 * w, T + 1))}
        self.out_dir = os.path.join(tempfile.gettempdir(), "perfbench_gww")
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.writer = Vtk_output("gww", self.out_dir, verbose=False)
        self.trace_states = None
        self.min_intervals = self.F
        # warm-up: one segment and its files
        self.restart()
        for _ in range(self.F):
            self.interval()
        for name in os.listdir(self.out_dir):
            os.remove(os.path.join(self.out_dir, name))
        self.restart()

    def restart(self):
        """Back to the window's first frame, with nothing recorded."""
        self.count = self.failed = 0
        self.counts = {"segments": 0, "flagged": 0}
        self.samples, self.file_sample, self.handoffs = [], None, []

    def segment_start(self):
        """The held relaxed state and a fresh run (``start``: the step
        index, the protrusions, both generators seeded from the seed)."""
        cells = self.cells
        cells.d_X, cells.d_old_v, cells.d_n = self.held
        self.state = self.ex.start(cells, self.T, seed=self.seed)
        self.counts["segments"] += 1

    def steps_of(self, f):
        """The steps of frame ``f`` of a segment: step 0, else the
        ``frame_every`` steps that end at ``f * frame_every``."""
        if f == 0:
            return range(0, 1)
        return range((f - 1) * self.every + 1, f * self.every + 1)

    def interval(self):
        """One frame: its steps, then its file written.  Returns
        (cell-steps, Heun steps)."""
        s, f = divmod(self.count, self.F)
        if f == 0:
            self.segment_start()
        cells = self.cells
        steps = self.steps_of(f)
        first = (cells.d_X, cells.get_d_n())
        ks = self.picks & set(steps) if s == 0 else set()
        cell_steps = 0
        try:
            if ks:
                with Spy(self, steps[0], ks) as spy:
                    cell_steps = self.run_steps(steps)
                spy.finish(len(steps))
                self.samples += spy.samples()
                self.handoffs += spy.gaps
            else:
                cell_steps = self.run_steps(steps)
        except self.SimulationError:
            # a flag: the rest of the segment is not run
            self.failed += 1
            self.counts["flagged"] += 1
            self.count = (s + 1) * self.F
            return cell_steps, len(steps)
        self.write()
        if self.trace_states is not None:
            self.trace_states.append((first, (cells.d_X, cells.get_d_n()),
                                      len(steps)))
        self.count += 1
        return cell_steps, len(steps)

    def run_steps(self, steps):
        cells, cell_steps = self.cells, 0
        for _ in steps:
            cell_steps += cells.get_d_n()
            self.ex.step(cells, self.state)
        return cell_steps

    def write(self):
        """Write the frame's file (``write_frame``); the window's first
        file is kept for the check."""
        cells, links = self.cells, self.state.links
        path = f"{self.writer.output_dir}gww_{self.writer.time_step}.vtk"
        self.ex.write_frame(self.writer, cells, self.state, self.cell_type)
        if self.file_sample is None:
            n, m = cells.get_d_n(), links.get_d_n()
            self.file_sample = (path, cells.d_X, n, links.d_a[:m],
                                links.d_b[:m])

    def close(self):
        """End of the window: nothing is left to write (the writer
        writes in the calling thread)."""

    def trace_begin(self):
        """Bring the window, untraced, to the frame from which the traced
        window's ``trace_intervals`` frames end the first segment."""
        start = max(0, self.F - int(self.traffic["trace_intervals"]))
        while self.count < start:
            self.interval()
        self.trace_states = []

    def trace_end(self):
        pass

    def pass_states(self):
        """The traced window's states, each with the Gabriel passes it
        stands for: a frame's two passes a step split between its first
        and its last state."""
        out = []
        for a, b, steps in self.trace_states or ():
            for X, n in (a, b):
                out.append(((X.x, X.y, X.z), n, steps))
        return out

    def release(self):
        """Free what the check and the readers do not read: the writer
        (its files written) and the run; the samples and the traced
        window's states stay."""
        self.writer.close()
        self.state = None
        self.cells = None
        self.held = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, dtype=torch.float32):
        """The reference's state after each sampled step, from the same
        state before it and the same draws."""
        out = []
        for _, before, (link_draws, growth_draws), _ in self.samples:
            r = ref.step(before, link_draws, growth_draws, dtype)
            r["X"] = {f: v.float() for f, v in r["X"].items()}
            r["old_v"] = [v.float() for v in r["old_v"]]
            r["kept"] = r["kept"].float()
            out.append(r)
        return out

    def readings(self, control=False, refs=None):
        """The compared numbers, each the worst over the sampled steps:
        the program's (or, with ``control``, the reference's in bfloat16
        in its place); None where nothing was sampled."""
        tol = self.cfg["tolerance"]
        refs = refs if refs is not None else self.reference_outputs()
        outs = self.reference_outputs(torch.bfloat16) if control \
            else [after for *_, after in self.samples]
        worst = dict.fromkeys(COMPARED)
        for out, want in zip(outs, refs):
            for key, v in compare(out, want, tol).items():
                worst[key] = v if worst[key] is None else max(worst[key], v)
        if len(refs) < len(self.picks):
            worst = dict.fromkeys(COMPARED)
        return worst

    def file_gap(self, control=False):
        """The widest relative gap between the positions in the window's
        first file and the state it was written from; infinite where the
        file's point count, protrusions or cell types are not the
        state's.  With ``control``, of the state's positions rounded to
        bfloat16 in the file's place."""
        if self.file_sample is None:
            return None
        path, X, n, a, b = self.file_sample
        want = torch.stack([X.x, X.y, X.z], 1)[:n]
        if control:
            pts = want.bfloat16().double().cpu().numpy()
        else:
            pts, lines, types = read_vtk(path)
            links = torch.stack([a, b], 1).cpu().numpy()
            cell_type = np.r_[0, np.ones(n - 1, np.int64)]
            if pts.shape[0] != n or lines.shape != links.shape \
                    or (lines != links).any() or types.shape != (n,) \
                    or (types != cell_type).any():
                return math.inf
        want = want.double().cpu().numpy()
        return float(np.max(np.abs(pts - want)
                            / np.maximum(np.abs(want), 1e-30)))

    def handoff_gap(self):
        """Hand-offs in the sampled frames whose state differs from what
        the call before made, and calls short of or beyond a step's."""
        return float(sum(int(g) for g in self.handoffs))

    def checks(self):
        """{name: value}: the numbers that decide ``correct``."""
        out = self.readings()
        out["handoff_gap"] = self.handoff_gap()
        out["file_gap"] = self.file_gap()
        out["failed"] = float(self.failed)
        return out

    def cleanup(self):
        shutil.rmtree(self.out_dir, ignore_errors=True)
