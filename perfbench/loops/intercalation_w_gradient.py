"""yalla's intercalation_w_gradient example
(``examples/intercalation_w_gradient.cu``) as a user runs it, through the
port's example module (``yalla_tpu_torch/examples/
intercalation_w_gradient.py``): the embryo of the repository's
``examples/sphere_ic.vtk`` (``setup``), then the published run, every
step its frame (``write_frame``: positions, protrusions, cell types, w
and f) written by a VTK writer as the example's ``run`` writes it, in the
calling thread, then ``step`` (the protrusions rewired, a Heun step on
the lattice engine with the protrusions' pull, the divisions).  The
example's ``take_step`` reads the flags back every step and raises on
one.

The window replays segments, each the published run from the held
embryo: ``time_steps + 1`` steps, the protrusions' and the divisions'
generators seeded from the run's seed by ``start``, so every segment
makes the same draws.  One interval is one step and the frame written
before it.  A segment's files are deleted when the next segment starts
(the window's first file, which the check reads, is kept), so a run keeps
at most one segment's files on disk.

The check follows the reference
(``perfbench/reference/intercalation_w_gradient.py``) through three steps
of the first segment, drawn from the seed: step 0, one near the middle of
the run and one near its end, each from the program's own state before
it, which a spy on ``Links.update``, ``Solution.take_step`` and
``proliferate`` (the example's) keeps (references only; it fills in the
draws a call would make where the call is given none, from the same
generator, so the stream is the program's).  Whole segments are not
compared: the forces' jump at the cutoff parts two f32 trajectories
within a few steps.  In every sampled step the spy also checks each
hand-off: every call takes what the calls before it returned, and each
is made once.  The check reads back the window's first file.
"""
from __future__ import annotations

import hashlib
import importlib
import math
import os
import shutil
import tempfile
from unittest import mock

import numpy as np
import torch

from perfbench.loops.frames import differs, unit
from perfbench.loops.growth_w_wall import link_args
from perfbench.reference import intercalation_w_gradient as ref

FIELDS = ref.FIELDS
XYZ = ref.XYZ
# the numbers :func:`compare` gives
COMPARED = ("links_gap", "n_gap", "nbs_gap", "off_share", "wf_share",
            "old_v_share", "pos_gap")
# the example's constants the configuration states
PUBLISHED = ("r_max", "r_min", "dt", "n_max", "prots_per_cell",
             "protrusion_strength", "r_protrusion",
             "mean_proliferation_rate")
# the engine's settings the configuration states
ENGINE_KEYS = ("grid_size", "capacity", "z_block")


def compare(out, want, tol):
    """The numbers a step is judged by, from the program's state after it
    (``out``) and the reference's (``want``), dicts with ``X``,
    ``old_v``, ``n``, ``a``, ``b``, ``epi_nbs`` and ``mes_nbs``: the
    protrusion rows that differ, the gap in the count of cells, the rows
    whose neighbour counts differ, the share of cells off in a position
    beyond ``tol["pos"]`` or in the polarity vector beyond
    ``tol["polarity"]``, the share off in w or f beyond ``tol["wf"]``
    and the share whose old_v is off beyond ``tol["old_v"]`` (both
    relative to ``1 + |value|``), and the widest gap of a position."""
    n = min(out["n"], want["n"])
    dev = want["X"]["x"].device
    links = (out["a"] != want["a"]) | (out["b"] != want["b"])

    def beyond(a, b, t):
        a, b = a[:n].double(), b[:n].double()
        return ~((a - b).abs() <= t * (1 + b.abs()))
    off = torch.zeros(n, dtype=torch.bool, device=dev)
    gap2 = torch.zeros(n, dtype=torch.float64, device=dev)
    for f in XYZ:
        d = out["X"][f][:n].double() - want["X"][f][:n].double()
        gap2 = gap2 + d * d
        off = off | ~(d.abs() <= tol["pos"])
    p_out = unit(out["X"]["theta"][:n].double(),
                 out["X"]["phi"][:n].double())
    p_ref = unit(want["X"]["theta"][:n].double(),
                 want["X"]["phi"][:n].double())
    for a, b in zip(p_out, p_ref):
        off = off | ~((a - b).abs() <= tol["polarity"])
    wf = beyond(out["X"]["w"], want["X"]["w"], tol["wf"]) | \
        beyond(out["X"]["f"], want["X"]["f"], tol["wf"])
    v_off = torch.zeros(n, dtype=torch.bool, device=dev)
    for a, b in zip(out["old_v"], want["old_v"]):
        v_off = v_off | beyond(a, b, tol["old_v"])
    nbs = (out["epi_nbs"][:n].float() != want["epi_nbs"][:n].float()) | \
        (out["mes_nbs"][:n].float() != want["mes_nbs"][:n].float())
    return {"links_gap": float(links.sum()),
            "n_gap": float(abs(out["n"] - want["n"])),
            "nbs_gap": float(nbs.sum()),
            "off_share": float(off.double().mean()),
            "wf_share": float(wf.double().mean()),
            "old_v_share": float(v_off.double().mean()),
            "pos_gap": float(torch.sqrt(gap2.max()))}


class Spy:
    """Watches one step's calls of ``Links.update``,
    ``Solution.take_step`` and the example's ``proliferate``: keeps what
    the step ``t`` takes and returns, counts the calls, and compares
    every hand-off: each call takes what the calls before it returned,
    the divisions the step's neighbour counts, the step its input state,
    and the step ends in what its divisions made."""

    def __init__(self, loop, t):
        self.loop, self.t = loop, t
        cells, links = loop.cells, loop.state.links
        # what the next call must take: positions, old_v, count, the
        # protrusions' ends
        self.X, self.old_v, self.n = cells.d_X, cells.d_old_v, cells.d_n
        self.a, self.b, self.n_links = links.d_a, links.d_b, links.d_n
        self.aux = None
        self.calls = {"update": 0, "take_step": 0, "proliferate": 0}
        self.seen = {}
        self.gaps = []

    def wrap_update(self, real):
        spy = self

        def update(links, rule, cells, draws=None):
            if draws is None:
                draws = links.draws(rule)
            spy.calls["update"] += 1
            spy.gaps.append(differs((cells.d_X, cells.d_n, links.d_a,
                                     links.d_b),
                                    (spy.X, spy.n, spy.a, spy.b)))
            spy.seen["before"] = {"X": cells.d_X, "n": cells.d_n,
                                  "a": links.d_a, "b": links.d_b,
                                  "links_max": links.n_max, "draws": draws}
            out = real(links, rule, cells, draws=draws)
            spy.a, spy.b, spy.n_links = links.d_a, links.d_b, links.d_n
            spy.seen["links"] = (links.d_a, links.d_b)
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
            spy.seen["old_v"] = cells.d_old_v
            out = real(cells, dt, pw_int, **kw)
            spy.X, spy.old_v = cells.d_X, cells.d_old_v
            spy.aux = (out["epi_nbs"], out["mes_nbs"])
            spy.seen["aux"] = spy.aux
            return out
        return take_step

    def wrap_proliferate(self, real):
        spy = self
        from yalla_tpu_torch.growth import draw

        def proliferate(want_fn, child_fn, X, old_v, n, generator=None,
                        *args, **kwargs):
            if kwargs.get("draws") is None:
                kwargs["draws"] = draw(generator, X.x.shape[0], X.x.device)
            spy.calls["proliferate"] += 1
            spy.gaps.append(differs(
                (X, old_v, n, tuple(kwargs.get("props", ()))),
                (spy.X, spy.old_v, spy.n, spy.aux)))
            spy.seen["draws"] = kwargs["draws"]
            out = real(want_fn, child_fn, X, old_v, n, generator, *args,
                       **kwargs)
            spy.X, spy.old_v, spy.n = out[0], out[1], out[2]
            spy.seen["after"] = out[:3]
            return out
        return proliferate

    def __enter__(self):
        from yalla_tpu_torch.links import Links
        from yalla_tpu_torch.solvers import Solution
        ex = self.loop.ex
        self.patches = [
            mock.patch.object(Links, "update",
                              self.wrap_update(Links.update)),
            mock.patch.object(Solution, "take_step",
                              self.wrap_take_step(Solution.take_step)),
            mock.patch.object(ex, "proliferate",
                              self.wrap_proliferate(ex.proliferate))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()

    def finish(self):
        """The step's end state against what its divisions made, and one
        call of each name."""
        cells, links = self.loop.cells, self.loop.state.links
        self.gaps.append(differs(
            (cells.d_X, cells.d_old_v, cells.d_n, links.d_a, links.d_b),
            (self.X, self.old_v, self.n, self.a, self.b)))
        self.gaps += [abs(c - 1) for c in self.calls.values()]

    def sample(self):
        """(step, the state before it in the reference's form, its draws,
        the program's state after it), or None where the step was cut
        short (:meth:`finish` counts its calls)."""
        seen = self.seen
        if len(seen) < 6:
            return None
        bf = seen["before"]
        draws = seen["draws"]
        before = {"X": {f: getattr(bf["X"], f) for f in FIELDS},
                  "old_v": list(seen["old_v"]), "n": int(bf["n"]),
                  "a": bf["a"], "b": bf["b"], "links_max": bf["links_max"]}
        link_draws = tuple(bf["draws"])
        growth_draws = (draws.rnd, tuple(draws.direction))
        X, old_v, n = seen["after"]
        a, b = seen["links"]
        epi, mes = seen["aux"]
        after = {"X": {f: getattr(X, f) for f in FIELDS},
                 "old_v": list(old_v), "n": int(n), "a": a, "b": b,
                 "epi_nbs": epi, "mes_nbs": mes}
        return self.t, before, (link_draws, growth_draws), after


def read_vtk(path):
    """(points ``[n, 3]``, protrusions ``[m, 2]``, {property or field:
    values ``[n]``}) of a legacy ASCII VTK file of the example's frame;
    raises where a section is missing or malformed."""
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
    data = {}
    for k in [i for i, w in enumerate(words) if w == b"SCALARS"]:
        data[words[k + 1].decode()] = np.array(words[k + 5:k + 5 + n],
                                               dtype=np.float64)
    return pts.reshape(n, 3), lines[:, 1:], data


def sha256_of(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class Loop:
    """One cell's run of the example: set up (the embryo, the writer, a
    warm-up segment) on construction, then :meth:`interval` per step."""

    def __init__(self, cfg, traffic, seed, device):
        from yalla_tpu_torch.solvers import SimulationError
        from yalla_tpu_torch.vtkio import Vtk_output
        self.SimulationError = SimulationError
        self.ex = ex = importlib.import_module(
            "yalla_tpu_torch.examples.intercalation_w_gradient")
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.dev = torch.device(device)
        self.T = int(cfg["time_steps"])
        published = dict({k: getattr(ex, k) for k in PUBLISHED},
                         time_steps=ex.n_time_steps,
                         protrusion_grid=ex.PROTRUSION_GRID)
        stated = {k: cfg["params"][k] for k in published}
        if stated != published:
            raise ValueError(f"the configuration states {stated}, the "
                             f"example runs {published}")
        ic = cfg["ic"]
        if sha256_of(ex.IC_PATH) != ic["sha256"]:
            raise ValueError(f"{ex.IC_PATH}: not the embryo the "
                             f"configuration names (sha256 {ic['sha256']})")
        self.cells = cells = ex.setup(device, ex.IC_PATH)
        engine = {k: getattr(cells.engine, k) for k in ENGINE_KEYS}
        if engine != cfg["engine"] or cells.get_d_n() != ic["n"]:
            raise ValueError(f"the configuration states the engine "
                             f"{cfg['engine']} and {ic['n']} cells, the "
                             f"example runs {engine} and "
                             f"{cells.get_d_n()}")
        self.held = (cells.d_X, cells.d_old_v, cells.get_d_n())
        self.cell_type = ex.cell_types(cells)
        self.F = self.T + 1
        rng = np.random.default_rng([self.seed, 7])
        T, w = self.T, self.T // 50
        self.picks = {0, int(rng.integers(T // 2 - w, T // 2 + w + 1)),
                      int(rng.integers(T - 2 * w, T + 1))}
        self.out_dir = os.path.join(tempfile.gettempdir(), "perfbench_iwg")
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.writer = Vtk_output("iwg", self.out_dir, verbose=False)
        self.trace_states = None
        self.min_intervals = self.F
        # warm-up: one segment and its files
        self.restart()
        for _ in range(self.F):
            self.interval()
        self.restart()

    def restart(self):
        """Back to the window's first step, with nothing recorded."""
        self.count = self.failed = 0
        self.counts = {"segments": 0, "flagged": 0}
        self.samples, self.handoffs = [], []
        self.file_sample = None
        self.delete_files()

    def delete_files(self):
        """Delete the files written so far but the window's first."""
        keep = self.file_sample[0] if self.file_sample else None
        for name in os.listdir(self.out_dir):
            path = os.path.join(self.out_dir, name)
            if path != keep:
                os.remove(path)

    def segment_start(self):
        """The held embryo and a fresh run (``start``: the step index, the
        protrusions, both generators seeded from the seed); the last
        segment's files deleted."""
        cells = self.cells
        cells.d_X, cells.d_old_v, cells.d_n = self.held
        self.state = self.ex.start(cells, self.T, seed=self.seed)
        if self.counts["segments"]:
            self.delete_files()
        self.counts["segments"] += 1

    def interval(self):
        """One step and the frame before it.  Returns (cell-steps, Heun
        steps)."""
        s, t = divmod(self.count, self.F)
        if t == 0:
            self.segment_start()
        cells = self.cells
        n = cells.get_d_n()
        self.write()
        first = (cells.d_X, n)
        try:
            if s == 0 and t in self.picks:
                with Spy(self, t) as spy:
                    self.ex.step(cells, self.state)
                spy.finish()
                self.handoffs += spy.gaps
                sample = spy.sample()
                if sample is not None:
                    self.samples.append(sample)
            else:
                self.ex.step(cells, self.state)
        except self.SimulationError:
            # a flag: the rest of the segment is not run
            self.failed += 1
            self.counts["flagged"] += 1
            self.count = (s + 1) * self.F
            return n, 1
        if self.trace_states is not None:
            self.trace_states.append((first, (cells.d_X, cells.get_d_n())))
        self.count += 1
        return n, 1

    def write(self):
        """Write the step's frame (``write_frame``); the window's first
        file is kept for the check."""
        cells, links = self.cells, self.state.links
        path = f"{self.writer.output_dir}iwg_{self.writer.time_step}.vtk"
        self.ex.write_frame(self.writer, cells, self.state, self.cell_type)
        if self.file_sample is None:
            n, m = cells.get_d_n(), links.get_d_n()
            self.file_sample = (path, cells.d_X, n, links.d_a[:m],
                                links.d_b[:m])

    def close(self):
        """End of the window: nothing is left to write (the writer
        writes in the calling thread)."""

    def trace_begin(self):
        """Bring the window, untraced, to the step from which the traced
        window's ``trace_intervals`` steps end the first segment."""
        start = max(0, self.F - int(self.traffic["trace_intervals"]))
        while self.count < start:
            self.interval()
        self.trace_states = []

    def trace_end(self):
        pass

    def iwg_states(self):
        """The traced window's states, each with the lattice passes it
        stands for: a step's two passes, one on its state before and one
        on its state after (the predictor lies between them); each state
        ``((x, y, z, ctype), n, passes)``."""
        return [((X.x, X.y, X.z, X.ctype), n, 1)
                for a, b in self.trace_states or () for X, n in (a, b)]

    def pass_states(self):
        """:meth:`iwg_states` as ``((x, y, z), n, passes)``."""
        return [(chans[:3], n, k) for chans, n, k in self.iwg_states()]

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
            out.append(r)
        return out

    def readings(self, control=False, refs=None):
        """The compared numbers, each the worst over the sampled steps:
        the program's (or, with ``control``, the reference's in bfloat16
        in its place); None where a pick was not sampled."""
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
        """The widest relative gap between the positions, w and f in the
        window's first file and the state it was written from; infinite
        where the file's point count, protrusions or cell types are not
        the state's.  With ``control``, of the state's values rounded to
        bfloat16 in the file's place."""
        if self.file_sample is None:
            return None
        path, X, n, a, b = self.file_sample
        want = torch.stack([X.x, X.y, X.z, X.w, X.f], 1)[:n]
        if control:
            got = want.bfloat16().double().cpu().numpy()
        else:
            pts, lines, data = read_vtk(path)
            links = torch.stack([a, b], 1).cpu().numpy()
            ctype = X.ctype[:n].cpu().numpy().astype(np.int64)
            types = data.get("cell_type")
            if pts.shape[0] != n or lines.shape != links.shape \
                    or (lines != links).any() or types is None \
                    or (types != ctype).any() or "w" not in data \
                    or "f" not in data:
                return math.inf
            got = np.concatenate([pts, data["w"][:, None],
                                  data["f"][:, None]], 1)
        want = want.double().cpu().numpy()
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), 1e-30)))

    def handoff_gap(self):
        """Hand-offs in the sampled steps whose state differs from what
        the call before made, and calls short of or beyond one."""
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
