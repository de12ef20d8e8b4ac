"""yalla's tutorial model (``examples/model_features_sequential_addition.cu``)
as a user runs it, through the port's example module
(``yalla_tpu_torch/examples/model_features_sequential_addition.py``): a
ball of ``n_0`` mesenchymal cells drawn from the run's seed (``setup``,
on the grid engine), then the published run's five parts of ``part_steps
+ 1`` steps, every step its frame (``write_frame``: the positions, the
protrusions in part 5, the polarity, the cell types and w) written by a
VTK writer as the example's ``run`` writes it, in the calling thread,
then ``step`` (a Heun step of the part, and the part's divisions or
rewiring; after the first and the second part the change that opens the
next).  The example's ``take_step`` reads the flags back every step and
raises on one.

The loop extends the iwg loop's (``perfbench/loops/
intercalation_w_gradient.py``) and keeps its segments: each the published
run from the held ball, ``5 (part_steps + 1)`` steps, the divisions' and
the protrusions' generators seeded from the run's seed by ``start``, so
every segment makes the same draws; one interval a step and the frame
written before it; a segment's files deleted when the next starts (the
window's first file, which the check reads, kept).  The window ends with
a segment (:attr:`Loop.min_intervals` reaches the end of the segment
under way): a segment's count runs from 200 cells for three parts to
4,096 in the fifth, so a window cut inside one would weigh its parts by
where the cut fell.  A segment that a flag cuts short ends there, and
the window may end with it.

The check follows the reference (``perfbench/reference/model_features.py``)
through five steps of the first segment, one in each part, drawn from the
seed, each from the program's own state before it, and through the two
transitions that change the cells (``make_epithelium`` after the first
part, ``add_source`` after the second).  A spy on ``Solution.take_step``,
``Links.update`` and the example's ``proliferate``, ``make_epithelium``
and ``add_source`` keeps what those steps take and return (references
only; it fills in the draws a call would make where the call is given
none, from the same generator, so the stream is the program's) and checks
each hand-off: every call takes what the calls before it returned, and
each is made as often as the part makes it.  Whole segments are not
compared: the forces' jump at the cutoff parts two f32 trajectories
within a few steps.  The check reads back the window's first file.
"""
from __future__ import annotations

import importlib
import math
import os
import shutil
import tempfile
from unittest import mock

import numpy as np
import torch

from perfbench.loops import intercalation_w_gradient as iwg
from perfbench.loops.frames import differs, unit
from perfbench.loops.growth_w_wall import link_args
from perfbench.reference import model_features as ref

FIELDS = ref.FIELDS
XYZ = ref.XYZ
# the numbers :func:`compare` gives, then the transitions'
COMPARED = ("links_gap", "n_gap", "type_gap", "nbs_gap", "off_share",
            "w_share", "old_v_share", "pos_gap", "transition_gap")
# the example's constants the configuration states
PUBLISHED = ("r_max", "r_min", "dt", "n_0", "n_max", "prots_per_cell",
             "protrusion_strength", "r_protrusion", "proliferation_rate",
             "part_steps")
# the engine's settings the configuration states
ENGINE_KEYS = ("grid_size", "row_cap")
CALLS = ("update", "take_step", "proliferate", "make_epithelium",
         "add_source")


def compare(out, want, tol):
    """The numbers a step is judged by, from the program's state after it
    (``out``) and the reference's (``want``), dicts with ``X``,
    ``old_v``, ``n``, ``epi_nbs``, ``mes_nbs`` and, in the fifth part,
    ``a`` and ``b``: the protrusion rows that differ, the gap in the count
    of cells, the rows whose cell type or neighbour counts differ, the
    share of cells off in a position beyond ``tol["pos"]`` or in the
    polarity vector beyond ``tol["polarity"]``, the share off in w beyond
    ``tol["w"]`` and the share whose old_v is off beyond ``tol["old_v"]``
    (both relative to ``1 + |value|``), and the widest gap of a
    position."""
    n = min(out["n"], want["n"])
    dev = want["X"]["x"].device
    links = 0.0
    if "a" in want:
        links = float(((out["a"] != want["a"])
                       | (out["b"] != want["b"])).sum())

    def beyond(a, b, t):
        a, b = a[:n].double(), b[:n].double()
        return ~((a - b).abs() <= t * (1 + b.abs()))
    off = torch.zeros(n, dtype=torch.bool, device=dev)
    gap2 = torch.zeros(n, dtype=torch.float64, device=dev)
    for f in XYZ:
        d = out["X"][f][:n].double() - want["X"][f][:n].double()
        gap2 = gap2 + d * d
        off = off | ~(d.abs() <= tol["pos"])
    off = off | polarity_off(out["X"], want["X"], n, tol["polarity"])
    v_off = torch.zeros(n, dtype=torch.bool, device=dev)
    for a, b in zip(out["old_v"], want["old_v"]):
        v_off = v_off | beyond(a, b, tol["old_v"])
    types = out["X"]["ctype"][:n].float() != want["X"]["ctype"][:n].float()
    nbs = (out["epi_nbs"][:n].float() != want["epi_nbs"][:n].float()) | \
        (out["mes_nbs"][:n].float() != want["mes_nbs"][:n].float())
    return {"links_gap": links,
            "n_gap": float(abs(out["n"] - want["n"])),
            "type_gap": float(types.sum()),
            "nbs_gap": float(nbs.sum()),
            "off_share": float(off.double().mean()),
            "w_share": float(beyond(out["X"]["w"], want["X"]["w"],
                                    tol["w"]).double().mean()),
            "old_v_share": float(v_off.double().mean()),
            "pos_gap": float(torch.sqrt(gap2.max()))}


def polarity_off(a, b, n, tol):
    """Which of the first ``n`` cells' polarity vectors differ beyond
    ``tol`` in a component."""
    p_a = unit(a["theta"][:n].double(), a["phi"][:n].double())
    p_b = unit(b["theta"][:n].double(), b["phi"][:n].double())
    off = torch.zeros(n, dtype=torch.bool, device=a["x"].device)
    for u, v in zip(p_a, p_b):
        off = off | ~((u - v).abs() <= tol)
    return off


def transition_gap(out, want, n_pad, tol):
    """The rows that a transition left otherwise than the reference: a
    position, a type or w that differs at all, or a polarity vector off
    beyond ``tol`` in a component (the example takes the angles from
    numpy's float32 ``arccos`` and ``arctan2``, which round otherwise
    than torch's by up to a few units in the last place)."""
    diff = torch.zeros(n_pad, dtype=torch.bool, device=want["x"].device)
    for f in XYZ + ("w", "ctype"):
        diff = diff | (out[f] != want[f])
    return float((diff | polarity_off(out, want, n_pad, tol)).sum())


class Spy(iwg.Spy):
    """The iwg loop's spy (``Links.update``, ``Solution.take_step`` and the
    example's ``proliferate``, each hand-off compared) with the step's
    part: the protrusions handed to the Heun step in the fifth part only,
    the step's state before its first call kept, the example's
    ``make_epithelium`` and ``add_source`` watched too, and each call
    made as often as the part makes it."""

    def __init__(self, loop, t, part):
        super().__init__(loop, t)
        self.part = part
        cells, links = loop.cells, loop.state.links
        self.start = {"X": cells.d_X, "old_v": cells.d_old_v,
                      "n": cells.d_n, "a": links.d_a, "b": links.d_b,
                      "links_max": links.n_max}
        self.calls = dict.fromkeys(CALLS, 0)

    def expected(self):
        """How often the step makes each call."""
        T = self.loop.T
        last = (self.t + 1) % (T + 1) == 0
        return {"update": int(self.part == ref.PROTRUSIONS),
                "take_step": 1,
                "proliferate": int(self.part == ref.GROWTH),
                "make_epithelium": int(last and self.part == ref.RELAX),
                "add_source": int(last
                                  and self.part == ref.EPITHELIUM_PART)}

    def wrap_take_step(self, real):
        spy = self

        def take_step(cells, dt, pw_int, **kw):
            spy.calls["take_step"] += 1
            links = (spy.a, spy.b, spy.n_links) \
                if spy.part == ref.PROTRUSIONS else None
            spy.gaps.append(differs(
                (cells.d_X, cells.d_old_v, cells.d_n,
                 link_args(kw.get("gen_forces"))),
                (spy.X, spy.old_v, spy.n, links)))
            out = real(cells, dt, pw_int, **kw)
            spy.X, spy.old_v = cells.d_X, cells.d_old_v
            spy.aux = (out["epi_nbs"], out["mes_nbs"])
            spy.seen["aux"] = spy.aux
            spy.seen["after"] = (cells.d_X, cells.d_old_v, cells.d_n)
            return out
        return take_step

    def wrap_transition(self, name, real):
        """``make_epithelium(cells, mes_nbs)`` or ``add_source(cells)``:
        it takes the step's state (and its mesenchymal neighbour
        counts)."""
        spy = self

        def transition(cells, *args):
            spy.calls[name] += 1
            took = (cells.d_X, cells.d_old_v, cells.d_n) + args
            want = (spy.X, spy.old_v, spy.n) + (
                (spy.aux[1],) if args else ())
            spy.gaps.append(differs(took, want))
            before = cells.d_X
            out = real(cells, *args)
            spy.seen[name] = (before, cells.get_d_n(), args, cells.d_X)
            spy.X, spy.old_v, spy.n = cells.d_X, cells.d_old_v, cells.d_n
            return out
        return transition

    def __enter__(self):
        super().__enter__()
        ex = self.loop.ex
        more = [mock.patch.object(
            ex, name, self.wrap_transition(name, getattr(ex, name)))
            for name in ("make_epithelium", "add_source")]
        for p in more:
            p.start()
        self.patches += more
        return self

    def finish(self):
        """The step's end state against what its last call made, and each
        call made as often as the part makes it."""
        cells, links = self.loop.cells, self.loop.state.links
        self.gaps.append(differs(
            (cells.d_X, cells.d_old_v, cells.d_n, links.d_a, links.d_b),
            (self.X, self.old_v, self.n, self.a, self.b)))
        want = self.expected()
        self.gaps += [abs(self.calls[k] - want[k]) for k in CALLS]

    def step_sample(self):
        """(step, part, the state before it in the reference's form, its
        draws, the program's state after it), or None where the step was
        cut short."""
        seen = self.seen
        if "after" not in seen or "aux" not in seen:
            return None
        s = self.start
        before = {"X": fields(s["X"]), "old_v": list(s["old_v"]),
                  "n": int(s["n"]), "a": s["a"], "b": s["b"],
                  "links_max": s["links_max"]}
        link_draws = growth_draws = None
        if self.part == ref.PROTRUSIONS:
            if "links" not in seen:
                return None
            link_draws = tuple(seen["before"]["draws"])
        if self.part == ref.GROWTH:
            d = seen["draws"]
            growth_draws = (d.rnd, tuple(d.direction))
        X, old_v, n = seen["after"]
        epi, mes = seen["aux"]
        after = {"X": fields(X), "old_v": list(old_v), "n": int(n),
                 "epi_nbs": epi, "mes_nbs": mes}
        if self.part == ref.PROTRUSIONS:
            after["a"], after["b"] = seen["links"]
        return (self.t, self.part, before, (link_draws, growth_draws),
                after)

    def transition_samples(self):
        """(name, the cells before it, its count, its arguments, the
        cells after it) of each transition the step made."""
        out = []
        for name in ("make_epithelium", "add_source"):
            if name in self.seen:
                before, n, args, after = self.seen[name]
                out.append((name, fields(before), n, args, fields(after)))
        return out


def fields(X):
    return {f: getattr(X, f) for f in FIELDS}


def read_vtk(path):
    """(points ``[n, 3]``, protrusions ``[m, 2]`` or None, the polarity
    normals ``[n, 3]`` or None, {property or field: values ``[n]``}) of a
    legacy ASCII VTK file of the example's frame."""
    with open(path, "rb") as f:
        words = f.read().split()
    k = words.index(b"POINTS")
    n = int(words[k + 1])
    pts = np.array(words[k + 3:k + 3 + 3 * n], dtype=np.float64)
    lines = normals = None
    if b"LINES" in words:
        k = words.index(b"LINES")
        m = int(words[k + 1])
        lines = np.array(words[k + 3:k + 3 + 3 * m],
                         dtype=np.int64).reshape(m, 3)
        if m and not (lines[:, 0] == 2).all():
            raise ValueError(f"{path}: a LINES entry is not a pair")
        lines = lines[:, 1:]
    if b"NORMALS" in words:
        k = words.index(b"NORMALS")
        normals = np.array(words[k + 3:k + 3 + 3 * n],
                           dtype=np.float64).reshape(n, 3)
    data = {}
    for k in [i for i, w in enumerate(words) if w == b"SCALARS"]:
        data[words[k + 1].decode()] = np.array(words[k + 5:k + 5 + n],
                                               dtype=np.float64)
    return pts.reshape(n, 3), lines, normals, data


def params_of(cfg):
    """The reference's constants, those the configuration states taken
    from it."""
    p = ref.Params()
    for key, value in cfg["params"].items():
        if hasattr(p, key):
            setattr(p, key, value)
    return p


class Loop(iwg.Loop):
    """One cell's run of the example: set up (the ball, the writer, a
    warm-up segment) on construction, then :meth:`interval` per step.
    The segments' start, the files' deletion, the trace's bounds, the
    release and the checks are the iwg loop's."""

    def __init__(self, cfg, traffic, seed, device):
        from yalla_tpu_torch.solvers import SimulationError
        from yalla_tpu_torch.vtkio import Vtk_output
        self.SimulationError = SimulationError
        self.ex = ex = importlib.import_module(
            "yalla_tpu_torch.examples.model_features_sequential_addition")
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.dev = torch.device(device)
        self.p = params_of(cfg)
        published = dict({k: getattr(ex, k) for k in PUBLISHED},
                         protrusion_grid=ex.PROTRUSION_GRID)
        stated = {k: cfg["params"][k] for k in published}
        if stated != published:
            raise ValueError(f"the configuration states {stated}, the "
                             f"example runs {published}")
        # the steps of a part less one, ``start``'s n_steps
        self.T = T = int(ex.part_steps)
        self.cells = cells = ex.setup(device, self.seed)
        engine = {k: getattr(cells.engine, k) for k in ENGINE_KEYS}
        if engine != cfg["engine"] or cells.n_pad != cfg["n_pad"] \
                or cells.get_d_n() != ex.n_0:
            raise ValueError(f"the configuration states the engine "
                             f"{cfg['engine']}, {cfg['n_pad']} rows and "
                             f"{ex.n_0} cells, the example runs {engine}, "
                             f"{cells.n_pad} and {cells.get_d_n()}")
        self.held = (cells.d_X, cells.d_old_v, cells.get_d_n())
        self.cell_type = ex.cell_types(cells)
        self.F = 5 * (T + 1)
        rng = np.random.default_rng([self.seed, 7])
        self.picks = {int(rng.integers(k * (T + 1), (k + 1) * (T + 1)))
                      for k in range(5)}
        # the last steps of the first two parts: each ends in a transition
        self.ends = {T, 2 * T + 1}
        self.out_dir = os.path.join(tempfile.gettempdir(), "perfbench_mfsa")
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.writer = Vtk_output("mfsa", self.out_dir, verbose=False)
        self.trace_states = None
        # the least count of the window's intervals: the end of the
        # segment under way (:meth:`interval`)
        self.min_intervals = self.F
        # warm-up: one segment and its files
        self.restart()
        for _ in range(self.F):
            self.interval()
        self.restart()

    def restart(self):
        super().restart()
        self.intervals = 0
        self.transitions = []

    def interval(self):
        """One step and the frame before it.  Returns (cell-steps, Heun
        steps)."""
        s, t = divmod(self.count, self.F)
        if t == 0:
            self.segment_start()
            self.min_intervals = self.intervals + self.F
        self.intervals += 1
        cells = self.cells
        n = cells.get_d_n()
        self.write()
        first = (cells.d_X, n)
        try:
            if s == 0 and (t in self.picks or t in self.ends):
                part = self.ex.part_of(self.state)
                with Spy(self, t, part) as spy:
                    self.ex.step(cells, self.state)
                spy.finish()
                self.handoffs += spy.gaps
                sample = spy.step_sample()
                if t in self.picks and sample is not None:
                    self.samples.append(sample)
                self.transitions += spy.transition_samples()
            else:
                self.ex.step(cells, self.state)
        except self.SimulationError:
            # a flag: the rest of the segment is not run
            self.failed += 1
            self.counts["flagged"] += 1
            self.count = (s + 1) * self.F
            self.min_intervals = self.intervals
            return n, 1
        if self.trace_states is not None:
            self.trace_states.append((first, (cells.d_X, cells.get_d_n())))
        self.count += 1
        return n, 1

    def write(self):
        """Write the step's frame (``write_frame``); the window's first
        file is kept for the check."""
        cells = self.cells
        path = f"{self.writer.output_dir}mfsa_{self.writer.time_step}.vtk"
        self.ex.write_frame(self.writer, cells, self.state, self.cell_type)
        if self.file_sample is None:
            links = self.state.links
            m = links.get_d_n()
            ends = (links.d_a[:m], links.d_b[:m]) \
                if self.ex.part_of(self.state) == ref.PROTRUSIONS else None
            self.file_sample = (path, cells.d_X, cells.get_d_n(), ends)

    def mfsa_states(self):
        """The traced window's states, each with the grid pair passes it
        stands for: a step's two passes, one on its state before and one
        on its state after (the predictor lies between them); each state
        ``((x, y, z, w, ctype), n, passes)``."""
        return [((X.x, X.y, X.z, X.w, X.ctype), n, 1)
                for a, b in self.trace_states or () for X, n in (a, b)]

    def reference_outputs(self, dtype=torch.float32):
        """The reference's state after each sampled step, from the same
        state before it and the same draws, and after each transition
        from the same cells."""
        steps = []
        for _, part, before, (link_draws, growth_draws), _ in self.samples:
            r = ref.step(before, part, link_draws, growth_draws, dtype,
                         self.p)
            r["X"] = {f: v.float() for f, v in r["X"].items()}
            r["old_v"] = [v.float() for v in r["old_v"]]
            steps.append(r)
        transitions = []
        for name, before, n, args, _ in self.transitions:
            X = {f: v.to(dtype) for f, v in before.items()}
            if name == "make_epithelium":
                r = ref.make_epithelium(X, args[0].to(dtype), self.p)
            else:
                r = ref.add_source(X, n, self.p)
            transitions.append({f: v.float() for f, v in r.items()})
        return steps, transitions

    def readings(self, control=False, refs=None):
        """The compared numbers, each the worst over the sampled steps
        (``transition_gap`` summed over the transitions): the program's
        (or, with ``control``, the reference's in bfloat16 in its place);
        None where a pick or a transition was not sampled."""
        tol = self.cfg["tolerance"]
        steps, transitions = refs if refs is not None \
            else self.reference_outputs()
        if control:
            outs, t_outs = self.reference_outputs(torch.bfloat16)
        else:
            outs = [after for *_, after in self.samples]
            t_outs = [after for *_, after in self.transitions]
        worst = dict.fromkeys(COMPARED)
        for out, want in zip(outs, steps):
            for key, v in compare(out, want, tol).items():
                worst[key] = v if worst[key] is None else max(worst[key], v)
        worst["transition_gap"] = float(sum(
            transition_gap(out, want, want["x"].shape[0], tol["angle"])
            for out, want in zip(t_outs, transitions)))
        if len(steps) < len(self.picks) \
                or len(transitions) < len(self.ends):
            worst = dict.fromkeys(COMPARED)
        return worst

    def file_gap(self, control=False):
        """The widest gap between the window's first file and the state it
        was written from: relative in the positions and w, absolute in
        the polarity's components; infinite where the file's point count,
        protrusions or cell types are not the state's.  With ``control``,
        of the state's values rounded to bfloat16 in the file's place."""
        if self.file_sample is None:
            return None
        path, X, n, ends = self.file_sample
        want = torch.stack([X.x, X.y, X.z, X.w], 1)[:n].double()
        th, ph = X.theta[:n].double(), X.phi[:n].double()
        normals = torch.stack([torch.sin(th) * torch.cos(ph),
                               torch.sin(th) * torch.sin(ph),
                               torch.where((th == 0) & (ph == 0), 0.0,
                                           torch.cos(th))], 1)
        if control:
            got = want.bfloat16().double().cpu().numpy()
            got_normals = normals.bfloat16().double().cpu().numpy()
        else:
            pts, lines, got_normals, data = read_vtk(path)
            types = data.get("cell_type")
            ctype = X.ctype[:n].cpu().numpy().astype(np.int64)
            links = None if ends is None else \
                torch.stack(ends, 1).cpu().numpy()
            if pts.shape[0] != n or types is None or "w" not in data \
                    or got_normals is None or (types != ctype).any() \
                    or (lines is None) != (links is None) \
                    or (links is not None and (
                        lines.shape != links.shape or (lines != links).any())):
                return math.inf
            got = np.concatenate([pts, data["w"][:, None]], 1)
        want = want.cpu().numpy()
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        gap = np.abs(got_normals - normals.cpu().numpy())
        return float(max(rel.max(initial=0.0), gap.max(initial=0.0)))
