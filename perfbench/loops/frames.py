"""The flagship's frame loop (yalla ``examples/branching.cu:256-281``) as a
user runs it: before some frames the frame's file is queued on the
asynchronous VTK writer, then the frame (``substeps`` times division and a
Heun step, ``models.branching.make_frame``) runs and its failure flags are
read back; a flagged frame is redone on an engine sized from the state, as
the example does.

The window replays segments of ``frames_per_segment`` frames from one held
state: the settled 500k-cell tissue of the configuration, turned by a
rotation about the origin and its rows permuted, both drawn from the seed.
Every segment hands the frame the same division draws (``draws=``), made
once from the seed, so every segment does the same work.

The check follows the reference (``perfbench/reference/branching.py``)
through substeps of frames that the window ran, drawn from the seed: the
first substep of a segment, from the held state, and further substeps from
the program's own state before them, which the frame hands to
``proliferate``, ``record_divisions`` and ``heun_step`` (a spy on those
names keeps references to what they take and return).  Whole frames are
not compared: at 500k cells the force's and the friction's jump at the
cutoff makes two f32 trajectories part within a frame wherever a pair
sits on the cutoff within rounding.  What the reference does not follow,
the frame's hand-offs, the spy checks in every sampled frame: that it
makes ``substeps`` calls of each and that every call takes what the calls
before it returned.  The check also reads back one file the writer wrote.
"""
from __future__ import annotations

import hashlib
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench.reference import branching as ref

FIELDS = ref.FIELDS
unit = ref.unit
# the frame's calls that the spy watches, in the order of a substep
NAMES = ("proliferate", "record_divisions", "heun_step")
# the numbers :func:`compare` gives
COMPARED = ("n_gap", "nodes_gap", "clone_gap", "nbs_gap", "off_share",
            "old_v_share", "pos_gap")
# settled rows by (file, sha256, rows): read once in a process
_ROWS = {}


def random_rotation(rng):
    """A rotation matrix drawn uniformly (the QR of a Gaussian matrix,
    signs fixed, determinant +1)."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def unit_directions(generator, n_pad, device):
    """Uniform unit vectors (theta = acos(2u - 1), phi = 2 pi u;
    branching.cu:141-143)."""
    u = torch.rand((2, n_pad), generator=generator, device=device)
    theta = torch.acos(2.0 * u[0] - 1.0)
    phi = u[1] * (2.0 * math.pi)
    return (torch.sin(theta) * torch.cos(phi),
            torch.sin(theta) * torch.sin(phi), torch.cos(theta))


def settled_rows(path, sha256, n):
    """The first ``n`` rows of the settled state's fields and old_v as one
    float32 array ``[11, n]``, after checking the file's hash; read once
    in a process."""
    key = (path, sha256, n)
    if key not in _ROWS:
        data = open(path, "rb").read()
        if hashlib.sha256(data).hexdigest() != sha256:
            raise ValueError(f"{path}: not the settled state the "
                             f"configuration names (sha256 {sha256})")
        with np.load(path) as d:
            _ROWS[key] = np.stack(
                [d["X_" + f][:n] for f in FIELDS]
                + [d["V_" + f][:n] for f in "xyz"]).astype(np.float32)
    return _ROWS[key]


def initial_fields(rows, n_pad, seed, device):
    """The held state's fields (dict), old_v (list) and count from the
    settled rows: turned about the origin by a rotation drawn from the
    seed (positions, old_v and the epithelium's polarity; the mesenchyme
    keeps its null angles), rows permuted by a permutation drawn from the
    seed, padded with zeros to ``n_pad`` rows."""
    n = rows.shape[1]
    R = random_rotation(np.random.default_rng(seed))
    A = torch.as_tensor(rows, device=device)
    Rt = torch.as_tensor(R, dtype=torch.float64, device=device)
    pos = (Rt @ A[0:3].double()).float()
    vel = (Rt @ A[8:11].double()).float()
    theta, phi = A[3], A[4]
    px, py, pz = unit(theta.double(), phi.double())
    q = Rt @ torch.stack([px, py, pz])
    th_new = torch.arccos(torch.clamp(q[2], -1.0, 1.0)).float()
    ph_new = torch.atan2(q[1], q[0]).float()
    epi = A[7] == 1.0
    cols = {"x": pos[0], "y": pos[1], "z": pos[2],
            "theta": torch.where(epi, th_new, theta),
            "phi": torch.where(epi, ph_new, phi),
            "u": A[5], "v": A[6], "ctype": A[7]}
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    perm = torch.randperm(n, generator=g, device=device)

    def pad(a):
        out = torch.zeros(n_pad, dtype=torch.float32, device=device)
        out[:n] = a[perm]
        return out
    return ({f: pad(cols[f]) for f in FIELDS},
            [pad(vel[c]) for c in range(3)], n)


def flags_of(errs):
    """The frame's failure flags in one readback: (any set, by name)."""
    keys = list(errs)
    vals = torch.stack([errs[k].float() for k in keys]).tolist()
    return any(vals), dict(zip(keys, vals))


def clones_after(clone_in, n_in, parents):
    """The clone labels after a division pass: each daughter row takes
    its parent's."""
    out = clone_in.clone()
    out[n_in:n_in + parents.numel()] = clone_in[parents]
    return out


def compare(out, want, tol):
    """The numbers a substep is judged by, from the program's state after
    it (``out``) and the reference's (``want``), both dicts with ``X``,
    ``old_v``, ``n``, ``nodes`` (the lineage nodes the substep added),
    ``clone``, ``epi_nbs`` and ``mes_nbs``: the gap in the count of cells
    and of lineage nodes, the rows whose clone label differs, the rows
    whose neighbour counts differ, the share of rows off in any field
    (positions, the polarity vector, u, v) beyond ``tol``, the share of
    rows whose old_v (the velocity the next step's friction mixes) is off
    beyond ``tol``, and the widest gap of a position."""
    n = min(out["n"], want["n"])
    dev = want["X"]["x"].device
    off = torch.zeros(n, dtype=torch.bool, device=dev)
    gap2 = torch.zeros(n, dtype=torch.float64, device=dev)
    for f in ("x", "y", "z"):
        d = out["X"][f][:n].double() - want["X"][f][:n].double()
        gap2 = gap2 + d * d
        off = off | ~(d.abs() <= tol["pos"])
    p_out = unit(out["X"]["theta"][:n].double(),
                 out["X"]["phi"][:n].double())
    p_ref = unit(want["X"]["theta"][:n].double(),
                 want["X"]["phi"][:n].double())
    for a, b in zip(p_out, p_ref):
        off = off | ~((a - b).abs() <= tol["polarity"])
    for f in ("u", "v"):
        a, b = out["X"][f][:n].double(), want["X"][f][:n].double()
        off = off | ~((a - b).abs() <= tol["uv"] * (1 + b.abs()))
    v_off = torch.zeros(n, dtype=torch.bool, device=dev)
    for a, b in zip(out["old_v"], want["old_v"]):
        a, b = a[:n].double(), b[:n].double()
        v_off = v_off | ~((a - b).abs() <= tol["old_v"] * (1 + b.abs()))
    nbs = (out["epi_nbs"][:n].float() != want["epi_nbs"][:n].float()) | \
        (out["mes_nbs"][:n].float() != want["mes_nbs"][:n].float())
    return {"n_gap": float(abs(out["n"] - want["n"])),
            "nodes_gap": float(abs(out["nodes"] - want["nodes"])),
            "clone_gap": float((out["clone"][:n] != want["clone"][:n]).sum()),
            "nbs_gap": float(nbs.sum()),
            "off_share": float(off.double().mean()),
            "old_v_share": float(v_off.double().mean()),
            "pos_gap": float(torch.sqrt(gap2.max()))}


def differs(a, b):
    """How many leaves of ``a`` and ``b`` differ, as an int or a device
    tensor (no readback): tensors by value (no device work where they are
    one object), tuples leaf by leaf, other values by ``!=``."""
    if a is b:
        return 0
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return 1
        return torch.ne(a, b).any().to(torch.int64)
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        if len(a) != len(b):
            return 1
        return sum((differs(x, y) for x, y in zip(a, b)), 0)
    return int(a != b)


class Spy:
    """Watches one frame's calls of ``proliferate``, ``record_divisions``
    and ``heun_step``: keeps references to what the substeps ``ks`` take
    and return (no device work), counts the calls, and compares every
    hand-off of the frame's state: each call takes what the calls before
    it returned, the first substep the frame's input ``state``, and the
    frame returns what its last substep made."""

    def __init__(self, B, ks, state):
        self.B, self.ks, self.state = B, ks, state
        self.calls = dict.fromkeys(NAMES, 0)
        self.last = {}
        self.seen = {k: {} for k in ks}
        self.gaps = []

    def handoff(self, name, args, kwargs):
        """What the call ``name`` takes against what the calls before it
        returned."""
        last, st = self.last, self.state
        p = last.get("proliferate")
        if name == "proliferate":
            got = (args[2], args[3], args[4], tuple(kwargs["props"]))
            if "heun_step" in last:
                X, old_v, aux = last["heun_step"]
                want = (X, old_v, p[2], (aux["epi_nbs"], aux["mes_nbs"]))
            else:
                want = (st.X, st.old_v, st.n, (st.epi_nbs, st.mes_nbs))
        elif p is None:
            self.gaps.append(1)
            return
        elif name == "record_divisions":
            got = args[:3]
            want = (last.get("record_divisions", st.lineage), p[4], p[0])
        else:
            got, want = args[4:7], p[:3]
        self.gaps.append(differs(got, want))

    def wrap(self, name):
        real = getattr(self.B, name)

        def spy(*args, **kwargs):
            self.handoff(name, args, kwargs)
            out = real(*args, **kwargs)
            k = self.calls[name]
            self.calls[name] += 1
            self.last[name] = out
            if k in self.seen:
                self.seen[k][name] = (args, kwargs, out)
            return out
        return spy

    def __enter__(self):
        from unittest import mock
        self.patches = [mock.patch.object(self.B, name, self.wrap(name))
                        for name in NAMES]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()

    def finish(self, out, substeps):
        """The frame's result against what its last substep made, and its
        calls of each name against ``substeps``."""
        if all(name in self.last for name in NAMES):
            p, lin, (X, old_v, aux) = (self.last[k] for k in NAMES)
            self.gaps.append(differs(
                (out.X, out.old_v, out.n, out.lineage, out.epi_nbs,
                 out.mes_nbs),
                (X, old_v, p[2], lin, aux["epi_nbs"], aux["mes_nbs"])))
        else:
            self.gaps.append(1)
        self.gaps += [abs(c - substeps) for c in self.calls.values()]

    def samples(self, f):
        """One sample per recorded substep: the state before it (as the
        reference's state dict, with the lineage's clone labels), and the
        program's state after it."""
        out = []
        for k, seen in self.seen.items():
            if len(seen) < len(NAMES):
                continue        # a frame short of calls: finish() counts it
            p_args, p_kw, p_out = seen["proliferate"]
            r_args, _, r_out = seen["record_divisions"]
            _, _, h_out = seen["heun_step"]
            epi, mes = p_kw["props"]
            before = {"X": {f_: getattr(p_args[2], f_) for f_ in FIELDS},
                      "old_v": list(p_args[3]), "n": int(p_args[4]),
                      "epi_nbs": epi, "mes_nbs": mes,
                      "clone": r_args[0].cell_clone,
                      "nodes": r_args[0].n_nodes}
            X_new, old_v_new, aux = h_out
            after = {"X": {f_: getattr(X_new, f_) for f_ in FIELDS},
                     "old_v": list(old_v_new), "n": int(p_out[2]),
                     "nodes": r_out.n_nodes - r_args[0].n_nodes,
                     "clone": r_out.cell_clone,
                     "epi_nbs": aux["epi_nbs"], "mes_nbs": aux["mes_nbs"]}
            out.append((f, k, before, after))
        return out


def read_points(path):
    """The POINTS section of a legacy ASCII VTK file, ``[n, 3]``."""
    with open(path, "rb") as f:
        data = f.read()
    head = data.index(b"POINTS ")
    line_end = data.index(b"\n", head)
    n = int(data[head:line_end].split()[1])
    end = data.index(b"VERTICES", line_end)
    vals = np.array(data[line_end:end].split(), dtype=np.float64)
    return vals.reshape(n, 3)


class Loop:
    """One cell's frame loop: set up (inputs, engine, writer, warm-up) on
    construction, then :meth:`interval` per frame."""

    def __init__(self, cfg, traffic, seed, device):
        from yalla_tpu_torch.dtypes import Float3
        from yalla_tpu_torch.growth import Draws, lineage_init
        from yalla_tpu_torch.models import branching as B
        from yalla_tpu_torch.solvers import LatticeEngine, Solution
        from yalla_tpu_torch.vtkio import Vtk_output
        self.B = B
        self.cfg, self.traffic = cfg, traffic
        self.dev = torch.device(device)
        self.p = B.Params()
        self.substeps = int(cfg["substeps"])
        self.F = int(traffic["frames_per_segment"])
        self.n_max = int(cfg["n_max"])
        engine = LatticeEngine(**cfg["engine"])
        self.cells = Solution(B.Cell, self.n_max, engine=engine,
                              cube_size=self.p.r_max, device=self.dev)
        n_pad = self.cells.n_pad
        st = cfg["state"]
        rows = settled_rows(os.path.join(cfg["root"], st["file"]),
                            st["sha256"], int(st["n"]))
        X, old_v, n = initial_fields(rows, n_pad, seed, self.dev)
        key = torch.Generator(device=self.dev)
        key.manual_seed(seed)
        self.held = B.State(
            X=B.Cell(*(X[f] for f in FIELDS)), old_v=Float3(*old_v), n=n,
            lineage=lineage_init(2 * n_pad, n_pad, n, device=self.dev),
            epi_nbs=torch.zeros(n_pad, device=self.dev),
            mes_nbs=torch.zeros(n_pad, device=self.dev), key=key)
        g = torch.Generator(device=self.dev)
        g.manual_seed(seed + 1)
        self.ref_draws = [[(torch.rand(n_pad, generator=g, device=self.dev),
                            unit_directions(g, n_pad, self.dev))
                           for _ in range(self.substeps)]
                          for _ in range(self.F)]
        self.draws = [[Draws(rnd, Float3(*d)) for rnd, d in fd]
                      for fd in self.ref_draws]
        self.engine = engine
        self.frame = B.make_frame(self.p, engine, substeps=self.substeps)
        # which substeps the check takes, from the seed:
        # the first substep of a segment (from the held state), and
        # further substeps anywhere in the first segments
        rng = np.random.default_rng([seed, 7])
        S = int(traffic["sample_segments"])
        self.picks = {}
        picks = [(int(rng.integers(S)), 0, 0)] + [
            (int(rng.integers(S)), int(rng.integers(self.F)),
             int(rng.integers(self.substeps)))
            for _ in range(int(traffic["sample_substeps"]) - 1)]
        for s_, f_, k_ in picks:
            self.picks.setdefault((s_, f_), set()).add(k_)
        self.out_dir = os.path.join(tempfile.gettempdir(),
                                    "perfbench_frames")
        shutil.rmtree(self.out_dir, ignore_errors=True)
        self.writer = Vtk_output("frame", self.out_dir, verbose=False,
                                 async_write=True)
        self.trace_states = None
        self.min_intervals = S * self.F
        # warm-up: one segment and one file, at the cell's own shapes
        self.restart()
        for _ in range(self.F):
            self.interval(write=(self.count == 0))
        self.writer.drain()
        for name in os.listdir(self.out_dir):
            os.remove(os.path.join(self.out_dir, name))
        self.restart()

    def restart(self):
        """Back to the window's first frame, with nothing recorded."""
        self.count = self.failed = 0
        self.counts = {"frames_redone": 0}
        self.samples, self.file_sample, self.handoffs = [], None, []
        self.spans = {"write_frame": [], "drain": []}

    def write(self, state):
        """Queue the state's file on the writer (ref branching.cu:273-281);
        returns its path (the check reads the window's first file)."""
        c = self.cells
        c.d_X, c.d_old_v, c.d_n = state.X, state.old_v, state.n
        path = f"{self.out_dir}/frame_{self.writer.time_step}.vtk"
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.write_frame"):
            self.writer.write_frame(
                c, polarity=True, fields=("u", "v"),
                properties=(("type", state.X.ctype, np.int32),
                            ("cell_clone", state.lineage.cell_clone,
                             np.int32)))
        self.spans["write_frame"].append(time.perf_counter() - t0)
        return path

    def interval(self, write=None):
        """One frame: its file queued where the traffic says, the frame,
        its flags read back.  Returns (cell-steps, Heun steps)."""
        s, f = divmod(self.count, self.F)
        if f == 0:
            self.state = self.held
        state = self.state
        t = self.traffic
        if write is None:
            write = t["file_every"] and \
                self.count % t["file_every"] == t["file_offset"]
        if write and self.file_sample is None:
            self.file_sample = (self.write(state), state)
        elif write:
            self.write(state)
        out, bad = self.run_frame(state, s, f)
        runs = 1
        if bad:
            # the tissue outran the engine: resize from the live state and
            # redo the frame (ref examples/branching.py)
            engine = self.B.engine_for_state(state, self.n_max, self.p)
            self.frame = self.B.make_frame(self.p, engine,
                                           substeps=self.substeps)
            out, bad = self.run_frame(state, s, f)
            self.counts["frames_redone"] += 1
            runs = 2
            self.failed += bool(bad)
        if self.trace_states is not None:
            self.trace_states.append((state, out, runs))
        self.state = out
        self.count += 1
        return self.substeps * state.n, self.substeps

    def run_frame(self, state, s, f):
        """The frame, under a :class:`Spy` where the check samples it, and
        its flags read back: (state after it, any flag set)."""
        ks = self.picks.get((s, f))
        with torch.profiler.record_function("perfbench.frame"):
            if ks is None:
                out, errs = self.frame(state, f / self.F, draws=self.draws[f])
            else:
                with Spy(self.B, ks, state) as spy:
                    out, errs = self.frame(state, f / self.F,
                                           draws=self.draws[f])
                spy.finish(out, self.substeps)
                self.samples += spy.samples(f)
                self.handoffs += spy.gaps
        with torch.profiler.record_function("perfbench.flags"):
            bad, _ = flags_of(errs)
        return out, bad

    def close(self):
        """End of the window: the queued files written."""
        t0 = time.perf_counter()
        self.writer.drain()
        self.spans["drain"].append(time.perf_counter() - t0)

    def trace_begin(self):
        self.trace_states = []

    def trace_end(self):
        """After the traced window: the readbacks of one frame and its
        flags, as ``set_sync_debug_mode`` reports them."""
        import warnings
        state = self.held
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                flags_of(self.frame(state, 0.0, draws=self.draws[0])[1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.counts["readbacks_per_frame"] = sum(
            "called a synchronizing" in str(w.message) for w in caught)

    def pass_states(self):
        """The traced window's states, each with the passes it stands for:
        a frame's passes split between its first and its last state."""
        out = []
        for a, b, runs in self.trace_states or ():
            for st in (a, b):
                out.append(((st.X.x, st.X.y, st.X.z), int(st.n),
                            self.substeps * runs))
        return out

    def release(self):
        """Free what the check and the readers do not read: the writer
        (its files written), the frame, the draws in the program's type;
        the samples and the traced window's states stay."""
        self.writer.close()
        self.frame = self.state = None
        self.draws = None
        torch.cuda.empty_cache() if self.dev.type == "cuda" else None

    def reference_outputs(self, dtype=torch.float32):
        """The reference's state after each sampled substep, from the same
        state before it and the same draws, with its clone labels and the
        lineage nodes it adds."""
        out = []
        for f, k, before, _ in self.samples:
            rnd, direction = self.ref_draws[f][k]
            r = ref.substep(before, rnd, direction, dtype)
            r["X"] = {name: v.float() for name, v in r["X"].items()}
            r["old_v"] = [v.float() for v in r["old_v"]]
            r["clone"] = clones_after(before["clone"], before["n"],
                                      r["parents"])
            r["nodes"] = r["parents"].numel()
            out.append(r)
        return out

    def readings(self, plant=None, control=False, refs=None):
        """The compared numbers, each the worst over the sampled
        substeps: the program's (or, with ``control``, the reference's in
        bfloat16 in its place), with ``plant(state_before, out)`` applied
        to the output where given; None where nothing was sampled."""
        tol = self.cfg["tolerance"]
        refs = refs if refs is not None else self.reference_outputs()
        controls = self.reference_outputs(torch.bfloat16) if control \
            else None
        worst = dict.fromkeys(COMPARED)
        for m, ((f, k, before, after), want) in enumerate(
                zip(self.samples, refs)):
            out = controls[m] if control else after
            if plant is not None:
                out = plant(before, out)
            for key, v in compare(out, want, tol).items():
                worst[key] = v if worst[key] is None else max(worst[key], v)
        return worst

    def file_gap(self, control=False):
        """The widest relative gap between the positions in the sampled
        file and the state it was queued with (its point count must be
        the state's); with ``control``, of the state's positions rounded
        to bfloat16 in the file's place."""
        if self.file_sample is None:
            return None
        path, st = self.file_sample
        want = torch.stack([st.X.x, st.X.y, st.X.z], 1)[:st.n]
        pts = want.bfloat16().double().cpu().numpy() if control \
            else read_points(path)
        if pts.shape[0] != st.n:
            return math.inf
        want = want.double().cpu().numpy()
        return float(np.max(np.abs(pts - want)
                            / np.maximum(np.abs(want), 1e-30)))

    def checks(self):
        """{name: value}: the numbers that decide ``correct``."""
        out = self.readings()
        out["handoff_gap"] = self.handoff_gap()
        if self.traffic["file_every"]:
            out["file_gap"] = self.file_gap()
        out["failed"] = float(self.failed)
        return out

    def handoff_gap(self):
        """Hand-offs in the sampled frames whose state differs from what
        the call before made, and calls short of or beyond ``substeps``."""
        return float(sum(int(g) for g in self.handoffs))

    def cleanup(self):
        shutil.rmtree(self.out_dir, ignore_errors=True)
