"""The flagship's tissue on the slot-order lattice integrator: the settled
branching tissue (the configuration's state, turned by a rotation and its
rows permuted, both drawn from the seed, as ``frames.py`` holds it) run by
``Solution.take_steps`` on a ``LatticeEngine`` the traffic states, which
runs ``ops.lattice_xla.lattice_heun_steps``: a fresh binning before every
pair pass (``rebuild_every`` 1), the force of ``Params()``
(``models.branching.make_force``), ``friction_w_neighbour`` and
``polarity_precompute3``.  No division, no lineage, no file: the
integrator and its kernels alone.

The window replays segments of ``intervals_per_segment`` intervals from
the held state; one interval is one ``take_steps(steps_per_interval)``
call, whose flags it reads back (and raises on).

The check follows the reference (``perfbench/reference/branching.py``'s
``heun_step``) through steps of intervals of the first segment, drawn
from the seed (the first interval among them, from the held state): the
first step of each, and its last.  A spy on the integrator's lattice
builds keeps references to the states they bin, which at a build before
every pass are in stable order: the first build bins the interval's
input, the third the state after the first step, the one before the last
step's predictor the state before it; the interval's output is the state
after the last step, with its neighbour counts.  The counts of the first
step stay inside the integrator, so they are compared at the last.  The
spy also checks the hand-offs it sees: the first build takes the
interval's input, each predictor's build the old_v of the build before
it, and two builds a step.
"""
from __future__ import annotations

import os
from unittest import mock

import numpy as np
import torch

from perfbench.loops.frames import (FIELDS, compare as frame_compare,
                                    differs, initial_fields, settled_rows)
from perfbench.reference import branching as ref

# the numbers :func:`compare` gives
COMPARED = ("n_gap", "nbs_gap", "off_share", "old_v_share", "pos_gap")


def compare(out, want, tol):
    """The numbers of ``frames.compare`` that a step without divisions is
    judged by: the gap in the count of cells, the rows whose neighbour
    counts differ, the share of rows off in a position, the polarity, u
    or v, the share whose old_v is off, and the widest gap of a
    position."""
    none = torch.zeros(0, dtype=torch.int32)
    got = frame_compare(dict(out, nodes=0, clone=none),
                        dict(want, nodes=0, clone=none), tol)
    return {k: got[k] for k in COMPARED}


class BuildSpy:
    """Watches one interval's lattice builds: keeps references to the
    states of the first step's first build and the third, of the last
    step's first, and counts the builds; compares the hand-offs it
    sees."""

    def __init__(self, lx, X, old_v, steps):
        self.lx, self.X, self.old_v, self.steps = lx, X, old_v, steps
        self.calls = 0
        self.kept = {}
        self.last_ov = None
        self.gaps = []

    def __enter__(self):
        real = self.lx.lattice_build
        spy = self

        def build(X, old_v, *args, **kwargs):
            k = spy.calls
            if k == 0:
                spy.gaps.append(differs((X, old_v), (spy.X, spy.old_v)))
            elif k % 2:
                # the predictor's pass takes the step's old_v
                spy.gaps.append(differs(old_v, spy.last_ov))
            if k in (0, 2, 2 * spy.steps - 2):
                spy.kept[k] = (X, old_v)
            spy.last_ov = old_v
            spy.calls += 1
            return real(X, old_v, *args, **kwargs)
        self.patch = mock.patch.object(self.lx, "lattice_build", build)
        self.patch.start()
        return self

    def __exit__(self, *exc):
        self.patch.stop()

    def finish(self):
        self.gaps.append(abs(self.calls - 2 * self.steps))


def state_of(X, old_v, n, aux=None):
    """A state in the reference's form; ``aux`` the neighbour counts."""
    out = {"X": {f: getattr(X, f) for f in FIELDS}, "old_v": list(old_v),
           "n": int(n)}
    if aux is not None:
        out["epi_nbs"], out["mes_nbs"] = aux
    return out


class Loop:
    """One cell's run of the integrator: set up (the state, the engine, a
    warm-up segment) on construction, then :meth:`interval` per
    ``take_steps`` call."""

    def __init__(self, cfg, traffic, seed, device):
        from yalla_tpu_torch.dtypes import Float3
        from yalla_tpu_torch.models import branching as B
        from yalla_tpu_torch.ops import lattice_xla
        from yalla_tpu_torch.polarity import polarity_precompute3
        from yalla_tpu_torch.solvers import (LatticeEngine, SimulationError,
                                             Solution, friction_w_neighbour)
        self.lx, self.SimulationError = lattice_xla, SimulationError
        self.cfg, self.traffic = cfg, traffic
        self.dev = torch.device(device)
        self.p = B.Params()
        self.S = int(traffic["steps_per_interval"])
        self.K = int(traffic["intervals_per_segment"])
        self.cells = Solution(B.Cell, int(cfg["n_max"]),
                              engine=LatticeEngine(**traffic["engine"]),
                              cube_size=self.p.r_max, device=self.dev)
        st = cfg["state"]
        rows = settled_rows(os.path.join(cfg["root"], st["file"]),
                            st["sha256"], int(st["n"]))
        X, old_v, n = initial_fields(rows, self.cells.n_pad, seed, self.dev)
        self.held = (B.Cell(*(X[f] for f in FIELDS)), Float3(*old_v), n)
        self.force = B.make_force(self.p)
        self.kw = dict(pw_friction=friction_w_neighbour,
                       precompute=polarity_precompute3)
        rng = np.random.default_rng([seed, 7])
        others = rng.choice(np.arange(1, self.K),
                            int(traffic["sample_intervals"]) - 1,
                            replace=False)
        self.picks = {0} | {int(k) for k in others}
        self.trace_states = None
        self.min_intervals = self.K
        # warm-up: one segment
        self.restart()
        for _ in range(self.K):
            self.interval()
        self.restart()

    def restart(self):
        """Back to the window's first interval, with nothing recorded."""
        self.count = self.failed = 0
        self.counts = {"segments": 0, "flagged": 0}
        self.samples, self.handoffs = [], []

    def interval(self):
        """``steps_per_interval`` steps, their flags read back.  Returns
        (cell-steps, Heun steps)."""
        s, k = divmod(self.count, self.K)
        cells = self.cells
        if k == 0:
            cells.d_X, cells.d_old_v, cells.d_n = self.held
            self.counts["segments"] += 1
        X, old_v, n = cells.d_X, cells.d_old_v, cells.d_n
        try:
            if s == 0 and k in self.picks:
                with BuildSpy(self.lx, X, old_v, self.S) as spy:
                    aux = self.take_steps()
                spy.finish()
                self.handoffs += spy.gaps
                self.sample(spy, n, aux)
            else:
                self.take_steps()
        except self.SimulationError:
            # a flag: the rest of the segment is not run
            self.failed += 1
            self.counts["flagged"] += 1
            self.count = (s + 1) * self.K
            return n * self.S, self.S
        if self.trace_states is not None:
            self.trace_states.append(((X.x, X.y, X.z), (
                cells.d_X.x, cells.d_X.y, cells.d_X.z), n))
        self.count += 1
        return n * self.S, self.S

    def take_steps(self):
        return self.cells.take_steps(self.S, self.p.dt, self.force,
                                     **self.kw)

    def sample(self, spy, n, aux):
        """Keep the interval's first and last step: (the state before it,
        the program's state after it); nothing where the spy did not see
        the interval whole."""
        kept, cells = spy.kept, self.cells
        if spy.calls != 2 * self.S or len(kept) < 3:
            return
        self.samples.append((state_of(*kept[0], n),
                             state_of(*kept[2], n)))
        self.samples.append((state_of(*kept[2 * self.S - 2], n),
                             state_of(cells.d_X, cells.d_old_v, n,
                                      (aux["epi_nbs"], aux["mes_nbs"]))))

    def close(self):
        """End of the window: nothing is queued."""

    def trace_begin(self):
        self.trace_states = []

    def trace_end(self):
        pass

    def pass_states(self):
        """The traced window's states, each with the K1 passes it stands
        for: an interval's two passes a step split between its first and
        its last state."""
        return [(xyz, n, self.S) for a, b, n in self.trace_states or ()
                for xyz in (a, b)]

    def release(self):
        """Free what the check and the readers do not read: the engine's
        state and the held state; the samples and the traced window's
        states stay."""
        self.cells = self.held = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_outputs(self, dtype=torch.float32):
        """The reference's state after each sampled step, from the same
        state before it."""
        out = []
        for before, after in self.samples:
            X = {f: v.to(dtype) for f, v in before["X"].items()}
            old_v = [v.to(dtype) for v in before["old_v"]]
            X, old_v, epi, mes, _ = ref.heun_step(X, old_v, before["n"],
                                                  self.p, dtype)
            out.append({"X": {f: v.float() for f, v in X.items()},
                        "old_v": [v.float() for v in old_v],
                        "n": before["n"], "epi_nbs": epi.float(),
                        "mes_nbs": mes.float()})
        return out

    def readings(self, control=False, refs=None):
        """The compared numbers, each the worst over the sampled steps:
        the program's (or, with ``control``, the reference's in bfloat16
        in its place); None where a pick was not sampled.  A first step's
        neighbour counts are not the program's to hand out: there the
        reference's stand on both sides."""
        tol = self.cfg["tolerance"]
        refs = refs if refs is not None else self.reference_outputs()
        outs = self.reference_outputs(torch.bfloat16) if control \
            else [after for _, after in self.samples]
        worst = dict.fromkeys(COMPARED)
        for out, want in zip(outs, refs):
            if "epi_nbs" not in out:
                out = dict(out, epi_nbs=want["epi_nbs"],
                           mes_nbs=want["mes_nbs"])
            for key, v in compare(out, want, tol).items():
                worst[key] = v if worst[key] is None else max(worst[key], v)
        if len(refs) < 2 * len(self.picks):
            worst = dict.fromkeys(COMPARED)
        return worst

    def handoff_gap(self):
        """Hand-offs in the sampled intervals whose state differs from
        what the call before made, and builds short of or beyond two a
        step."""
        return float(sum(int(g) for g in self.handoffs))

    def checks(self):
        """{name: value}: the numbers that decide ``correct``."""
        out = self.readings()
        out["handoff_gap"] = self.handoff_gap()
        out["failed"] = float(self.failed)
        return out

    def cleanup(self):
        pass
