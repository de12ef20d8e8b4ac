"""Step-rate logging and device tracing.

Counterpart of ``yalla_tpu/utils/profiling.py``.  Kernels run
asynchronously on the card, so :class:`StepTimer` waits for the card
before it reads the clock; :func:`trace` records a ``torch.profiler``
trace of the card's kernels and the host's calls.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["StepTimer", "trace"]


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Tracks integration throughput (cell-steps/s).

    >>> timer = StepTimer(n_cells=500_000)
    >>> for _ in range(100):
    ...     cells.take_step(dt, force); timer.tick()
    >>> print(timer.report())

    The clock is read after the card has finished the work queued so far:
    at the start, and at every ``elapsed``."""

    def __init__(self, n_cells=None, every=0, verbose=False):
        self.n_cells = n_cells
        self.every = every
        self.verbose = verbose
        _sync()
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n_steps=1):
        self.steps += n_steps
        if self.verbose and self.every and self.steps % self.every == 0:
            print(self.report(), end="\r", flush=True)

    @property
    def elapsed(self):
        _sync()
        return time.perf_counter() - self.t0

    @property
    def steps_per_sec(self):
        return self.steps / max(self.elapsed, 1e-9)

    def report(self):
        elapsed = self.elapsed
        rate = self.steps / max(elapsed, 1e-9)
        msg = f"{self.steps} steps, {elapsed:.1f}s ({rate:.1f} steps/s"
        if self.n_cells:
            msg += f", {self.n_cells * rate:.3g} cell-steps/s"
        return msg + ")"


@contextlib.contextmanager
def trace(log_dir="trace"):
    """Record the block's kernels (on the card, where there is one) and
    host calls with ``torch.profiler``; on exit the trace is written to
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto).
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
