"""Step-rate logging, device tracing, and the program's spans and counters.

Counterpart of ``yalla_tpu/utils/profiling.py``.  Kernels run
asynchronously on the card, so :class:`StepTimer` waits for the card
before it reads the clock; :func:`trace` records a ``torch.profiler``
trace of the card's kernels and the host's calls, the program's spans
among them.

**Spans and counters.**  The program marks its layers' boundaries with
:func:`span` (``<layer>.<what>``: ``frame``, ``growth.proliferate``,
``integrator.heun_step``, ``output.job``, ...) and counts work with
:func:`count` (``kernels.<kernel>`` launches, ``output.bytes``, ...).
Both record into one table in memory while tracing is on: while a
``torch.profiler`` records on the calling thread, or inside a
:func:`tracing` block.  A span records its count, its wall seconds and
its self seconds (the wall seconds less those of the spans opened inside
it on its thread); on the main thread under the profiler it also opens
``torch.profiler.record_function(name)``, so that it lands on the
profiler's timeline, on the clock of the card's kernels.  While tracing
is off, :func:`span` returns one shared object that does nothing: no
allocation, no clock read.  Spans and counters named ``setup.*`` (the
kernels' build and load, once a process) record whether tracing is on
or not.  Work handed to another thread records there if :func:`carry`
wrapped it while tracing was on; such spans go into the table only.
Inside a :func:`tally` block the counts made on its thread go to the
block's own dict instead of the table (a CUDA graph's capture launches
nothing; its replays count what it launches).

    >>> with tracing():
    ...     frame(state, 0.0)
    >>> spans()["integrator.heun_step"]     # (count, total_s, self_s)
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

import torch
from torch.autograd import _profiler_enabled

__all__ = ["StepTimer", "trace", "span", "spanned", "count", "tracing",
           "spans", "counters", "clear", "enabled", "carry", "tally"]

# names that record whether tracing is on or not
SETUP = "setup."
_MAIN = threading.main_thread().ident
_lock = threading.Lock()
_spans = {}          # name -> [count, total_s, self_s]
_counters = {}       # name -> value
_depth = 0           # tracing() blocks open, on any thread
_carried = 0         # carry()'d calls running, on any thread
_local = threading.local()      # .stack: open spans; .carried: bool;
#                                 .tally: the open tally() block's dict


def enabled():
    """Whether spans and counters record on the calling thread now."""
    return bool(_depth or _profiler_enabled()
                or (_carried and getattr(_local, "carried", False)))


class _Off:
    """The span of a call while tracing is off: nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "inner", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler_enabled() and threading.get_ident() == _MAIN:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].inner += dt
        with _lock:
            e = _spans.setdefault(self.name, [0, 0.0, 0.0])
            e[0] += 1
            e[1] += dt
            e[2] += dt - self.inner
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name):
    """A context manager timing its block as the span ``name`` while
    tracing is on (see the module docstring)."""
    if enabled() or name.startswith(SETUP):
        return _Span(name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, k=1):
    """Add ``k`` to the counter ``name`` while tracing is on; inside a
    :func:`tally` block, to the block's dict whether tracing is on or
    not."""
    t = getattr(_local, "tally", None)
    if t is not None:
        t[name] = t.get(name, 0) + k
    elif enabled() or name.startswith(SETUP):
        with _lock:
            _counters[name] = _counters.get(name, 0) + k


@contextlib.contextmanager
def tracing():
    """Record spans and counters in the block, on every thread.  The
    outermost block starts from an empty table; a block inside another
    records into the outer one's table."""
    global _depth
    with _lock:
        if not _depth:
            _spans.clear()
            _counters.clear()
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1


@contextlib.contextmanager
def tally():
    """Collect the counts made on this thread in the block into the dict
    it yields (``{name: value}``), whether tracing is on or not; they do
    not go into the table."""
    before = getattr(_local, "tally", None)
    _local.tally = out = {}
    try:
        yield out
    finally:
        _local.tally = before


def spans():
    """``{name: (count, total_s, self_s)}`` of the spans recorded."""
    with _lock:
        return {k: tuple(v) for k, v in _spans.items()}


def counters():
    """``{name: value}`` of the counters recorded."""
    with _lock:
        return dict(_counters)


def clear():
    """Empty the table."""
    with _lock:
        _spans.clear()
        _counters.clear()


def carry(fn):
    """``fn`` to be called on another thread: there it records its spans
    and counters if tracing is on here and now (a worker's spans go into
    the table only, not onto the profiler's timeline)."""
    if not enabled():
        return fn

    def run(*args, **kwargs):
        global _carried
        with _lock:
            _carried += 1
        before = getattr(_local, "carried", False)
        _local.carried = True
        try:
            return fn(*args, **kwargs)
        finally:
            _local.carried = before
            with _lock:
                _carried -= 1
    return run


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
