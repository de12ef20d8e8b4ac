"""The Heun step as a CUDA graph: one replay a step.

On the card, a Heun step on the kernel lattice engine is about 1,300
device operations, each issued from Python: the host's issue, not the
device, sets the pace.  :func:`run` captures the step once for its key in
a CUDA graph and replays it on every later call with that key: the same
kernels in the same order on the same inputs, so its results are bit for
bit those of the eager step.  ``solvers.step_graph_key`` says which steps
qualify and what their key holds: everything the capture bakes in.

The first call with a key runs eagerly (the warm-up: K1's opt-in to its
shared memory, the plans' caches, the allocator); the second captures the
step and replays it; every later call copies its inputs into the graph's
buffers (the count into a 0-d device tensor), replays, and returns copies
of the graph's outputs, which the frame, the growth, the writer and the
callers' own references hold past the next replay.  At most
:data:`MAX_GRAPHS` graphs are kept, the least recently used evicted first
with its memory pool; a key seen once costs a dict lookup.  The capture is
thread-local (``capture_error_mode="thread_local"``): the asynchronous VTK
writer's worker issues its own copies while a frame runs.

Counters (``utils.profiling``): ``integrator.graph_capture`` and
``integrator.graph_replay`` (a capture's own replay is not counted as
one); the launches counted while the step is captured
(``kernels.lattice_pair``, ``kernels.pour``) are counted again at every
replay, so those counters count launches that ran.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .utils.profiling import count, tally

__all__ = ["MAX_GRAPHS", "run", "keys", "clear"]

# graphs kept: the frame's engine's, and a resized engine's after a redo
MAX_GRAPHS = 2
# keys called once, kept so that their second call captures
_MAX_SEEN = 8
_graphs = OrderedDict()     # key -> _Graph, least recently used first
_seen = OrderedDict()       # key -> None


class _Graph:
    """One captured step: its input buffers, the graph, its outputs and
    the counts made while it was captured."""

    def __init__(self, body, X, old_v, n):
        self.ins = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                    for a in (*X, *old_v)]
        self.n = torch.empty((), dtype=torch.int64, device=X.x.device)
        self.load(X, old_v, n)
        nx = len(X)
        sX, sov = type(X)(*self.ins[:nx]), type(old_v)(*self.ins[nx:])
        self.graph = torch.cuda.CUDAGraph()
        with tally() as self.counts, \
                torch.cuda.graph(self.graph,
                                 capture_error_mode="thread_local"):
            X2, ov2, aux = body(sX, sov, self.n)
        self.types = (type(X2), len(X2), type(ov2), len(ov2), tuple(aux))
        self.outs = [*X2, *ov2, *aux.values()]

    def load(self, X, old_v, n):
        torch._foreach_copy_(self.ins, [*X, *old_v])
        if isinstance(n, torch.Tensor):
            self.n.copy_(n)
        else:
            self.n.fill_(int(n))

    def replay(self):
        """Run the step; copies of its outputs as ``(X, old_v, aux)``."""
        self.graph.replay()
        for name, k in self.counts.items():
            count(name, k)
        outs = [torch.empty_like(a) for a in self.outs]
        torch._foreach_copy_(outs, self.outs)
        x_type, nx, v_type, nv, aux_keys = self.types
        return (x_type(*outs[:nx]), v_type(*outs[nx:nx + nv]),
                dict(zip(aux_keys, outs[nx + nv:])))


def run(key, body, X, old_v, n):
    """``body(X, old_v, n) -> (X', old_v', aux)``, the step of ``key``:
    eagerly at the key's first call, captured at its second, replayed
    from then on (see the module docstring)."""
    g = _graphs.get(key)
    if g is not None:
        _graphs.move_to_end(key)
        g.load(X, old_v, n)
        count("integrator.graph_replay")
        return g.replay()
    if key not in _seen:
        _seen[key] = None
        if len(_seen) > _MAX_SEEN:
            _seen.popitem(last=False)
        return body(X, old_v, n)
    del _seen[key]
    g = _Graph(body, X, old_v, n)
    count("integrator.graph_capture")
    _graphs[key] = g
    if len(_graphs) > MAX_GRAPHS:
        _graphs.popitem(last=False)
    return g.replay()


def keys():
    """The keys of the graphs held, least recently used first."""
    return list(_graphs)


def clear():
    """Drop every graph (and its memory pool) and every key seen."""
    _graphs.clear()
    _seen.clear()
