"""The Heun step, the glue between its pair passes, the Gabriel lattice
pass, the lattice engine's pair pass or the grid engine's gather pass,
as CUDA graphs.

On the card, a Heun step on the kernel lattice engine is about 1,300
device operations, each issued from Python: the host's issue, not the
device, sets the pace.  :func:`run` captures the step once for its key in
a CUDA graph and replays it on every later call with that key: the same
kernels in the same order on the same inputs, so its results are bit for
bit those of the eager step.  ``solvers.step_graph_key`` says which steps
qualify and what their key holds: everything the capture bakes in.

A step that does not qualify whole (another engine, a generic force)
still issues hundreds of glue operations between its two pair passes,
which stay eager Python calls: :func:`segment` captures each stretch of
glue (``solvers.segment_key``; ``solvers._heun`` cuts the step), two
segments a step.  The slot-order integrator at a build before every
pass (``ops.lattice_xla.lattice_heun_steps``) is cut the same way at its
two eager ``lattice_build`` calls a step, each pass and its glue a
segment (``solvers.lattice_segment_key``).  The Gabriel engine's lattice
pass, its build and K5, is about 120 operations more, twice a step:
:func:`gabriel_pass` captures it (``solvers.gabriel_pass_key``), the
pass still a Python call.  The lattice engine's pair pass between a
step's glue segments (its build, K1's wrapper, the gathers back to
stable-id order and the pass's flags; ``LatticeEngine.pairwise`` with
``graph``, which ``solvers._heun`` asks for only where the step's glue
runs as segments) is captured the same way in a cache of its own
(:func:`lattice_pass`, ``solvers.lattice_pass_key``): the whole step's
graph, whose warm-up and capture call the pass eagerly, holds no pass
graph.  The grid engine's gather pass between the same segments (its
build's sort and scatter tables, the candidate gathers, the pair force
and the sums; ``GridEngine.pairwise`` with ``graph``) is captured in a
third cache (:func:`grid_pass`, ``solvers.grid_pass_key``) under the
same rules.  Its pair force, a Python function, is captured with it: a
pair force reads nothing back, has no shape that depends on the data,
and reads what it reads besides its arguments as the capture found it,
the contract under which the JAX package traces the same force under
``jit`` and under which the segments capture the force's derived-aux
and post-pair hooks.

The first call with a key runs eagerly (the warm-up: K1's opt-in to its
shared memory, the plans' caches, the allocator); the second captures it
and replays it; every later call copies its inputs into the graph's
buffers (each Python int, a count, into a 0-d int64 device tensor),
replays, and returns the graph's outputs: copies of them where they leave
the step (the frame, the growth, the writer and the callers' own
references hold them past the next replay), the graph's own tensors
where the next segment copies them in before any later replay (a
Gabriel pass's are always copies: both passes of a step share one graph,
and a caller may hold the first pass's outputs past the second).  A
lattice pass's outputs are the graph's own, handed straight to the
segment after it, which copies them in before the pass replays again: at
its capture and its replays into its own buffers, at its first, eager
call into fresh tensors (:func:`segment`), so no pass allocates a tensor
once its graph is captured; a grid pass's likewise.  The key a graph is
kept under adds the inputs' structure to the caller's: the containers,
each tensor's shape, dtype and device, where the counts sit, and every
other value (a float, a string) as it is.  At most :data:`MAX_GRAPHS`
whole steps, :data:`MAX_SEGMENTS` segments, :data:`MAX_PASSES` Gabriel
passes, :data:`MAX_LATTICE_PASSES` lattice passes and
:data:`MAX_GRID_PASSES` grid passes are kept, the least recently used
evicted first with its memory pool; a key seen once costs a dict lookup.
The capture is thread-local (``capture_error_mode="thread_local"``): the
asynchronous VTK writer's worker issues its own copies while a frame
runs.

Counters (``utils.profiling``): ``integrator.graph_capture`` and
``integrator.graph_replay`` for whole steps, ``integrator.segment_capture``
and ``integrator.segment_replay`` for segments, ``gabriel.graph_capture``
and ``gabriel.graph_replay`` for Gabriel passes, ``lattice.graph_capture``
and ``lattice.graph_replay`` for lattice passes, ``grid.graph_capture``
and ``grid.graph_replay`` for grid passes (a capture's own replay is not
counted as one); the launches counted while a graph is captured
(``kernels.lattice_pair``, ``kernels.pour``, ``kernels.gabriel_pair``)
are counted again at every replay, so those counters count launches that
ran.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .utils.profiling import count, tally

__all__ = ["MAX_GRAPHS", "MAX_SEGMENTS", "MAX_PASSES", "MAX_LATTICE_PASSES",
           "MAX_GRID_PASSES", "run", "segment", "eager", "gabriel_pass",
           "lattice_pass", "grid_pass", "cache_key", "keys", "segment_keys",
           "pass_keys", "lattice_pass_keys", "grid_pass_keys", "clear"]

# whole steps kept: the frame's engine's, and a resized engine's after a
# redo
MAX_GRAPHS = 2
# segments kept: two a step, for three kinds of step in turn (a
# relaxation's engine and force and the growth's; the tutorial model's
# parts, with the background's friction, with the neighbours' and with
# the protrusions' pull), so that none is captured again at each turn
MAX_SEGMENTS = 6
# Gabriel lattice passes kept: a relaxation's engine's and the growth's
MAX_PASSES = 2
# lattice engine passes kept, apart from the Gabriel passes
MAX_LATTICE_PASSES = 2
# grid engine passes kept: the tutorial model's, with the background's
# friction and with the neighbours'
MAX_GRID_PASSES = 2
# keys called once, kept so that their second call captures
_MAX_SEEN = 8
# the kinds of leaf in a structure
_TENSOR, _COUNT, _VALUE = "tensor", "count", "value"


def _flatten(tree, leaves, ids, counts=True):
    """The structure of ``tree`` as a hashable tuple; its tensors (each
    object once) and, with ``counts``, its ints go to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        k = ids.get(id(tree))
        if k is None:
            k = ids[id(tree)] = len(leaves)
            leaves.append(tree)
        return (_TENSOR, k, tree.shape, tree.dtype, tree.device)
    if counts and type(tree) is int:
        leaves.append(tree)
        return (_COUNT, len(leaves) - 1)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(a, leaves, ids, counts)
                                  for a in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree), tuple(_flatten(a, leaves, ids, counts)
                                         for a in tree.values()))
    return (_VALUE, tree)


def _build(spec, leaves):
    """The tree of structure ``spec`` on ``leaves``."""
    kind = spec[0]
    if kind == _TENSOR or kind == _COUNT:
        return leaves[spec[1]]
    if kind == _VALUE:
        return spec[1]
    if kind is dict:
        return dict(zip(spec[1], (_build(s, leaves) for s in spec[2])))
    items = [_build(s, leaves) for s in spec[1]]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def cache_key(key, tree):
    """The key a graph of ``key`` on the inputs ``tree`` is kept under:
    ``key`` (a tuple) and the inputs' structure, which holds no count's
    value."""
    return _keyed(key, tree)[0]


def _keyed(key, tree):
    """``(cache_key(key, tree), the inputs' leaves)``."""
    leaves = []
    return key + (_flatten(tree, leaves, {}),), leaves


class _Graph:
    """One captured body: its input buffers, the graph, its outputs and
    the counts made while it was captured."""

    def __init__(self, body, spec, leaves, copy):
        dev = next(a.device for a in leaves if isinstance(a, torch.Tensor))
        self.ins = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                    if isinstance(a, torch.Tensor)
                    else torch.empty((), dtype=torch.int64, device=dev)
                    for a in leaves]
        self.tensors = [k for k, a in enumerate(leaves)
                        if isinstance(a, torch.Tensor)]
        self.counts_at = [k for k, a in enumerate(leaves)
                          if not isinstance(a, torch.Tensor)]
        self.load(leaves)
        self.copy = copy
        self.graph = torch.cuda.CUDAGraph()
        with tally() as self.counts, \
                torch.cuda.graph(self.graph,
                                 capture_error_mode="thread_local"):
            out = body(_build(spec, self.ins))
        self.outs = []
        self.out_spec = _flatten(out, self.outs, {}, counts=False)

    def load(self, leaves):
        if self.tensors:
            torch._foreach_copy_([self.ins[k] for k in self.tensors],
                                 [leaves[k] for k in self.tensors])
        for k in self.counts_at:
            self.ins[k].fill_(leaves[k])

    def replay(self):
        """Run the body; its outputs (copies of them with ``copy``)."""
        self.graph.replay()
        for name, k in self.counts.items():
            count(name, k)
        outs = self.outs
        if self.copy:
            outs = [torch.empty_like(a) for a in self.outs]
            torch._foreach_copy_(outs, self.outs)
        return _build(self.out_spec, outs)


class _Cache:
    """The graphs of one kind by key, least recently used first, at most
    ``bound``; the keys called once; the counters ``<name>_capture`` and
    ``<name>_replay``."""

    def __init__(self, bound, name):
        self.bound, self.name = bound, name
        self.graphs = OrderedDict()     # key -> _Graph
        self.seen = OrderedDict()       # key -> None

    def prepare(self, key, body, tree, copy):
        """The graph of ``key`` on ``tree``, its inputs loaded and ready
        to replay (captured from ``body`` at the key's second call), or
        None where ``body`` runs eagerly (the key's first call, or a
        value that does not hash)."""
        full, leaves = _keyed(key, tree)
        try:
            g = self.graphs.get(full)
        except TypeError:               # a value that does not hash
            return None
        if g is not None:
            self.graphs.move_to_end(full)
            g.load(leaves)
            count(self.name + "_replay")
            return g
        if full not in self.seen:
            self.seen[full] = None
            if len(self.seen) > _MAX_SEEN:
                self.seen.popitem(last=False)
            return None
        del self.seen[full]
        g = _Graph(body, full[-1], leaves, copy)
        count(self.name + "_capture")
        self.graphs[full] = g
        if len(self.graphs) > self.bound:
            self.graphs.popitem(last=False)
        return g

    def run(self, key, body, tree, copy):
        g = self.prepare(key, body, tree, copy)
        return body(tree) if g is None else g.replay()


_steps = _Cache(MAX_GRAPHS, "integrator.graph")
_segments = _Cache(MAX_SEGMENTS, "integrator.segment")
_passes = _Cache(MAX_PASSES, "gabriel.graph")
_lattice_passes = _Cache(MAX_LATTICE_PASSES, "lattice.graph")
_grid_passes = _Cache(MAX_GRID_PASSES, "grid.graph")


def run(key, body, X, old_v, n):
    """``body(X, old_v, n) -> (X', old_v', aux)``, the step of ``key``:
    eagerly at the key's first call, captured at its second, replayed
    from then on (see the module docstring)."""
    return _steps.run(key, lambda t: body(*t), (X, old_v, n), True)


def segment(key, body, tree, copy):
    """``body(tree)``, a stretch of a step's glue, under ``key`` (a
    tuple): eagerly at the key's first call, captured at its second,
    replayed from then on; its outputs copied with ``copy``, else the
    graph's own, which the next replay overwrites.  Run eagerly, the body
    takes copies of the tensors a lattice or a grid pass's graph owns, as
    a capture and a replay take them into the segment's buffers."""
    g = _segments.prepare(key, body, tree, copy)
    return body(_unshared(tree)) if g is None else g.replay()


def _unshared(tree):
    """``tree`` with each tensor that a lattice or a grid pass's graph
    holds as an output replaced by a copy: that graph's next replay
    overwrites it."""
    owned = {id(a) for c in (_lattice_passes, _grid_passes)
             for g in c.graphs.values() for a in g.outs}
    if not owned:
        return tree
    leaves = []
    spec = _flatten(tree, leaves, {})
    return _build(spec, [a.clone() if id(a) in owned else a
                         for a in leaves])


def eager(tag, body, tree, copy):
    """``body(tree)``: a segment run as it stands, the callers' default
    where a step's glue is not captured."""
    return body(tree)


def gabriel_pass(key, body, X, old_v, n):
    """The graph of the Gabriel lattice pass ``body(X, old_v, n)`` under
    ``key``, its inputs loaded: call its ``replay()`` for the pass's
    outputs (copies).  None at the key's first call, where the caller
    runs the pass eagerly; captured at its second."""
    return _passes.prepare(key, lambda t: body(*t), (X, old_v, n), True)


def lattice_pass(key, body, X, old_v, n):
    """The graph of the lattice engine's pair pass ``body(X, old_v, n)``
    under ``key``, as :func:`gabriel_pass` gives the Gabriel pass's: its
    inputs loaded, its ``replay()`` the pass's outputs, the graph's own
    (for a :func:`segment` to copy in); None at the key's first call."""
    return _lattice_passes.prepare(key, lambda t: body(*t), (X, old_v, n),
                                   False)


def grid_pass(key, body, X, old_v, n):
    """The graph of the grid engine's gather pass ``body(X, old_v, n)``
    under ``key``, as :func:`lattice_pass` gives the lattice pass's: its
    inputs loaded, its ``replay()`` the pass's outputs, the graph's own
    (for a :func:`segment` to copy in); None at the key's first call."""
    return _grid_passes.prepare(key, lambda t: body(*t), (X, old_v, n),
                                False)


def keys():
    """The keys of the whole steps' graphs held, least recently used
    first."""
    return [k[:-1] for k in _steps.graphs]


def segment_keys():
    """The keys of the segments' graphs held, least recently used
    first."""
    return [k[:-1] for k in _segments.graphs]


def pass_keys():
    """The keys of the Gabriel passes' graphs held, least recently used
    first."""
    return [k[:-1] for k in _passes.graphs]


def lattice_pass_keys():
    """The keys of the lattice passes' graphs held, least recently used
    first."""
    return [k[:-1] for k in _lattice_passes.graphs]


def grid_pass_keys():
    """The keys of the grid passes' graphs held, least recently used
    first."""
    return [k[:-1] for k in _grid_passes.graphs]


def clear():
    """Drop every graph (and its memory pool) and every key seen."""
    for c in (_steps, _segments, _passes, _lattice_passes, _grid_passes):
        c.graphs.clear()
        c.seen.clear()
