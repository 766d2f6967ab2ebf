"""CUDA-graph replay of a step, in segments cut at its spans.

A step of a few hundred small launches costs the host far more to
enqueue than the card takes to run it. `StepGraph` captures such a step
once into a chain of torch.cuda.CUDAGraphs that share one memory pool:
`SegmentRecorder` ends one graph and begins the next at every
`profiling.span` the step enters or leaves. A replay runs the chain in
capture order, each graph inside the same nested spans, opened again by
`span`. A profiler range then owns the same kernels as when the step
runs eagerly: a device operation belongs to the range open at its
launch, and every kernel of a graph to its graph's launch.

Capture needs a step that never synchronises the host, and whose launch
parameters read from the device (backend.host_value), lazy handles and
kernel attributes are already set up: run it once eagerly first. A
capture that fails raises. Each call copies its input into the graphs'
static input and returns clones of the static outputs, so that the
caller owns what it is given, as from the eager step; the next replay
queues behind the clones on the same stream, so one chain serves every
call. `backend.LAUNCHES` counts each kernel a replay launches, as the
eager step's wrappers do.

Two span edges with no launch between them give a graph that captured
nothing. torch tells of one only by the warning its `capture_end`
raises, whose text starts with `EMPTY` (torch 2.11's CUDAGraph.cpp);
such a graph is left out of the chain. Should that text change, the
empty graphs stay in the chain, which still replays correctly at one
more graph launch each; tests/test_torch_cuda.py fails on the card
then.
"""
from __future__ import annotations

import warnings

import torch

from . import backend, profiling

_ENTER, _EXIT, _GRAPH = range(3)
# the start of torch's warning at the end of a capture that recorded
# nothing (see the module's docstring)
EMPTY = "The CUDA Graph is empty"


def input_key(x: torch.Tensor) -> tuple:
    """What a captured chain is valid for: the input's shape, dtype and
    device."""
    return tuple(x.shape), x.dtype, x.device


class _Cut:
    """A span during a capture: the graph before its entry ends, the
    span opens, and a new graph begins inside it; and again at its
    exit."""

    __slots__ = ("rec", "name", "stats", "inner")

    def __init__(self, rec, name, stats):
        self.rec, self.name, self.stats = rec, name, stats

    def __enter__(self):
        self.rec.end()
        self.rec.events.append((_ENTER, (self.name, self.stats)))
        self.inner = profiling.open_span(self.name, self.stats)
        self.inner.__enter__()
        self.rec.begin()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.rec.end()
            self.rec.events.append((_EXIT, None))
        self.inner.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.rec.begin()


class SegmentRecorder:
    """Records `fn(*args)` as graphs cut at its spans. `new_graph()`
    makes a graph (torch.cuda.CUDAGraph; a stub where no card is), each
    captured into memory pool `pool` on the current stream. `events`
    holds, in order, each span's entry (name, stats) and exit and each
    graph that captured anything with the launch counts its capture
    added to backend.LAUNCHES, which the capture takes back out: a
    replay adds them. Keep `graphs` as long as `events`."""

    def __init__(self, new_graph, pool=None):
        self.new_graph = new_graph
        self.pool = pool
        self.events = []
        # every graph made, the empty ones too: each holds a share of
        # the pool, which a graph destroyed during the recording would
        # release under the next capture
        self.graphs = []
        self._graph = None
        self._launches = None

    def begin(self) -> None:
        self._launches = dict(backend.LAUNCHES)
        self._graph = self.new_graph()
        self.graphs.append(self._graph)
        self._graph.capture_begin(pool=self.pool,
                                  capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self._graph = self._graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in caught:
            if EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        counts = tuple((k, n - self._launches[k])
                       for k, n in backend.LAUNCHES.items()
                       if n != self._launches[k])
        for k, n in counts:
            backend.LAUNCHES[k] -= n
        if not empty:
            self.events.append((_GRAPH, (graph, counts)))

    def span(self, name: str, stats=None) -> _Cut:
        return _Cut(self, name, stats)

    def record(self, fn, *args):
        """fn(*args) captured; returns what it returns (tensors the
        replays write). Raises what the capture raises, with the open
        graph's capture ended and the launch counts as they were."""
        launches = dict(backend.LAUNCHES)
        self.begin()
        try:
            with profiling.capturing(self.span):
                out = fn(*args)
            self.end()
        except BaseException:
            if self._graph is not None:
                try:
                    self._graph.capture_end()
                except RuntimeError:
                    pass            # the capture's own error is raised
            backend.LAUNCHES.update(launches)
            raise
        return out


def replay(events: list) -> None:
    """The recorded chain: each graph replayed inside its spans."""
    opened = []
    try:
        for kind, arg in events:
            if kind == _GRAPH:
                graph, counts = arg
                graph.replay()
                for k, n in counts:
                    backend.LAUNCHES[k] += n
            elif kind == _ENTER:
                s = profiling.span(*arg)
                s.__enter__()
                opened.append(s)
            else:
                opened.pop().__exit__(None, None, None)
    finally:
        while opened:
            opened.pop().__exit__(None, None, None)


class StepGraph:
    """`fn` (a dict of tensors from one tensor) captured on a static copy
    of `x`, on the card. Calling it with an input of the same key
    replays the chain and returns fresh tensors."""

    def __init__(self, fn, x: torch.Tensor):
        self.key = input_key(x)
        self.x = x.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        rec = SegmentRecorder(torch.cuda.CUDAGraph,
                              torch.cuda.graph_pool_handle())
        with torch.cuda.stream(side):
            self.out = rec.record(fn, self.x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.events, self.graphs = rec.events, rec.graphs

    @property
    def segments(self) -> int:
        return sum(kind == _GRAPH for kind, _ in self.events)

    def __call__(self, x: torch.Tensor) -> dict:
        self.x.copy_(x)
        replay(self.events)
        return {k: v.clone() for k, v in self.out.items()}
