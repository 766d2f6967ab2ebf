"""Tracing and per-stage observability: the port's one span mechanism.

PyTorch port of dvbs_tpu/profiling.py. Three surfaces:

- `span(name, stats=None)`: a context manager around a stretch of host
  code. With a `stats` (a `PipelineStats`) it adds the stretch's
  `perf_counter_ns` to that stage's total; while a profiler records it
  also opens a `record_function` range of the same name, so the trace
  (on the profiler's clock) sees it and the device operations launched
  inside it. With no profiler recording it opens no range and makes no
  object of its own: one timer a (stats, name) is reused, and without
  `stats` the span is a shared no-op (what stays alive while it is
  open is the `with` statement's bound `__exit__`, as for any context
  manager; a `@contextmanager` function makes two objects more).
  While a CUDA-graph capture is in progress (`capturing`, graphs.py)
  every span goes to the capture's hook instead, which cuts the capture
  at the span's edges; outside one that costs a span one check of a
  module-level value and the call of `open_span`.
- `device_trace(path)`: context manager around torch.profiler that
  records host and device activity of everything inside the block and
  writes a Chrome trace (Perfetto, chrome://tracing) to `path`.
- `PipelineStats`: host-side counters the streaming drivers update per
  block: samples in, frames seen/ok, TS bytes out, LDPC trial
  histogram, the bank's escalations, host BCH repairs, FIFO bytes
  copied and bytes uploaded, its early fetches of a step's small
  outputs and those complete when their block's finalize began, each
  block's turn from its step's call to the end of its finalize, the
  step's CUDA-graph captures and replays and its eager steps, and the
  spans' totals. Always on.

Usage:
    stream = DVBS2Stream(...)
    ... feed ...
    print(stream.stats.report())

    with profiling.span("parse", stream.stats):
        ...

    with profiling.device_trace("trace.json") as prof:
        stream.feed(samples)
    print(prof.key_averages().table(sort_by="cuda_time_total"))
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_now = time.perf_counter_ns
TURNS_KEPT = 4096            # blocks whose turn the report summarises


class _Timer:
    """The host time of one named stage of one stats: entered and left
    in place, so a span with no profiler recording allocates nothing
    garbage-collected (a stack of start times lets the stage nest)."""

    __slots__ = ("total_ns", "calls", "_t0")

    def __init__(self):
        self.total_ns = 0
        self.calls = 0
        self._t0 = []

    def __enter__(self):
        self._t0.append(_now())
        return self

    def __exit__(self, exc_type, exc, tb):
        self.total_ns += _now() - self._t0.pop()
        self.calls += 1


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


_NULL = _Null()


class _Traced:
    """A span opened while a profiler records: its `record_function`
    range, closed on exit even where the profiler stopped meanwhile,
    and the stats' timer if any."""

    __slots__ = ("_rf", "_timer")

    def __init__(self, name: str, timer):
        self._rf = record_function(name)
        self._timer = timer

    def __enter__(self):
        if self._timer is not None:
            self._timer.__enter__()
        self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._rf.__exit__(exc_type, exc, tb)
        if self._timer is not None:
            self._timer.__exit__(exc_type, exc, tb)


def span(name: str, stats=None):
    """A span of host code named `name`: timed into `stats` (a
    `PipelineStats`) where given, and a profiler range of that name
    while a profiler records."""
    if _capture is not None:
        return _capture(name, stats)
    return open_span(name, stats)


def open_span(name: str, stats=None):
    """`span` as it is outside a capture: what a capture's hook opens."""
    if _profiler_enabled():
        return _Traced(name, None if stats is None else stats.timer(name))
    if stats is None:
        return _NULL
    t = stats._timers.get(name)
    return t if t is not None else stats.timer(name)


_capture = None     # the span hook of the capture in progress, if any


@contextlib.contextmanager
def capturing(hook):
    """Inside the block every `span(name, stats)` returns `hook(name,
    stats)`, a context manager that opens `open_span(name, stats)` in
    its turn (graphs.SegmentRecorder.span, which cuts a CUDA-graph
    capture at the span's edges). One capture at a time."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is already in progress")
    _capture = hook
    try:
        yield
    finally:
        _capture = None


@contextlib.contextmanager
def device_trace(path: str):
    """Profile everything inside the block (CPU, and CUDA when there is
    a card); the Chrome trace goes to `path`. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


class PipelineStats:
    """Per-stream counters mirroring (and extending) the reference GUI's
    live numbers (main.cpp:440-500)."""

    def __init__(self):
        self._timers = {}            # stage -> _Timer, in first-run order
        self.samples_in = 0
        self.blocks = 0
        self.frames_seen = 0
        self.frames_ok = 0
        self.ts_bytes_out = 0
        self.trial_hist = collections.Counter()   # ldpc sweeps -> frames
        self.escalations = 0         # full-budget LDPC reruns
        self.bch_repaired = 0        # frames repaired by the host BCH
        self.fifo_bytes = 0          # FIFO concatenation and block stacking
        self.upload_bytes = 0        # host to device
        self.fetches = 0             # the bank's early fetches issued
        self.fetch_ready = 0         # of them, done when finalize began
        self.turns = collections.deque(maxlen=TURNS_KEPT)   # (block, ns)
        # the counters of each step program the stream has run
        # (parallel/mesh.CarrierBank.counts: graph captures, replays and
        # eager steps), summed in the report
        self.step_counts = []
        self._t_start = time.perf_counter()

    def timer(self, name: str) -> _Timer:
        t = self._timers.get(name)
        if t is None:
            t = self._timers[name] = _Timer()
        return t

    @property
    def stages(self) -> dict:
        """Stage name -> (host seconds in all, calls)."""
        return {k: (t.total_ns / 1e9, t.calls)
                for k, t in self._timers.items()}

    def block_done(self, n_samples: int, frame_ok, trials, ts_bytes: int):
        self.blocks += 1
        self.samples_in += int(n_samples)
        self.frames_seen += len(frame_ok)
        self.frames_ok += int(np.count_nonzero(frame_ok))
        self.ts_bytes_out += int(ts_bytes)
        vals, counts = np.unique(np.asarray(trials), return_counts=True)
        for v, n in zip(vals.tolist(), counts.tolist()):
            self.trial_hist[int(v)] += n

    def turn(self, block: int, ns: int):
        """Block `block` took `ns` from its step's call to the end of
        its finalize."""
        self.turns.append((block, ns))

    def report(self) -> str:
        el = time.perf_counter() - self._t_start
        lines = [
            f"blocks {self.blocks}  samples {self.samples_in}"
            f" ({self.samples_in / max(el, 1e-9) / 1e6:.2f} Msamp/s wall)",
            f"frames {self.frames_ok}/{self.frames_seen} ok"
            f"  ts_bytes {self.ts_bytes_out}",
            "ldpc trials: " + " ".join(
                f"{k}:{v}" for k, v in sorted(self.trial_hist.items())),
            f"escalations {self.escalations}  bch repaired "
            f"{self.bch_repaired}  fifo bytes {self.fifo_bytes}  "
            f"uploaded bytes {self.upload_bytes}",
        ]
        if self.fetches:
            lines.append(f"fetches {self.fetches}  fetch_ready "
                         f"{self.fetch_ready}")
        if self.step_counts:
            tot = {}
            for counts in self.step_counts:
                for k, v in counts.items():
                    tot[k] = tot.get(k, 0) + v
            lines.append("  ".join(f"{k} {v}" for k, v in tot.items()))
        if self.turns:
            ms = np.array([ns for _, ns in self.turns]) / 1e6
            lines.append(f"turn ms (last {len(ms)} blocks): median "
                         f"{np.median(ms):.2f}  p95 "
                         f"{np.percentile(ms, 95):.2f}")
        for name, t in self._timers.items():
            lines.append(f"  stage {name:14s} {t.total_ns / 1e6:9.1f} ms "
                         f"total  {t.total_ns / max(t.calls, 1) / 1e6:7.2f}"
                         f" ms/call x{t.calls}")
        return "\n".join(lines)
