"""Reading a torch.profiler Chrome trace of a traced stretch.

Device operations are the trace's `kernel`, `gpu_memcpy` and
`gpu_memset` events. Each carries the correlation id of the runtime call
that launched it (`cuda_runtime`, `cuda_driver`); an operation belongs to
a profiler range (`record_function`, a host `user_annotation` span) when
its launch lies inside the span, so nested ranges each count all the
operations launched inside them. The benchmark's own range
`rxbench.window` marks the traced stretch.
"""
from __future__ import annotations

import bisect
import collections
import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "rxbench.window"
NAME_CHARS = 120             # kernel names in the breakdown, cut


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.ops = sorted((e for e in xs if e.get("cat") in DEVICE_CATS),
                          key=lambda e: e["ts"])
        launch = {e["args"]["correlation"]: e["ts"] for e in xs
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        self.launch = [launch.get(e.get("args", {}).get("correlation"))
                       for e in self.ops]
        self.host_spans = [(e["ts"], e["ts"] + e["dur"], e["name"])
                           for e in xs if e.get("cat") == "user_annotation"]
        self.spans = collections.defaultdict(list)
        for a, b, name in self.host_spans:
            self.spans[name].append((a, b))
        for v in self.spans.values():
            v.sort()
        win = self.spans.get(WINDOW)
        if win:
            self.w0, self.w1 = win[0]
        else:
            self.w0 = min((e["ts"] for e in self.ops), default=0.0)
            self.w1 = max((e["ts"] + e["dur"] for e in self.ops), default=0.0)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_intervals(self) -> list:
        """Union of device-operation intervals inside the window (us)."""
        out = []
        for e in self.ops:
            a = max(e["ts"], self.w0)
            b = min(e["ts"] + e["dur"], self.w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def range_s(self, name: str) -> float | None:
        """Device seconds of the operations launched inside a span of
        range `name`; None where the range has no span."""
        spans = self.spans.get(name)
        if not spans:
            return None
        starts = [a for a, _ in spans]
        tot = 0.0
        for e, t in zip(self.ops, self.launch):
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                tot += e["dur"]
        return tot / 1e6

    def kernel_s(self, substring: str) -> float | None:
        """Device seconds of the kernels whose name holds `substring`."""
        ks = [e["dur"] for e in self.ops
              if e.get("cat") == "kernel" and substring in e["name"]]
        return sum(ks) / 1e6 if ks else None

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for e in self.ops:
            by[e["name"]] += e["dur"]
        return [[k[:NAME_CHARS], v / 1e6] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the window, summed by what the host
        was doing at each gap's middle: the innermost host range open
        then, or `(no range)`."""
        busy = self.busy_intervals()
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        spans = [s for s in self.host_spans if s[2] != WINDOW]
        s0 = np.array([s[0] for s in spans], np.float64)
        s1 = np.array([s[1] for s in spans], np.float64)
        by = collections.Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = np.nonzero((s0 <= mid) & (s1 > mid))[0]
            name = spans[inside[np.argmin(s1[inside] - s0[inside])]][2] \
                if len(inside) else "(no range)"
            by[name] += b - a
        return [[k, v / 1e6] for k, v in by.most_common(n)]
