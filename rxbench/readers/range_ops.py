"""Device operations launched inside a profiler range, per step:
`spec["range"]` names the range. None where the trace holds no device
operation (no device trace) or no span of the range."""
from __future__ import annotations

import bisect


def read(ctx, spec):
    tr = ctx.trace
    spans = tr.spans.get(spec["range"])
    if not spans or not tr.ops or ctx.steps == 0:
        return None
    starts = [a for a, _ in spans]
    n = 0
    for t in tr.launch:
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < spans[i][1]:
            n += 1
    return n / ctx.steps
