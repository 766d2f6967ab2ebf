"""Host ms of the program's own spans named `spec["span"]` (its
`profiling.span`s, ranges of the trace on the profiler's clock) inside
the traced window, per block finalized (`spec["per"]` = "block") or per
step; None where the trace holds no such span, as for a program that
has none."""


def read(ctx, spec):
    tr = ctx.trace
    spans = [(a, b) for a, b in tr.spans.get(spec["span"], ())
             if a >= tr.w0 and b <= tr.w1]
    n = ctx.blocks if spec.get("per") == "block" else ctx.steps
    if not spans or n == 0:
        return None
    return sum(b - a for a, b in spans) / 1e3 / n
