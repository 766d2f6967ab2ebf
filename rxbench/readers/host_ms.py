"""Host ms per call of one of the stream's calls, timed by the
benchmark's wrapper around it: `spec["span"]` is `step_fn` (the enqueue
of a step) or `bank_stream._finalize`."""


def read(ctx, spec):
    xs = ctx.host[spec["span"]]
    if not xs:
        return None
    return sum(xs) / len(xs) * 1e3
