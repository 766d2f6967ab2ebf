"""Device ms per step of the operations inside a profiler range:
`spec["range"]` names the range (a `record_function` of the program, or
the benchmark's `step_fn`)."""


def read(ctx, spec):
    s = ctx.trace.range_s(spec["range"])
    if s is None or ctx.steps == 0:
        return None
    return s / ctx.steps * 1e3
