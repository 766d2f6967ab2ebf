"""A layer's share of its roofline, in %: the least time the card could
take for the work the algorithm needs on these inputs (the larger of
operations over the peak rate and bytes over the peak bandwidth, from
`work/<spec["work"]>.py` and `peaks.json`), over the device time the
trace gives it: of the profiler range `spec["range"]`, or of the kernels
named `spec["kernel"]`, per step."""


def read(ctx, spec):
    t = ctx.trace.range_s(spec["range"]) if "range" in spec \
        else ctx.trace.kernel_s(spec["kernel"])
    if not t or ctx.steps == 0:
        return None
    ops, nbytes = ctx.work(spec["work"])
    bound = max(ops / ctx.peaks["ops_per_s"], nbytes / ctx.peaks["bytes_per_s"])
    return 100.0 * bound / (t / ctx.steps)
