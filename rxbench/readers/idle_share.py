"""Share of the traced window, in %, in which no device operation ran:
100 x (1 - union of operation intervals / window)."""


def read(ctx, spec):
    w = ctx.trace.window_s
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / w)
