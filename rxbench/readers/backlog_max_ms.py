"""The most the receiver fell behind an arrival schedule, in ms: the
longest any chunk waited past its due time before `feed` took it."""


def read(ctx, spec):
    if not ctx.backlog:
        return None
    return max(ctx.backlog) * 1e3
