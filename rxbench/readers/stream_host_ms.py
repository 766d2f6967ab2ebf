"""Host ms per block that `DVBS2BankStream.feed` spends outside the step
call and `_finalize`: FIFO concatenation, block stacking, `_upload`."""


def read(ctx, spec):
    h = ctx.host
    if ctx.blocks == 0:
        return None
    rest = sum(h["bank_stream.feed"]) - sum(h["step_fn"]) - \
        sum(h["bank_stream._finalize"])
    return rest / ctx.blocks * 1e3
