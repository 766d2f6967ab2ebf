"""Closed loop: every carrier's periodic capture is fed in chunks as
fast as `feed` returns. A sample is due when it is handed to `feed`.

Mix parameters: `chunk_blocks`, the chunk as a share of the bank's
block (`2 * block_symbols` samples a carrier)."""
from __future__ import annotations

import time


def chunk(session, mix: dict) -> int:
    return int(round(mix["chunk_blocks"] * session.block))


def drive(session, mix: dict, seconds: float, max_blocks: int | None = None
          ) -> dict:
    """Feed until `seconds` have passed (or `max_blocks` blocks were
    finalized); returns the window's start and end times."""
    n = chunk(session, mix)
    fins0 = len(session.fin_s)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds and (
            max_blocks is None or len(session.fin_s) - fins0 < max_blocks):
        session.feed(n)
    return dict(t0=t0, t1=time.perf_counter())
