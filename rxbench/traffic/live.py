"""Open loop: samples arrive on a fixed schedule, in chunks of
`chunk_samples` a carrier at `rate_msps` Msamples/s summed over the
carriers. A virtual generator releases every chunk that is due when the
receiver asks, all of them in one `feed` call; the schedule never slows
when the receiver falls behind. A sample is due at its time on the
schedule, so a backlog counts in the latency.

Mix parameters: `chunk_samples`, `rate_msps`."""
from __future__ import annotations

import time


def chunk(session, mix: dict) -> int:
    return int(mix["chunk_samples"])


def drive(session, mix: dict, seconds: float, max_blocks: int | None = None
          ) -> dict:
    """Run the schedule for `seconds` (or until `max_blocks` blocks were
    finalized). Returns the window's times, the schedule (its start, the
    sample it starts at, samples a second a carrier) and the backlog
    of each release: how long the oldest chunk it released had waited."""
    n = chunk(session, mix)
    rate = mix["rate_msps"] * 1e6 / session.C
    fins0 = len(session.fin_s)
    j0 = session.fed
    released = 0
    backlog = []
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds or (
                max_blocks is not None and
                len(session.fin_s) - fins0 >= max_blocks):
            break
        due = int((now - t0) * rate) // n
        if due > released:
            backlog.append(now - (t0 + (released + 1) * n / rate))
            session.feed((due - released) * n)
            released = due
        else:
            time.sleep(max(0.0, t0 + (released + 1) * n / rate -
                           time.perf_counter()))
    return dict(t0=t0, t1=time.perf_counter(), sched_t0=t0, sched_j0=j0,
                rate=rate, backlog=backlog)
