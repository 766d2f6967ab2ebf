#!/usr/bin/env python3
"""The bank stream's fetch of a step's outputs, at a chosen chunk size.

Sets up a benchmark cell's session (`rxbench.harness.set_up`: the
configuration's captures, the bank, the warm-up), then feeds it closed
loop and untraced, in chunks of `--chunk-blocks` blocks a carrier, for
`--seconds`, and prints one JSON line over that window:

- `rate`: Msamples/s consumed, summed over carriers;
- `blocks`, and `look_aheads`: the dispatches made while another block
  was pending (a look-ahead needs a block and an advance in the FIFO,
  so only chunks of about a block or more make them);
- host ms a block of `_finalize` and of the spans `bank.fetch`,
  `bank.prefetch`, `bank.upload` and `bank.fifo` (a span the stream
  does not have reads 0);
- the stream's `fetches` and `fetch_ready` counters, where it has them;
- `ok`: every frame seen in the window was decoded.

Run from the root of a checkout, on a card:

    python3 tools/bank_fetch_probe.py --chunk-blocks 2 --seconds 10
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SPANS = ("bank.fetch", "bank.prefetch", "bank.upload", "bank.fifo")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="s2_32apsk34p_bank8.replay")
    ap.add_argument("--chunk-blocks", type=float, default=0.5)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=3000000019)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    from rxbench.harness import Manifest, set_up
    session = set_up(Manifest(ROOT), a.workload, a.seed, a.device)[0]
    st = session.stream
    ahead, dispatch = [0], st._dispatch

    def counted(*args):
        ahead[0] += st._pending is not None
        return dispatch(*args)
    st._dispatch = counted

    def counters():
        s = st.stats
        return dict(stages=s.stages, fins=len(session.fin_s),
                    fin_s=sum(session.fin_s), consumed=session.consumed(),
                    fetches=getattr(s, "fetches", None),
                    fetch_ready=getattr(s, "fetch_ready", None),
                    frames=session.frames(), ahead=ahead[0])

    n = int(round(a.chunk_blocks * session.block))
    c0, t0 = counters(), time.perf_counter()
    while time.perf_counter() - t0 < a.seconds:
        session.feed(n)
    t1 = time.perf_counter()
    c1 = counters()

    blocks = c1["fins"] - c0["fins"]

    def ms(name):
        s1 = c1["stages"].get(name, (0.0, 0))[0]
        s0 = c0["stages"].get(name, (0.0, 0))[0]
        return round((s1 - s0) / max(1, blocks) * 1e3, 4)

    line = dict(workload=a.workload, chunk_blocks=a.chunk_blocks,
                seed=a.seed,
                rate=round((c1["consumed"] - c0["consumed"]) /
                           (t1 - t0) / 1e6, 2),
                blocks=blocks, look_aheads=c1["ahead"] - c0["ahead"],
                finalize_ms=round((c1["fin_s"] - c0["fin_s"]) /
                                  max(1, blocks) * 1e3, 4))
    for name in SPANS:
        line[name.split(".")[1] + "_ms"] = ms(name)
    if c1["fetches"] is not None:
        line["fetches"] = c1["fetches"] - c0["fetches"]
        line["fetch_ready"] = c1["fetch_ready"] - c0["fetch_ready"]
    seen = c1["frames"][0] - c0["frames"][0]
    decoded = c1["frames"][1] - c0["frames"][1]
    line["ok"] = seen == decoded and seen > 0
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
