"""The highest arrival rate an open-loop cell's receiver sustains.

    python3 rxbench/sweep.py --workload CELL --seed N --seconds S --rates R1 R2 ...

One set-up, then the cell's live driver at each aggregate rate (in
Msamples/s) for S seconds in turn. For each rate it prints one JSON line:
the backlog (how long the oldest released chunk had waited) over the
first and the last fifth of the window, its largest value, and the 95th
percentile of the TS latency. A rate is sustained where the backlog does
not grow over the window. The cell's fixed rate is 0.8 of the highest
rate sustained, rounded down to a whole Msamples/s.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    a = ap.parse_args(argv)
    from rxbench import harness, reference
    import torch
    if not torch.cuda.is_available():
        print("rxbench sweep: no CUDA device", file=sys.stderr)
        return 2
    man = harness.Manifest(ROOT)
    session, conf, mix, driver, carriers = harness.set_up(
        man, a.workload, a.seed, "cuda")
    tx = reference.Transmitter(conf, carriers)
    for rate in a.rates:
        m0 = session.mark()
        win = driver.drive(session, dict(mix, rate_msps=rate), a.seconds)
        m1 = session.mark()
        outs = reference.ts_outputs(session)
        ts = reference.check_ts(tx, session, outs)
        win["feeds0"], win["feeds1"] = m0["feeds"], m1["feeds"]
        lat = reference.latencies(tx, session, outs, ts["q"], win, win)
        b = np.array(win["backlog"]) * 1e3
        k = max(1, len(b) // 5)
        print(json.dumps(dict(
            rate_msps=rate, releases=len(b),
            backlog_first_fifth_ms=float(b[:k].mean()),
            backlog_last_fifth_ms=float(b[-k:].mean()),
            backlog_max_ms=float(b.max()),
            ts_latency_p95_ms=float(np.percentile(lat, 95) * 1e3),
            consumed_msamples_per_s=(m1["consumed"] - m0["consumed"]) /
            (win["t1"] - win["t0"]) / 1e6,
            ts_bad_packets=ts["ts_bad_packets"],
            frames_failed=int((m1["seen"] - m1["ok"]) -
                              (m0["seen"] - m0["ok"])))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
