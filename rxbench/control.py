"""Runs a cell with a fault planted (faults.py) and prints its checks.

    python3 rxbench/control.py --workload CELL --seconds S --fault NAME --seeds N1 N2 ...

One JSON line a seed: the fault, the seed, `correct` and every number
compared with its limit. The control and the faults must come out not
correct; their readings set the upper end of each limit (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from rxbench import faults, harness
    for seed in a.seeds:
        with faults.planted(a.fault) as prepare:
            line = harness.run_cell(ROOT, a.workload, seed, a.seconds, False,
                                    device=a.device, prepare=prepare)
        print(json.dumps(dict(fault=a.fault, seed=seed,
                              correct=line["correct"],
                              checks=line["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
