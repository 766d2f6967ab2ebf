"""The benchmark of dvbs_tpu_torch: one cell, once.

    python3 rxbench/run.py --workload CELL --seed N --seconds S --trace 0|1

prints, as the last line of its standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`
(and with --trace 1 `breakdown`), and last `checks`, each number compared
beside its limit; the same numbers end its standard error. It runs on
the card it is started on and exits non-zero, with no result, without
one.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of a run stays in the checkout, at fixed paths
CACHE = ROOT / "rxbench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    from rxbench import harness
    chips = harness.Manifest(ROOT).cell(a.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rxbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; no result", file=sys.stderr)
        return 2
    line = harness.run_cell(ROOT, a.workload, a.seed, a.seconds,
                            bool(a.trace), device="cuda", t_start=T_START)
    if line is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
