"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
with one tiny cell added as files (2 carriers of short QPSK 1/3 frames,
8 frames a step), on which the harness runs with device="cpu"."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_TRAFFIC = {"tiny_replay": {"driver": "replay", "chunk_blocks": 0.5,
                                "warmup_blocks": 3, "sample_span": 3,
                                "trace_blocks": 6},
                "tiny_live": {"driver": "live", "chunk_samples": 16384,
                              "rate_msps": 0.4, "warmup_blocks": 3,
                              "sample_span": 3, "trace_blocks": 6}}


def tiny_config() -> dict:
    c = json.loads((REPO / "rxbench/configs/s2_qpsk12_bank8.json").read_text())
    c.update(name="tiny", modcod=2, framesize="short", carriers=2,
             frames_per_step=8, clock_slip_samples=8, es_n0_db=5.0,
             source="test: EN 302 307-1 MODCOD 2, short frames",
             reduced=["carriers", "frames_per_step"])
    return c


def add_tiny_cell(root: Path) -> None:
    """Adds the tiny configuration, its two traffic mixes, its two cells
    and one per-layer metric as new files and manifest entries."""
    bench = root / "rxbench"
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    for name, mix in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (bench / "metrics" / "tiny_enqueue_ms.json").write_text(json.dumps(
        {"reader": "host_ms", "span": "step_fn", "layer": "bank step",
         "unit": "ms", "source": "host_clock",
         "moves": "rx_msamples_per_s"}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append(dict(name="tiny", source="test",
                             file="rxbench/configs/tiny.json",
                             reduced=["carriers", "frames_per_step"],
                             why="test"))
    m["workloads"] += [
        dict(name="tiny.replay", config="tiny", traffic="tiny_replay",
             chips=1, why="test"),
        dict(name="tiny.live", config="tiny", traffic="tiny_live", chips=1,
             why="test")]
    for e in m["end_to_end"]:
        if "workloads" in e:
            e["workloads"].append("tiny.replay")
    m["per_layer"].append(dict(name="tiny_enqueue_ms", unit="ms",
                               better="lower", source="host_clock",
                               layer="bank step", moves="rx_msamples_per_s",
                               workloads=["tiny.replay"]))
    (root / "BENCHMARK.json").write_text(json.dumps(m))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("rxbench_copy")
    shutil.copytree(REPO / "rxbench", root / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    add_tiny_cell(root)
    return root
