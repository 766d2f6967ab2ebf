"""The readers of the program's own spans (`span_ms`) and of the device
operations launched inside a range (`range_ops`), and the per-layer
metrics that use them: on the CPU at the tiny cell, from a traced run;
on a synthetic trace that has no `bank.*` span (a program without them);
and, marked `cuda`, on the card at the replay cell
(`python -m pytest rxbench/tests -q -m cuda`)."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from rxbench import harness
from rxbench.trace import Trace

from conftest import REPO

SEED = 2**31 + 54321
SPAN_METRICS = ("span_step_ms", "span_finalize_ms", "span_fetch_ms",
                "span_parse_ms", "span_upload_ms", "span_fifo_ms")
DEVICE_METRICS = ("step_ops", "resample_ms")


@pytest.fixture(scope="module")
def span_root(tiny_root, tmp_path_factory) -> Path:
    """The tiny cell's copy with the eight metrics on the tiny replay
    cell too."""
    root = tmp_path_factory.mktemp("rxbench_spans")
    shutil.copytree(tiny_root / "rxbench", root / "rxbench")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for e in m["per_layer"]:
        if e["name"] in SPAN_METRICS + DEVICE_METRICS:
            e["workloads"].append("tiny.replay")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def test_span_metrics_read_from_a_traced_run(span_root):
    line = harness.run_cell(span_root, "tiny.replay", SEED, 10, True,
                            device="cpu")
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0, name
    assert "step_ops" not in got            # no device operation on the CPU
    assert got["resample_ms"]["value"] == 0.0   # the range, no device time
    # the parts lie inside their wholes (ms a block)
    assert got["span_fetch_ms"]["value"] + got["span_parse_ms"]["value"] \
        <= got["span_finalize_ms"]["value"]


def _trace_without_bank_spans(path: Path) -> Trace:
    ev = [dict(ph="X", cat="user_annotation", name="rxbench.window", ts=0,
               dur=1000),
          dict(ph="X", cat="user_annotation", name="step_fn", ts=10, dur=100),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=20,
               dur=5, args=dict(correlation=1)),
          dict(ph="X", cat="kernel", name="k", ts=30, dur=40,
               args=dict(correlation=1))]
    path.write_text(json.dumps(dict(traceEvents=ev)))
    return Trace(str(path))


def test_readers_give_nothing_without_the_spans(tmp_path):
    """A program without `bank.*` spans or a `resample` range (an older
    one): each of the eight metrics is left out, while the benchmark's
    own range `step_fn` still reads."""
    man = harness.Manifest(REPO)

    class Ctx:
        trace = _trace_without_bank_spans(tmp_path / "t.json")
        steps = blocks = 1
    for name in SPAN_METRICS + DEVICE_METRICS:
        read, spec = man.reader(name)
        assert read(Ctx, spec) is None, name
    read, spec = man.reader("step_device_ms")
    assert read(Ctx, spec) == pytest.approx(0.04)
    read, _ = man.reader("step_ops")
    assert read(Ctx, dict(range="step_fn")) == 1


@pytest.mark.cuda
def test_span_metrics_on_the_card():
    """On the card: a traced replay run reports all eight metrics."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "rxbench/run.py", "--workload",
                        "s2_32apsk34p_bank8.replay", "--seed", str(SEED),
                        "--seconds", "3", "--trace", "1"],
                       capture_output=True, text=True, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"]
    for name in SPAN_METRICS + DEVICE_METRICS:
        assert line["metrics"][name]["value"] > 0, name
