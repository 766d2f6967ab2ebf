"""The harness on the CPU, at a tiny bank: discovery of a cell, a
configuration, a traffic mix and a metric added as files; both traffic
drivers; the result line; the faults the check must catch; the roofline
counts; the import rules; and the command's refusal without a card."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rxbench import faults, harness, reference
from rxbench.work import demap, ldpc, resample_farrow

from conftest import REPO

SEED = 2**31 + 12345


def test_new_cell_and_metric_are_found_by_name(tiny_root):
    """The tiny cell, its configuration, its traffic mixes and the metric
    `tiny_enqueue_ms` exist only as files added to a copy; the harness
    runs the cell and reads the metric with no other file edited."""
    line = harness.run_cell(tiny_root, "tiny.replay", SEED, 10, True,
                            device="cpu")
    assert line["correct"], line["checks"]
    for f in (REPO / "rxbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and \
                ".cache" not in f.parts:
            copy = tiny_root / f.relative_to(REPO)
            assert copy.read_bytes() == f.read_bytes(), f"{f} was edited"
    assert "tiny_enqueue_ms" in line["metrics"]
    assert line["metrics"]["tiny_enqueue_ms"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_result_line_keys(tiny_root):
    line = harness.run_cell(tiny_root, "tiny.replay", SEED + 1, 3, False,
                            device="cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "host", "checks"]
    assert set(line["metrics"]) == {"rx_msamples_per_s",
                                    "ts_latency_p95_ms", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    assert line["host"]["blocks"] > 0 and line["host"]["enqueue_ms"] > 0


@pytest.mark.parametrize("cell", ["tiny.replay", "tiny.live"])
def test_traffic_driver_gives_contiguous_ts_and_every_latency(tiny_root,
                                                               cell):
    """Each driver through its function entry: every carrier's TS is one
    contiguous run of the packets sent, and every packet out in the
    window gets a latency."""
    man = harness.Manifest(tiny_root)
    session, conf, mix, driver, carriers = harness.set_up(man, cell, SEED,
                                                          "cpu")
    m0 = session.mark()
    win = driver.drive(session, mix, 4)
    m1 = session.mark()
    tx = reference.Transmitter(conf, carriers)
    outs = reference.ts_outputs(session)
    ts = reference.check_ts(tx, session, outs)
    assert ts["ts_bad_packets"] == 0
    win["feeds0"], win["feeds1"] = m0["feeds"], m1["feeds"]
    lat = reference.latencies(tx, session, outs, ts["q"], win,
                              win if "sched_t0" in win else None)
    in_window = sum(int(((o["call"] >= m0["feeds"]) &
                         (o["call"] < m1["feeds"])).sum()) for o in outs)
    assert in_window > 0 and len(lat) == in_window
    assert np.all(lat > 0)


@pytest.mark.parametrize("fault", ["control", "state_unchanged",
                                   "half_batch", "answer_altered",
                                   "llrs_altered", "starts_altered"])
def test_fault_under_the_timed_path_is_not_correct(tiny_root, fault):
    with faults.planted(fault) as prepare:
        line = harness.run_cell(tiny_root, "tiny.replay", SEED + 2, 3, False,
                                device="cpu", prepare=prepare)
    assert not line["correct"]


def test_roofline_counts_by_hand():
    # QPSK: 6 M + m (4 M + 2) = 24 + 2 * 18; 32APSK: 192 + 5 * 130
    assert demap.ops_per_symbol(2) == 60
    assert demap.ops_per_symbol(5) == 842
    # B4 (rate 1/2): 12960 info bits of degree 8, 19440 of degree 3, and
    # the accumulator's 2 * 32400 - 1 edges; B7 (3/4): 5400 of degree 12,
    # 43200 of degree 3, 2 * 16200 - 1
    assert ldpc.edges("B4") == 12960 * 8 + 19440 * 3 + 2 * 32400 - 1
    assert ldpc.edges("B7") == 5400 * 12 + 43200 * 3 + 2 * 16200 - 1

    class Ctx:
        conf = {"carriers": 8}
        block_symbols = 552960
    ops, nbytes = resample_farrow.work(Ctx)
    assert nbytes == 8 * 552960 * 28 == 123863040      # 123.9 MB
    assert ops == 8 * 552960 * 10 * 22


@pytest.mark.parametrize("trace", [False, True])
def test_run_imports_no_jax(tiny_root, trace):
    """A run, traced or not, loads no module whose top-level name is jax,
    jaxlib, flax or dvbs_tpu (dvbs_tpu_torch is the program)."""
    code = (f"import sys; sys.path[:0] = [{str(tiny_root)!r}, {str(REPO)!r}]\n"
            "from rxbench import harness\n"
            f"line = harness.run_cell({str(tiny_root)!r}, 'tiny.replay', 7, "
            f"1, {trace}, device='cpu')\n"
            "assert line is not None and line['metrics']\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tiny_root).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert "dvbs_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "dvbs_tpu"}
    assert harness.forbidden_modules() == [] or "jax" in sys.modules


def test_module_loaded_by_a_reader_refuses_the_result(tmp_path):
    """A per-layer reader is loaded after the window; where it brings a
    module of the JAX package into the process, the run gives no result."""
    import shutil
    from conftest import add_tiny_cell
    shutil.copytree(REPO / "rxbench", tmp_path / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_tiny_cell(tmp_path)
    (tmp_path / "rxbench" / "metrics" / "tiny_loads_jax_package.py").write_text(
        "import sys, types\n"
        "def read(ctx, spec):\n"
        "    sys.modules['dvbs_tpu.planted'] = types.ModuleType('planted')\n"
        "    return 1.0\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["per_layer"].append(dict(name="tiny_loads_jax_package", unit="ms",
                               better="lower", source="program_span",
                               layer="bank step", moves="rx_msamples_per_s",
                               workloads=["tiny.replay"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    try:
        line = harness.run_cell(tmp_path, "tiny.replay", SEED + 3, 1, True,
                                device="cpu")
    finally:
        sys.modules.pop("dvbs_tpu.planted", None)
    assert line is None


def test_reference_imports_nothing_of_the_program():
    """The reference, the transmitter and the work counts import nothing
    of dvbs_tpu_torch: by their sources, and in a fresh process."""
    bench = REPO / "rxbench"
    files = [bench / "reference.py", bench / "capture.py",
             *bench.glob("txref/*.py"), *bench.glob("work/*.py")]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in (
                    "dvbs_tpu_torch", "dvbs_tpu", "jax"), (f, n)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import rxbench.reference, rxbench.capture, rxbench.work.ldpc\n"
            "print('dvbs_tpu_torch' in {m.split('.')[0] for m in sys.modules})"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "False"


def test_command_refuses_without_a_card():
    """No card: exit code other than 0 and no result line (no CPU
    fallback)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "rxbench/run.py", "--workload",
                        "s2_32apsk34p_bank8.replay", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and rxbench/, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copytree(REPO / "rxbench", tmp_path / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "rxbench/run.py", "--workload",
                        "s2_32apsk34p_bank8.replay", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """On the card: the replay cell, once, correct (run on the chip)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "rxbench/run.py", "--workload",
                        "s2_32apsk34p_bank8.replay", "--seed", str(SEED),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
