"""dvbs_tpu_torch and chip_smoke.py import torch, never jax, and nothing
of dvbs_tpu; they run on the card unless asked for the CPU.

The machine with the GPU has no JAX. A fresh interpreter imports every
module of the port and chip_smoke; no dvbs_tpu, jax or jaxlib module may
appear, and no source of the port or of chip_smoke names one in an
import. Without a CUDA device chip_smoke.py exits non-zero and prints no
result, both from a checkout and alone in an empty directory, and every
entry point of the port raises RuntimeError when no device is named and
works with device="cpu". Exact: a set of module names, an exit code, an
empty standard output, an exception type.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
before = set(sys.modules)
import dvbs_tpu_torch
names = ["dvbs_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    dvbs_tpu_torch.__path__, "dvbs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
new = set(sys.modules) - before
bad = sorted(m for m in new
             if m.split(".")[0] in ("jax", "jaxlib", "dvbs_tpu", "bench"))
assert "torch" in sys.modules
assert len(names) > 40, names
for m in ("ops.equalizer", "parallel.collectives", "parallel.timeshard",
          "parallel.mesh", "entry"):
    assert "dvbs_tpu_torch." + m in names, m
print(len(names), "modules;", "foreign modules:", bad)
sys.exit(1 if bad else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_and_chip_smoke_import_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "foreign modules: []" in res.stdout


def test_no_source_imports_the_jax_package():
    """Lazy imports too: no import statement in the port or chip_smoke
    names jax, jaxlib, bench or dvbs_tpu."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|bench|dvbs_tpu)\b",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dvbs_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for f in files:
        with open(f) as fh:
            hit = pat.search(fh.read())
        assert hit is None, (f, hit.group(0))


def _entry_points():
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    from dvbs_tpu_torch.models.driver import DVBS2Stream
    from dvbs_tpu_torch.models.dvbs import DVBSReceiver, DVBSStream
    from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver
    from dvbs_tpu_torch.ops import viterbi
    from dvbs_tpu_torch.ops.resample import Channelizer, StreamingResampler
    from dvbs_tpu_torch.parallel.dvbs_bank import (DVBSBankStream,
                                                   build_dvbs_bank,
                                                   build_dvbs_stream_bank)
    from dvbs_tpu_torch.parallel.mesh import build_carrier_bank
    s2 = dict(mc=4, short=True, block_symbols=1 << 15)
    return {
        "DVBS2Receiver": lambda **kw: DVBS2Receiver(**s2, **kw),
        "DVBS2Stream": lambda **kw: DVBS2Stream(**s2, **kw),
        "DVBS2BankStream": lambda **kw: DVBS2BankStream(2, **s2, **kw),
        "build_carrier_bank": lambda **kw: build_carrier_bank(2, **s2, **kw),
        "DVBSReceiver": lambda **kw: DVBSReceiver(rate="1/2", **kw),
        "DVBSStream": lambda **kw: DVBSStream(**kw),
        "build_dvbs_bank": lambda **kw: build_dvbs_bank(
            2, rate="1/2", block_samples=1 << 14, **kw),
        "build_dvbs_stream_bank": lambda **kw: build_dvbs_stream_bank(
            2, rate="1/2", block_samples=1 << 14, **kw),
        "DVBSBankStream": lambda **kw: DVBSBankStream(
            2, rate="1/2", block_samples=1 << 14, **kw),
        "StreamingResampler": lambda **kw: StreamingResampler(4e6, 1e6, **kw),
        "Channelizer": lambda **kw: Channelizer(4e6, [(0.0, 1e6)], **kw),
        "viterbi.decode_stream": lambda **kw: viterbi.decode_stream(
            np.ones((64, 2), np.float32), core=64, wing=8, **kw),
    }


@pytest.mark.parametrize("name", [
    "DVBS2Receiver", "DVBS2Stream", "DVBS2BankStream", "build_carrier_bank",
    "DVBSReceiver", "DVBSStream", "build_dvbs_bank",
    "build_dvbs_stream_bank", "DVBSBankStream",
    "StreamingResampler", "Channelizer", "viterbi.decode_stream"])
def test_entry_point_device(name, monkeypatch):
    """No device named: the card, and RuntimeError when there is none
    (never the CPU). device="cpu": built on the CPU."""
    from dvbs_tpu_torch import backend
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(device=None)
    assert make(device="cpu") is not None


def _sharded_entry_points():
    from dvbs_tpu_torch import entry
    from dvbs_tpu_torch.parallel import mesh, timeshard
    s2 = dict(mc=4, short=True, block_symbols=1 << 15)
    return {
        "build_multi_carrier": lambda **kw: mesh.build_multi_carrier(
            1, **s2, **kw),
        "build_carrier_bank_sharded":
            lambda **kw: mesh.build_carrier_bank_sharded(1, **s2, **kw),
        "build_time_sharded": lambda **kw: timeshard.build_time_sharded(
            1, **s2, **kw),
        "build_grid_sharded": lambda **kw: timeshard.build_grid_sharded(
            1, 1, **s2, **kw),
        "entry": lambda **kw: entry.entry(**kw),
    }


@pytest.mark.parametrize("name", [
    "build_multi_carrier", "build_carrier_bank_sharded",
    "build_time_sharded", "build_grid_sharded", "entry"])
def test_sharded_entry_point_device(name, monkeypatch, tmp_path):
    """The sharded builds and entry(): no device named and no card
    raises RuntimeError; device="cpu" builds on a gloo rank."""
    from dvbs_tpu_torch.parallel import collectives
    make = _sharded_entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(device=None)
    collectives.init_mesh(1, 0, "cpu", str(tmp_path / "store"))
    try:
        assert make(device="cpu") is not None
    finally:
        collectives.close_mesh()


def test_cli_device(tmp_path, monkeypatch):
    """The CLI's --device defaults to the card too."""
    from dvbs_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    iq = tmp_path / "x.cf32"
    iq.write_bytes(b"\0" * 8000)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--iq", str(iq), "--modcod", "4", "--framesize", "short"])
    assert cli.main(["--iq", str(iq), "--modcod", "4", "--framesize",
                     "short", "--block-symbols", "32768", "--device",
                     "cpu"]) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--iq", str(iq), "--mode", "s"])
    assert cli.main(["--iq", str(iq), "--mode", "s", "--device", "cpu"]) == 0


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), cwd)
        env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
