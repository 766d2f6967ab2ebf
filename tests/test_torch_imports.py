"""dvbs_tpu_torch and chip_smoke.py import torch and never jax.

The machine with the GPU has no JAX. A fresh interpreter imports every
module of the port, chip_smoke, and every module chip_smoke imports
inside its phases (without running them); no jax or jaxlib module may
appear. Without a CUDA device chip_smoke.py exits non-zero and prints no
result, both from a checkout and alone in an empty directory. Exact: a
set of module names, an exit code, an empty standard output.
"""
import os
import shutil
import subprocess
import sys

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
# what chip_smoke's phases import when they run
import bench
from dvbs_tpu.io import native
from dvbs_tpu.spec import dvbs_fec, ldpc_spec, modcod
from dvbs_tpu.tx import channel, dvbs_mod
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib"))
assert "torch" in sys.modules
print(len(names), "modules;", "jax modules:", bad)
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
    assert "jax modules: []" in res.stdout


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
