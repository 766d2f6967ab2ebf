"""Build the CUDA kernels with nvcc and load them with ctypes.

All of `dvbs_tpu_torch/csrc/*.cu` compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds): one
nvcc per source, all started together, then one link. The
library lands in `build/kernels/` at the root of the checkout, named by
a hash of the sources and flags, and is built at first use: a fresh
checkout builds it on its first kernel call, and an edited source
builds anew.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types; every pointer and the stream are void*
SIGNATURES = {
    "ldpc_layered_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P],
    "resample_farrow": [_P, _I, _I, _P, _I, _I, _P, _F, _F, _F, _F, _P, _P,
                        _P, _P],
    "viterbi_acs": [_P, _I, _I, _P, _P],
    "resample_probe": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "resample_probe_prep": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "resample_probe_split": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
                             _P],
    "soft_demap": [_P, _I, _I, _P, _F, _F, _F, _P, _P],
}

_lib = None
build_seconds = 0.0     # wall time of the nvcc run of this process (0: cached)
build_log = ""          # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ([os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME
                 else []) + [shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_path() -> Path:
    srcs = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libdvbs_kernels_{h.hexdigest()[:16]}.so"


def load():
    """The kernels' ctypes library, built first if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        nvcc = _nvcc()
        srcs = sorted(SRC_DIR.glob("*.cu"))
        objs = [tmp.with_name(f"{tmp.stem}.{s.stem}.o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        build_log = "".join(p.communicate()[0] for p in procs)
        link = None
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                   *[str(o) for o in objs]],
                                  capture_output=True, text=True)
            build_log += link.stdout + link.stderr
        for o in objs:
            o.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Call a C entry point and raise on the CUDA error it returns."""
    import torch
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({_error_string(err)})")


def _error_string(err: int) -> str:
    fn = load().dvbs_cuda_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return fn(err).decode()
