"""Kernel dispatch by the tensor's device, and the kernels' launch counts.

dvbs_tpu picks its Pallas kernels by `jax.default_backend()`
(frontend.dispatch_resample, viterbi_pallas.select_decoder). The port
picks by where the data lies: a CUDA tensor goes to the hand-written
kernel and a CPU tensor to the kernel's plain PyTorch version. There is
no fallback: on a CUDA tensor a kernel that fails to build or launch
raises.
"""
from __future__ import annotations

import torch

# launches per kernel; each wrapper adds one where it launches its kernel
LAUNCHES = {"ldpc_layered": 0, "resample_farrow": 0, "viterbi_acs": 0,
            "resample_probe": 0, "soft_demap": 0}
# the shapes each kernel was launched at, recorded beside its count
# (kernel A [frames, N], kernel B [C, S], kernel C [B, T], the soft
# demapper [symbols, points]), so that a check can hold every shape a
# run launched against the plain version; reset_launches leaves them
SHAPES = {k: set() for k in LAUNCHES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def default_device() -> torch.device:
    """The device of an entry point whose caller named none: the card.
    Raises without one; the CPU is used only when asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: dvbs_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run the kernels' plain versions on the "
            "CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, None meaning default_device()."""
    return default_device() if device is None else torch.device(device)


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU
    tensor (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def host_value(cache, t: torch.Tensor, make):
    """make(t's values as a numpy array), kept in `cache` (a
    torch.utils.weak.WeakIdKeyDictionary) while t lives unchanged: what
    a kernel takes as a launch parameter is read from the device (a
    synchronisation) once per version of its tensor, not at every
    launch."""
    hit = cache.get(t)
    if hit is None or hit[0] != t._version:
        hit = (t._version, make(t.detach().cpu().numpy()))
        cache[t] = hit
    return hit[1]


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless `t` is what a kernel takes: dtype, shape, device,
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
