"""Soft demapper: exact LLRs over subsets of the constellation.

PyTorch port of dvbs_tpu/ops/demap.py: per-bit log-ratio of summed
exp(-distance/npwr) over the points whose bit is 0 and 1, with the
reference's per-constellation scales (tables.DEMAP_SCALES) and its int8
clamp by repeated halving. Positive = bit 0.

`soft_demap` launches csrc/soft_demap.cu for CUDA tensors (a thread a
symbol: the distances, both subsets' log-sum-exps, the scale and the
clamp in one pass) and runs the plain version for CPU tensors. The
kernel takes the constellation from the points' count (M = 4, 8, 16,
32) and the standard bit pattern, which `kernel_params` checks once per
table on the host.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import backend, tables

KERNEL_POINTS = (4, 8, 16, 32)


def _clamp_halving(x: torch.Tensor) -> torch.Tensor:
    """Halve until |x| <= 127 (constellation.cpp:263-270)."""
    mag = torch.abs(x)
    k = torch.ceil(torch.log2(torch.clamp(mag / 127.0, min=1.0)))
    return x * torch.exp2(-k)


def soft_demap(syms: torch.Tensor, kind: str, pts: torch.Tensor,
               mask0: torch.Tensor, npwr: float = 1.0) -> torch.Tensor:
    """syms [...] complex -> LLRs [..., m] float32. pts [S] complex64
    and mask0 [m, S] bool from tables.demap_tables(kind, g1, g2). The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if backend.use_kernel(syms):
        return soft_demap_cuda(syms, kind, pts, mask0, npwr)
    return soft_demap_plain(syms, kind, pts, mask0, npwr)


def llrs_unclamped(syms: torch.Tensor, kind: str, pts: torch.Tensor,
                   mask0: torch.Tensor, npwr: float = 1.0) -> torch.Tensor:
    """The plain version's LLRs [..., m] before the halving clamp."""
    ss, ps, sca = tables.DEMAP_SCALES[kind]
    x = syms[..., None] * ss
    d = torch.abs(x - pts * ps)                       # [..., S]
    neg = -d / npwr
    ninf = torch.full((), float("-inf"), device=syms.device)

    def lse(mask):
        z = torch.where(mask, neg[..., None, :], ninf)    # [..., m, S]
        zmax = torch.amax(z, dim=-1, keepdim=True)
        return torch.log(torch.sum(torch.exp(z - zmax), dim=-1)) + zmax[..., 0]
    return (lse(mask0) - lse(~mask0)) * sca


def soft_demap_plain(syms: torch.Tensor, kind: str, pts: torch.Tensor,
                     mask0: torch.Tensor, npwr: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: [..., m, S] masked log-sum-exps."""
    return _clamp_halving(llrs_unclamped(syms, kind, pts, mask0, npwr)
                          ).to(torch.float32)


def against_plain(got: torch.Tensor, syms: torch.Tensor, kind: str,
                  pts: torch.Tensor, mask0: torch.Tensor,
                  npwr: float = 1.0) -> tuple[float, float, int]:
    """How far LLRs `got` [..., m] lie from the plain version's on the
    same inputs: (the largest error as a share of its tolerance, the
    largest abs error away from a halving step, the count of LLRs at
    one). An LLR's tolerance is 1e-5 x sca x (1 + ss |x| + ps max|p|) /
    npwr: the largest |z| its log-sum-exps meet, times the LLR scale,
    so a few float32 ulps of the plain version's terms, taken in another
    order. Where the plain version's LLR before the clamp lies within
    that of 127 x 2^j, one halving more or fewer is also accepted."""
    ss, ps, sca = tables.DEMAP_SCALES[kind]
    raw = llrs_unclamped(syms, kind, pts, mask0, npwr)
    ref = _clamp_halving(raw).to(torch.float32)
    tol = (1e-5 * sca / npwr * (1 + ss * syms.abs() +
                                ps * float(pts.abs().max())))[..., None]
    err = (got - ref).abs()
    mag = raw.abs()
    step = 127 * torch.exp2(torch.clamp(torch.round(torch.log2(mag / 127)),
                                        min=0))
    near = (mag - step).abs() <= tol
    other = torch.minimum((2 * got - ref).abs(), (got - 2 * ref).abs() / 2)
    share = torch.where(near, torch.minimum(err, other), err) / tol
    if not got.numel():
        return 0.0, 0.0, 0
    return (float(share.max()), float(torch.where(near, 0.0, err).max()),
            int(near.sum()))


def _check_mask0(mask0: np.ndarray) -> bool:
    M = mask0.shape[-1] if mask0.ndim == 2 else -1
    if M not in KERNEL_POINTS:
        raise ValueError(f"soft_demap kernel: mask0 of shape "
                         f"{tuple(mask0.shape)}; it takes [log2 M, M] "
                         f"with M in {KERNEL_POINTS}")
    if not np.array_equal(mask0, tables.demap_mask0(M)):
        raise ValueError("soft_demap kernel: mask0 is not the standard "
                         "bit pattern (s >> (m-1-k)) & 1 == 0 that the "
                         "kernel computes")
    return True


# pts / mask0 tensor -> (its version, what the kernel takes from it):
# the kernel takes the points as a launch parameter (backend.host_value)
_HOST = WeakIdKeyDictionary()


def kernel_params(kind: str, pts: torch.Tensor, mask0: torch.Tensor):
    """(points [2M] float32, ss, sca) as the kernel takes them: the
    points scaled by ps on the host, interleaved re, im. Raises unless
    mask0 is tables.demap_mask0(M) for M = pts.shape[0] in
    KERNEL_POINTS. Runs on the host for tensors of any device."""
    ss, ps, sca = tables.DEMAP_SCALES[kind]
    backend.host_value(_HOST, mask0, _check_mask0)
    if pts.dtype != torch.complex64 or tuple(pts.shape) != \
            (mask0.shape[-1],):
        raise ValueError(f"soft_demap kernel: pts {pts.dtype} "
                         f"{tuple(pts.shape)}, expected complex64 "
                         f"[{mask0.shape[-1]}]")
    scaled = backend.host_value(_HOST, pts, lambda p: (
        np.ascontiguousarray(p.view(np.float32) * np.float32(ps))))
    return scaled, float(ss), float(sca)


def soft_demap_cuda(syms: torch.Tensor, kind: str, pts: torch.Tensor,
                    mask0: torch.Tensor, npwr: float = 1.0) -> torch.Tensor:
    """Launch csrc/soft_demap.cu: syms [...] complex64 -> [..., m]
    float32, a thread a symbol."""
    from ..kernels import build
    scaled, ss, sca = kernel_params(kind, pts, mask0)
    M = scaled.size // 2
    m = M.bit_length() - 1
    x = syms.contiguous()
    backend.check(x, "syms", torch.complex64, tuple(syms.shape), syms.device)
    n = x.numel()
    if n * m >= 1 << 31:
        raise ValueError(f"soft_demap kernel: {n} symbols x {m} LLRs "
                         f"exceed 32-bit indexing")
    out = torch.empty((*syms.shape, m), dtype=torch.float32,
                      device=syms.device)
    if n:
        build.launch("soft_demap", x.data_ptr(), n, M, scaled.ctypes.data,
                     ss, sca, 1.0 / npwr, out.data_ptr())
        backend.LAUNCHES["soft_demap"] += 1
        backend.SHAPES["soft_demap"].add((n, M))
    return out
