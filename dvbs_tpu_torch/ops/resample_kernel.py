"""Barrel+Farrow timing-recovery resampler: CUDA kernel and plain version.

Port of the resampler that dvbs_tpu reaches through
frontend.dispatch_resample: frontend.resample_windowed (XLA) and the
Pallas kernel of ops/resample_pallas.py, whose entry takes the samples
and the symbols' sample positions. So does `resample`: for CUDA tensors
csrc/resample_farrow.cu derives each 256-symbol tile's biased integer
shift `rb` and each symbol's Farrow band coordinate `u` from the
positions itself and evaluates

    out[c, k] = sum_t tap_t(u[c, k]) * y2[c, 2*TS*ti + rb - bias + 2*j + t - 4]

with ti = k // TS, j = k % TS and zeros outside the block; for CPU
tensors `shifts_and_band` computes rb and u as `_resample_batched` does
and `resample_plain` evaluates the sum.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import backend, tables

TS = tables.TILE_SYM
TAPS = tables.FARROW_TAPS
DEG = tables.FARROW_DEG


def shifts_and_band(t: torch.Tensor, farrow_band):
    """t [C, S] float32 positions -> (u [C, nt*TS] float32, rb [C, nt]
    int32, bias) as frontend.resample_windowed computes them."""
    C, S = t.shape
    nt = -(-S // TS)
    Sp = nt * TS
    bias = 1 << (tables.shift_bits_for(S) - 1)
    mid, halfr = (float(v) for v in farrow_band)
    k = torch.arange(Sp, dtype=t.dtype, device=t.device)
    tp = torch.cat([t, t[:, -1:].expand(C, Sp - S)], dim=1) if Sp != S else t
    gt = (tp - 2 * k).reshape(C, nt, TS)
    r = torch.round(0.5 * (gt[:, :, TS // 2 - 1] + gt[:, :, TS // 2])
                    ).to(torch.int32)
    rb = torch.clamp(r + bias, 0, 2 * bias - 1).to(torch.int32)
    d = gt - r[:, :, None].to(t.dtype) + 4.0
    # a divisor on the device: CUDA divides by a Python number as a
    # multiply by its reciprocal, the CPU and the kernel divide
    u = (torch.clamp(d, tables.FARROW_LO, tables.FARROW_HI) - mid) \
        / torch.full((), halfr, dtype=t.dtype, device=t.device)
    return u.reshape(C, Sp).to(torch.float32), rb, bias


def resample(y2: torch.Tensor, t: torch.Tensor, coef: torch.Tensor,
             farrow_band) -> torch.Tensor:
    """y2 [C, n2] complex64, t [C, S] float32 -> [C, S] complex64.
    coef [TAPS, DEG+1] float32 (tables.farrow_coeffs), farrow_band
    (mid, half). The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if backend.use_kernel(y2):
        return resample_cuda(y2, t, coef, farrow_band)
    return resample_plain(y2, *shifts_and_band(t, farrow_band), coef,
                          t.shape[1])


def resample_plain(y2, u, rb, bias: int, coef, S: int) -> torch.Tensor:
    """Plain PyTorch version: each tile's window of 2*TS+TAPS samples is
    read at its shift, then Horner's rule per tap and the tap sum in the
    order of frontend.resample_windowed."""
    C, n2 = y2.shape
    nt = rb.shape[1]
    dev = y2.device
    width = 2 * TS + TAPS
    start = (2 * TS * torch.arange(nt, device=dev))[None, :] \
        + (rb.to(torch.int64) - bias) - 4                   # [C, nt]
    idx = start[:, :, None] + torch.arange(width, device=dev)
    inside = (idx >= 0) & (idx < n2)
    rows = torch.gather(y2, 1, idx.clamp(0, n2 - 1).reshape(C, -1)
                        ).reshape(C, nt, width)
    rows = torch.where(inside, rows, torch.zeros((), dtype=rows.dtype,
                                                 device=dev))
    rows_e, rows_o = rows[:, :, 0::2], rows[:, :, 1::2]
    uu = u.reshape(C, nt, TS)
    out = torch.zeros((C, nt, TS), dtype=y2.dtype, device=dev)
    for ci in range(TAPS):
        tap = coef[ci, 0].expand_as(uu)
        for dg in range(1, DEG + 1):
            tap = tap * uu + coef[ci, dg]
        plane = rows_e if ci % 2 == 0 else rows_o
        out = out + tap * plane[:, :, ci // 2:ci // 2 + TS]
    return out.reshape(C, nt * TS)[:, :S]


# coef tensor -> (its version, its values on the host): the kernel takes
# the coefficients as a launch parameter (backend.host_value)
_HOST_COEF = WeakIdKeyDictionary()


def resample_cuda(y2, t, coef, farrow_band, band_out=None) -> torch.Tensor:
    """Launch csrc/resample_farrow.cu (kernel B's port): y2 [C, n2]
    complex64, t [C, S] float32 -> [C, S] complex64. band_out, a pair
    (u [C, nt*TS] float32, rb [C, nt] int32), also receives the shifts
    and band coordinates the kernel derived (for the checks on the card
    against shifts_and_band)."""
    from ..kernels import build
    C, n2 = y2.shape
    S = t.shape[1]
    nt = -(-S // TS)
    dev = y2.device
    backend.check(y2, "y2", torch.complex64, (C, n2), dev)
    backend.check(t, "t", torch.float32, (C, S), dev)
    backend.check(coef, "coef", torch.float32, (TAPS, DEG + 1), dev)
    if 2 * nt * TS > 1 << 24:
        raise ValueError(f"{S} symbols: 2k is not exact in float32 past "
                         f"2^23 symbols")
    band_ptrs = (None, None)
    if band_out is not None:
        u, rb = band_out
        backend.check(u, "u", torch.float32, (C, nt * TS), dev)
        backend.check(rb, "rb", torch.int32, (C, nt), dev)
        band_ptrs = (u.data_ptr(), rb.data_ptr())
    mid, halfr = (float(v) for v in farrow_band)
    bias = 1 << (tables.shift_bits_for(S) - 1)
    coef_host = backend.host_value(_HOST_COEF, coef, lambda c: (
        np.ascontiguousarray(c, dtype=np.float32)))
    out = torch.empty((C, S), dtype=torch.complex64, device=dev)
    build.launch("resample_farrow", y2.data_ptr(), C, n2, t.data_ptr(), S,
                 bias, coef_host.ctypes.data, tables.FARROW_LO,
                 tables.FARROW_HI, mid, halfr, out.data_ptr(), *band_ptrs)
    backend.LAUNCHES["resample_farrow"] += 1
    backend.SHAPES["resample_farrow"].add((C, S))
    return out
