"""Sample-domain front end: AGC, mixer, matched filter, timing recovery.

PyTorch port of dvbs_tpu/ops/frontend.py. Every function takes a leading
carrier dimension [C, ...] where the JAX version was vmapped. The two
banded-matrix FIRs round their inputs to bf16 and multiply in float32
(the JAX version's bf16 matmul with float32 accumulation); the caller
keeps TF32 off so the product really is float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import tables
from . import resample_kernel


def agc(x: torch.Tensor) -> torch.Tensor:
    """Normalize each carrier's block to unit average power. x [C, n]."""
    p = torch.mean(torch.abs(x) ** 2, dim=-1, keepdim=True)
    return x * torch.rsqrt(p + 1e-12)


def pack_cs4(samples: np.ndarray, scale: float = 2.5) -> np.ndarray:
    """Host-side: complex baseband -> packed 4-bit IQ, 1 byte per sample
    (I in the high nibble, Q in the low; frontend.pack_cs4)."""
    s = np.asarray(samples)
    rms = np.sqrt(np.mean(np.abs(s) ** 2)) + 1e-30
    q = np.clip(np.round(np.stack([s.real, s.imag]) * (scale / rms)),
                -7, 7).astype(np.int64)
    return (((q[0] & 15) << 4) | (q[1] & 15)).astype(np.uint8)


def unpack_cs4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> int8 [..., 2, n] (sign-extended nibbles)."""
    hi = ((packed >> 4) ^ 8).to(torch.int8) - 8
    lo = ((packed & 15) ^ 8).to(torch.int8) - 8
    return torch.stack([hi, lo], dim=-2)


def pack_bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """MSB-first bit packing: [..., 8k] {0,1} -> [..., k] uint8."""
    # [128, 64, ..., 1] made on the device: no host-to-device copy
    w = torch.exp2(torch.arange(7, -1, -1, dtype=torch.float32,
                                device=bits.device))
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    return (b.to(torch.float32) @ w).to(torch.uint8)


def coarse_cfo_estimate(x: torch.Tensor) -> torch.Tensor:
    """CFO in rad/sample from the lag-1 autocorrelation. x [C, n] -> [C]."""
    r = torch.sum(x[..., 1:] * torch.conj(x[..., :-1]), dim=-1)
    return torch.angle(r)


def qpsk_residual_freq(z: torch.Tensor) -> torch.Tensor:
    """Residual carrier frequency of QPSK symbols, rad/symbol, from the
    4th-power spectral line: FFT peak, parabolic refinement, signed
    wrap. z [C, S] -> [C]. z**4 is taken as (z*z)*(z*z), XLA's
    integer_pow."""
    n = z.shape[-1]
    z2 = z * z
    spec = torch.abs(torch.fft.fft(z2 * z2))
    k = torch.argmax(spec, dim=-1, keepdim=True)
    a = torch.gather(spec, -1, (k - 1) % n)
    b = torch.gather(spec, -1, k)
    c = torch.gather(spec, -1, (k + 1) % n)
    delta = 0.5 * (a - c) / (a - 2 * b + c + 1e-12)
    kf = k.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)
    kf = torch.where(kf > n / 2, kf - n, kf)
    return ((2 * math.pi * kf / n) / 4.0)[..., 0]


def mix(x: torch.Tensor, freq: torch.Tensor,
        phase: torch.Tensor | None = None) -> torch.Tensor:
    """Multiply by exp(-j (freq n + phase)); freq, phase [C] rad/sample
    and rad. The argument is freq*n + phase in float32, in that order,
    as the JAX version computes it: at n ~ 5e5 its rounding is part of
    the result."""
    n = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    arg = freq[..., None].to(torch.float32) * n
    if phase is not None:
        arg = arg + phase[..., None].to(torch.float32)
    return x * torch.polar(torch.ones_like(arg), -arg)


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """Round float32 values to the nearest bf16, kept as float32."""
    return a.to(torch.bfloat16).to(torch.float32)


def fir_filter(x: torch.Tensor, taps: torch.Tensor,
               T: torch.Tensor | None = None) -> torch.Tensor:
    """Centered FIR ('same' length), complex x [C, n], real taps [K].

    With T (the taps' banded matrix [FIR_BLK+K-1, FIR_BLK], bf16-exact
    values) and a long enough block this is the JAX version's MXU form:
    overlapping windows times T, inputs rounded to bf16, products summed
    in float32. Otherwise K shifted multiply-adds."""
    K = taps.shape[0]
    C, n = x.shape
    half = K // 2
    blk = tables.FIR_BLK
    if T is not None and K >= 16 and n >= 4 * blk and K - 1 <= blk:
        nb = -(-n // blk)
        pad = (half, (nb + 1) * blk - n - half)
        parts = []
        for p in (x.real, x.imag):
            a = torch.nn.functional.pad(p, pad).reshape(C, nb + 1, blk)
            w = torch.cat([a[:, :-1], a[:, 1:]], dim=2)[:, :, :blk + K - 1]
            parts.append(bf16_round(w))
        y = torch.cat(parts, dim=1) @ T          # [C, 2nb, blk]
        re = y[:, :nb].reshape(C, nb * blk)[:, :n]
        im = y[:, nb:].reshape(C, nb * blk)[:, :n]
        return torch.complex(re, im)
    xp = torch.nn.functional.pad(torch.view_as_real(x),
                                 (0, 0, half, K - 1 - half))
    xp = torch.view_as_complex(xp.contiguous())
    acc = torch.zeros_like(x)
    for j, h in enumerate(taps.tolist()):
        if h != 0.0:
            acc = acc + h * xp[:, j:j + n]
    return acc


def matched_filter(x: torch.Tensor, rrc_taps: torch.Tensor,
                   fir_rrc: torch.Tensor | None) -> torch.Tensor:
    """The 65-tap RRC matched filter (tables.rrc_taps and its banded
    matrix, frontend.matched_filter's defaults)."""
    return fir_filter(x, rrc_taps, fir_rrc)


def _oerder_meyr_terms(y2: torch.Tensor, mid_taps: torch.Tensor,
                       fir_mid: torch.Tensor | None) -> torch.Tensor:
    """Per-sample complex contributions to the Oerder-Meyr tone."""
    v = fir_filter(y2, mid_taps, fir_mid)
    m = torch.arange(y2.shape[-1], device=y2.device)
    sgn = 1.0 - 2.0 * (m % 2).to(torch.float32)
    return sgn * torch.complex(torch.abs(y2) ** 2, -(torch.abs(v) ** 2))


def recover_symbols_full(y2: torch.Tensor, mid_taps: torch.Tensor,
                         fir_mid: torch.Tensor | None,
                         farrow_coef: torch.Tensor, farrow_band,
                         n_windows: int = 8,
                         tau_hint: torch.Tensor | None = None,
                         tau_eval: int | None = None):
    """Block feed-forward timing recovery at 2 sps, per carrier.

    y2 [C, n2]. Returns (symbols [C, n2//2], tau_u [C, n_windows],
    tau_end [C]) as frontend.recover_symbols_full: per-window Oerder-Meyr
    tau, unwrap, line fit (piecewise-linear when the fit residual says
    the path has a step), then the barrel+Farrow resampler."""
    C, n2 = y2.shape
    dev = y2.device
    win = (n2 // n_windows) & ~1
    terms = _oerder_meyr_terms(y2, mid_taps, fir_mid)
    sums = terms[:, :n_windows * win].reshape(C, n_windows, win).sum(-1)
    taus = torch.angle(sums) / (2 * math.pi)
    d = torch.diff(taus, dim=-1)
    d = d - torch.round(d)
    tau_u = taus[:, :1] + torch.cat(
        [torch.zeros_like(taus[:, :1]), torch.cumsum(d, dim=-1)], dim=-1)
    if tau_hint is not None:
        k = torch.where(torch.isnan(tau_hint), torch.zeros_like(tau_hint),
                        torch.round(tau_hint - tau_u[:, 0]))
        tau_u = tau_u + k[:, None]
    centers = (torch.arange(n_windows, device=dev, dtype=torch.float32)
               + 0.5) * win
    c0 = torch.mean(centers)
    scale = centers[-1] - centers[0] + 1e-9
    u = (centers - c0) / scale
    mean_tau = torch.mean(tau_u, dim=-1, keepdim=True)
    slope = torch.sum(u * (tau_u - mean_tau), dim=-1, keepdim=True) \
        / torch.sum(u * u)
    S_out = n2 // 2
    k = torch.arange(S_out, device=dev, dtype=torch.int32)
    n_nom = 2.0 * k.to(torch.float32)
    tau_line = mean_tau + slope * (n_nom - c0) / scale
    resid = tau_u - (mean_tau + slope * u)
    use_pw = torch.amax(torch.abs(resid), dim=-1, keepdim=True) > 0.07
    dt = tau_u[:, 1:] - tau_u[:, :-1]
    seg = win // 2
    pw_ok = win % 4 == 0 and seg * (n_windows - 1) + 2 * (seg // 2) == S_out
    if pw_ok:
        frac = torch.arange(seg, device=dev, dtype=torch.float32) / seg
        body = (tau_u[:, :-1, None] + dt[:, :, None] * frac).reshape(C, -1)
        h = seg // 2
        ar = torch.arange(h, device=dev, dtype=torch.float32)
        head = tau_u[:, :1] + dt[:, :1] * (ar - h) / seg
        tail = tau_u[:, -1:] + dt[:, -1:] * ar / seg
        tau_pw_n = torch.cat([head, body, tail], dim=-1)
        tau_n = torch.where(use_pw, tau_pw_n, tau_line)
    else:
        tau_n = tau_line
    t = torch.clamp(n_nom - 2.0 * tau_n, 0.0, n2 - 1.0)
    pos = n2 if tau_eval is None else tau_eval
    tau_end = mean_tau + slope * (pos - c0) / scale
    if pw_ok:
        tau_end_pw = tau_u[:, -1:] + dt[:, -1:] * (pos - centers[-1]) / win
        tau_end = torch.where(use_pw, tau_end_pw, tau_end)
    z = resample_kernel.resample(y2, t, farrow_coef, farrow_band)
    return z, tau_u, tau_end[:, 0]


def recover_symbols(y2: torch.Tensor, mid_taps: torch.Tensor,
                    fir_mid: torch.Tensor | None, farrow_coef: torch.Tensor,
                    farrow_band, n_windows: int = 8,
                    tau_hint: torch.Tensor | None = None):
    """recover_symbols_full without the extrapolated tau: (symbols
    [C, n2//2], tau_u [C, n_windows])."""
    z, tau_u, _ = recover_symbols_full(y2, mid_taps, fir_mid, farrow_coef,
                                       farrow_band, n_windows, tau_hint)
    return z, tau_u
