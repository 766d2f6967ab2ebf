"""Per-frame carrier recovery on the pilots-off QPSK path.

PyTorch port of the parts of dvbs_tpu/ops/plphase.py that the pilots-off
QPSK receiver runs: the block-common lag-2 FED and Luise-Reggiannini
frequency estimates over the known header symbols, the header LS phase,
and the two-stage 4th-power Viterbi&Viterbi phase track. Frames carry
leading batch dimensions [..., F, L]; the block-common estimates average
over the frame axis (-2) only.
"""
from __future__ import annotations

import math

import torch


def _polar1(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def _known_header(frames: torch.Tensor, hdr: torch.Tensor) -> torch.Tensor:
    return frames[..., :90] * torch.conj(hdr)


def coarse_fed_common(frames: torch.Tensor, hdr: torch.Tensor
                      ) -> torch.Tensor:
    """Block-common lag-2 frequency estimate, rad/symbol, over the
    header symbols (the JAX version with pilots=False, robust=False).
    frames [..., F, L], hdr [90] the configured PLHEADER symbols
    -> [...]."""
    h = _known_header(frames, hdr)
    acc_f = torch.sum(h[..., 2:] * torch.conj(h[..., :-2]), dim=-1)
    return torch.angle(torch.sum(acc_f, dim=-1)) / 2.0


def lr_freq_common(frames: torch.Tensor, hdr: torch.Tensor, M: int = 8
                   ) -> torch.Tensor:
    """Block-common Luise-Reggiannini estimate over the header symbols
    of every frame (pilots=False, robust=False): angle(sum_m R_m) /
    ((M+1)/2). -> [...]."""
    h = _known_header(frames, hdr)
    acc_f = torch.zeros(h.shape[:-1], dtype=torch.complex64, device=h.device)
    for m in range(1, M + 1):
        acc_f = acc_f + torch.sum(h[..., m:] * torch.conj(h[..., :-m]), dim=-1)
    return torch.angle(torch.sum(acc_f, dim=-1)) / ((M + 1) / 2.0)


def apply_freq(frames: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """Remove a per-frame frequency (rad/symbol), phase-centred on symbol
    0. frames [..., F, L], freq [..., F]."""
    n = torch.arange(frames.shape[-1], dtype=torch.int32,
                     device=frames.device)
    return frames * _polar1(-(freq[..., None] * n))


def header_phase(frames: torch.Tensor, hdr: torch.Tensor) -> torch.Tensor:
    """LS phase over the 90 known header symbols. -> [..., F]."""
    return torch.angle(torch.sum(_known_header(frames, hdr), dim=-1))


def derotate(x: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    return x * _polar1(-phase)


def _vv_group_phases(payload: torch.Tensor, theta0: torch.Tensor,
                     group: int):
    """Unwrapped 4th-power phase per group [..., G], and group centers."""
    P = payload.shape[-1]
    G = P // group
    z = payload[..., :G * group].reshape(*payload.shape[:-1], G, group)
    z2 = z * z
    z4 = torch.sum(z2 * z2, dim=-1)        # integer power as XLA: (z^2)^2
    raw = (torch.angle(z4) - math.pi) / 4.0
    half = math.pi / 2
    d = raw[..., 1:] - raw[..., :-1]
    d = d - torch.round(d / half) * half
    base = raw[..., 0] + torch.round((theta0 - raw[..., 0]) / half) * half
    phases = base[..., None] + torch.cat(
        [torch.zeros_like(raw[..., :1]), torch.cumsum(d, dim=-1)], dim=-1)
    centers = (torch.arange(G, device=payload.device, dtype=torch.float32)
               + 0.5) * group
    return phases, centers


def _interp_phases(phases: torch.Tensor, group: int, P: int) -> torch.Tensor:
    """Piecewise-linear interpolation of per-group phases [..., G]
    (centers at (i+0.5)*group) onto [..., P], edge-clamped."""
    G = phases.shape[-1]
    lead = phases.shape[:-1]
    h = group // 2
    d = phases[..., 1:] - phases[..., :-1]
    frac = torch.arange(group, device=phases.device,
                        dtype=torch.float32) / group
    body = (phases[..., :-1, None] + d[..., None] * frac).reshape(*lead, -1)
    head = phases[..., :1].expand(*lead, h)
    tail = phases[..., -1:].expand(*lead, P - h - (G - 1) * group)
    return torch.cat([head, body, tail], dim=-1)


def qpsk_vv_track(payload: torch.Tensor, theta0: torch.Tensor
                  ) -> torch.Tensor:
    """Two-stage slip-resistant V&V for pilotless QPSK: 90-symbol groups
    and a per-frame line fit remove the residual carrier, then
    720-symbol groups track the phase. payload [..., P], theta0 [...]
    -> per-symbol phase [..., P]."""
    P = payload.shape[-1]
    ph1, c1 = _vv_group_phases(payload, theta0, 90)
    c = c1 - torch.mean(c1)
    denom = torch.sum(c * c)
    slope = torch.sum(c * (ph1 - torch.mean(ph1, -1, keepdim=True)),
                      dim=-1) / denom
    mean1 = torch.mean(ph1, dim=-1)
    ar = torch.arange(P, device=payload.device, dtype=torch.float32)
    ramp = mean1[..., None] + slope[..., None] * (ar - torch.mean(c1))
    flat = payload * _polar1(-ramp)
    ph2, _ = _vv_group_phases(flat, torch.zeros_like(theta0), 720)
    return ramp + _interp_phases(ph2, 720, P)
