"""Per-frame carrier recovery: block-common frequency, anchored phase.

PyTorch port of dvbs_tpu/ops/plphase.py: the block-common lag-2 FED and
Luise-Reggiannini frequency estimates over the known symbols (the
header, and the descrambled pilot blocks when present), each with its
coherence-gated `robust` form for blocks that hold dummy PLFRAMEs, the
header LS phase, the pilot-anchor phase track with its extrapolated
tail, payload extraction, the two-stage 4th-power Viterbi&Viterbi track
of pilotless QPSK, and the chained decision-directed track of pilotless
8PSK, 16APSK and 32APSK. Frames carry leading batch dimensions
[..., F, L]; the block-common estimates average over the frame axis
(-2) only.

`pilots` arguments are None (no pilots) or (pstarts, pdescr): the pilot
block starts (tables.pilot_starts, a uniform grid) and their descramble
phasors times conj of the pilot symbol [n_p, 36]
(tables.pilot_descramble_phasors).
"""
from __future__ import annotations

import math

import torch


def _polar1(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def _known_header(frames: torch.Tensor, hdr: torch.Tensor) -> torch.Tensor:
    return frames[..., :90] * torch.conj(hdr)


def _pilot_grid(pstarts) -> tuple[int, int]:
    """(first start, spacing) of the uniform pilot grid."""
    p0 = int(pstarts[0])
    step = int(pstarts[1]) - p0 if len(pstarts) > 1 else 1476
    assert all(int(p) == p0 + k * step for k, p in enumerate(pstarts)), \
        "non-uniform pilots"
    return p0, step


def pilot_blocks(frames: torch.Tensor, pilots) -> torch.Tensor:
    """Every pilot block of frames [..., L], descrambled and divided by
    the pilot symbol, in one strided window: [..., n_p, 36]."""
    pstarts, pdescr = pilots
    p0, step = _pilot_grid(pstarts)
    span = (len(pstarts) - 1) * step + 36
    return frames[..., p0:p0 + span].unfold(-1, 36, step) * pdescr


def _lag_sum(seg: torch.Tensor, m: int, dims) -> torch.Tensor:
    return torch.sum(seg[..., m:] * torch.conj(seg[..., :-m]), dim=dims)


def _gated_angle(acc_f: torch.Tensor, nprod: float, scale: float
                 ) -> torch.Tensor:
    """angle(sum of the coherent frames' accumulators) / scale. A frame
    whose header is not the configured one (a dummy PLFRAME) sums its
    lag products incoherently, |acc| ~ sqrt(n) instead of ~n, and is
    left out; a block with no coherent frame estimates 0."""
    w = (torch.abs(acc_f) > 0.35 * nprod).to(acc_f.dtype)
    acc = torch.sum(acc_f * w, dim=-1)
    return torch.where(torch.abs(acc) > 0, torch.angle(acc) / scale,
                       torch.zeros_like(acc.real))


def coarse_fed_common(frames: torch.Tensor, hdr: torch.Tensor,
                      pilots=None, robust: bool = False) -> torch.Tensor:
    """Block-common lag-2 frequency estimate, rad/symbol, over the
    header symbols and each pilot block as its own segment. frames
    [..., F, L], hdr [90] the configured PLHEADER symbols -> [...].
    robust gates each frame on its own coherence (_gated_angle)."""
    acc_f = _lag_sum(_known_header(frames, hdr), 2, -1)
    nprod = 88.0
    if pilots is not None:
        acc_f = acc_f + _lag_sum(pilot_blocks(frames, pilots), 2, (-2, -1))
        nprod += 34.0 * len(pilots[0])
    if robust:
        return _gated_angle(acc_f, nprod, 2.0)
    return torch.angle(torch.sum(acc_f, dim=-1)) / 2.0


def lr_freq_common(frames: torch.Tensor, hdr: torch.Tensor, pilots=None,
                   M: int = 8, robust: bool = False) -> torch.Tensor:
    """Block-common Luise-Reggiannini estimate over the known symbols of
    every frame: lags 1..M within the header and within each pilot
    block, never across a block boundary; angle(sum_m R_m) / ((M+1)/2).
    -> [...]. robust as in coarse_fed_common."""
    h = _known_header(frames, hdr)
    blks = pilot_blocks(frames, pilots) if pilots is not None else None
    acc_f = torch.zeros(h.shape[:-1], dtype=torch.complex64, device=h.device)
    nprod = 0.0
    for m in range(1, M + 1):
        acc_f = acc_f + _lag_sum(h, m, -1)
        nprod += 90 - m
        if blks is not None:
            acc_f = acc_f + _lag_sum(blks, m, (-2, -1))
            nprod += (36 - m) * len(pilots[0])
    if robust:
        return _gated_angle(acc_f, nprod, (M + 1) / 2.0)
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


def _dd_track_once(payload: torch.Tensor, theta0: torch.Tensor,
                   pts: torch.Tensor, group: int, n_iter: int
                   ) -> torch.Tensor:
    """One chained decision-directed pass: phase [..., P]. Each group
    starts from the previous group's estimate, so the loop over the
    G = P // group groups is sequential; every step is batched over the
    leading dimensions and nothing in it waits for the host."""
    P = payload.shape[-1]
    G = P // group
    z = payload[..., :G * group].reshape(*payload.shape[:-1], G, group)
    cpts = torch.conj(pts)
    ph = theta0.to(torch.float32)
    phases = []
    for g in range(G):
        zg = z[..., g, :]
        for _ in range(n_iter):
            zc = zg * _polar1(-ph)[..., None]
            # nearest point; argmin keeps the first of equal distances
            k = torch.argmin(torch.abs(zc[..., None] - pts), dim=-1)
            ph = ph + torch.angle(torch.sum(zc * cpts[k], dim=-1))
        phases.append(ph)
    return _interp_phases(torch.stack(phases, dim=-1), group, P)


def dd_phase_track(payload: torch.Tensor, theta0: torch.Tensor,
                   pts: torch.Tensor, group: int = 60, n_iter: int = 3,
                   freq_refine: bool = True) -> torch.Tensor:
    """Decision-directed feed-forward phase track for any constellation
    (pilotless 8PSK, 16APSK, 32APSK): per group of `group` symbols,
    derotate by the current estimate, decide the nearest point of `pts`
    (tables.demap_tables' points [S] complex64), re-estimate the phase
    from sum z * conj(decision); n_iter times. The unwrap is anchored at
    theta0, the header phase. With freq_refine a second pass runs after
    removing the residual carrier read from the first pass (the median
    of its group-to-group phase steps, the mean of the two middle
    values for an even count). payload [..., P], theta0 [...] ->
    per-symbol phase [..., P]."""
    P = payload.shape[-1]
    ph1 = _dd_track_once(payload, theta0, pts, group, n_iter)
    if not freq_refine:
        return ph1
    G = P // group
    gp = ph1[..., ::group][..., :G]
    steps, _ = torch.sort(gp[..., 1:] - gp[..., :-1], dim=-1)
    n = steps.shape[-1]
    freq = (steps[..., (n - 1) // 2] + steps[..., n // 2]) / (2.0 * group)
    ramp = freq[..., None] * torch.arange(P, device=payload.device)
    pay2 = payload * _polar1(-ramp)
    return ramp + _dd_track_once(pay2, theta0, pts, group, n_iter)


def extract_payload(frames: torch.Tensor, pstarts, L: int) -> torch.Tensor:
    """Pilots-on payload [..., L] -> [..., P]: the stretches between the
    header and the pilot blocks, as static slices and one concatenation."""
    ps = [int(p) for p in pstarts]
    ends = ps[1:] + [L]
    return torch.cat([frames[..., 90:ps[0]]] +
                     [frames[..., p + 36:e] for p, e in zip(ps, ends)], dim=-1)


def pilot_anchor_phases(frames: torch.Tensor, theta0: torch.Tensor, pilots
                        ) -> torch.Tensor:
    """Piecewise-linear phase over the frame from the header anchor
    (theta0 [...], at symbol 45) and one anchor per pilot block (at its
    centre), unwrapped from the header by a prefix sum of wrapped steps.
    After the last pilot the track goes on at the slope of the anchors
    (from the first pilot to the last), not flat: the residual of the
    block-common frequency would otherwise accrue over the unanchored
    tail. frames [..., L] -> [..., L]."""
    L = frames.shape[-1]
    lead = frames.shape[:-1]
    pstarts = pilots[0]
    n_p = len(pstarts)
    p0, step = _pilot_grid(pstarts)
    raw = torch.angle(torch.sum(pilot_blocks(frames, pilots), dim=-1))
    two_pi = 2 * math.pi
    d = raw[..., 1:] - raw[..., :-1]
    d = d - torch.round(d / two_pi) * two_pi
    base = raw[..., :1] - torch.round((raw[..., :1] - theta0[..., None])
                                      / two_pi) * two_pi
    vals = torch.cat([theta0[..., None], base + torch.cat(
        [torch.zeros_like(base), torch.cumsum(d, dim=-1)], dim=-1)], dim=-1)
    # anchors: 45 (header), then p0+18 + k*step; built per region
    a1 = p0 + 18
    dev = frames.device
    t_head = torch.arange(a1, dtype=torch.float32, device=dev)
    w = torch.clamp((t_head - 45.0) / (a1 - 45.0), 0.0, 1.0)
    head = vals[..., :1] + (vals[..., 1:2] - vals[..., :1]) * w
    dmid = vals[..., 2:] - vals[..., 1:-1]
    frac = torch.arange(step, dtype=torch.float32, device=dev) / step
    mid = (vals[..., 1:-1, None] + dmid[..., None] * frac).reshape(*lead, -1)
    tail_len = L - a1 - (n_p - 1) * step
    if n_p > 1:
        slope = (vals[..., -1:] - vals[..., 1:2]) / ((n_p - 1) * step)
    else:
        slope = (vals[..., 1:2] - vals[..., :1]) / float(a1 - 45)
    t_tail = torch.arange(tail_len, dtype=torch.float32, device=dev)
    tail = vals[..., -1:] + slope * t_tail
    return torch.cat([head, mid, tail], dim=-1)
