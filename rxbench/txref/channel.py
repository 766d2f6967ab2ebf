"""Channel model for loopback testing: pulse shaping + impairments.

Generates the IQ the receiver actually sees: RRC-shaped samples at a
configurable oversampling ratio with carrier frequency offset, phase
offset/noise, sample-clock offset, delay and AWGN — the impairment set
the reference's loops are built to track (FLL/Costas/Gardner/FED).
"""
from __future__ import annotations

import numpy as np

# samples the fractional resampler of impair() interpolates at a time
RESAMPLE_CHUNK = 1 << 18


def rrc_taps(ntaps: int, alpha: float, sps: float) -> np.ndarray:
    """Root-raised-cosine taps, unit DC gain, symmetric, odd length.

    Same filter family as SDR++ taps::rootRaisedCosine (the reference's
    matched filter; RRC_TAP_COUNT=65, RRC_ALPHA=0.35, main.cpp:69-70).
    """
    assert ntaps % 2 == 1
    t = (np.arange(ntaps) - ntaps // 2) / sps  # time in symbols
    h = np.zeros(ntaps)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            h[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha)) +
                (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            h[i] = (np.sin(np.pi * ti * (1 - alpha)) +
                    4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha))) / \
                   (np.pi * ti * (1 - (4 * alpha * ti) ** 2))
    return (h / h.sum()).astype(np.float32)


def shape(symbols: np.ndarray, sps: int = 2, alpha: float = 0.35,
          ntaps: int = 65) -> np.ndarray:
    """Upsample by sps and RRC-filter. Returns unit-average-power samples
    aligned so sample k*sps corresponds to symbol k (filter delay removed)."""
    n = len(symbols)
    up = np.zeros(n * sps, np.complex64)
    up[::sps] = symbols
    h = rrc_taps(ntaps, alpha, sps)
    x = np.convolve(up, h)
    d = ntaps // 2
    x = x[d:d + n * sps]
    x /= np.sqrt(np.mean(np.abs(x) ** 2))
    return x.astype(np.complex64)


def impair(x: np.ndarray, snr_db: float | None = None,
           cfo: float = 0.0, phase: float = 0.0,
           phase_noise_std: float = 0.0, sco_ppm: float = 0.0,
           delay_samples: float = 0.0, seed: int = 0) -> np.ndarray:
    """Apply impairments to complex baseband samples.

    cfo: carrier offset in radians/sample. sco_ppm: sample clock offset
    (resamples by 1+ppm*1e-6 with linear interpolation). delay_samples:
    fractional delay via sinc interpolation of the same resampler.
    snr_db: per-sample Es/N0 (signal assumed unit power).
    """
    rng = np.random.default_rng(seed)
    y = x.astype(np.complex64)
    if sco_ppm or delay_samples:
        # windowed-sinc fractional resampler (16 taps) — a linear
        # interpolator would add in-band distortion larger than the noise
        ratio = 1.0 + sco_ppm * 1e-6
        t = np.arange(len(y)) * ratio + delay_samples
        t = t[(t >= 8) & (t <= len(y) - 9)]
        k = np.arange(-7, 9)[None, :]
        out = np.empty(len(t), np.complex64)
        # in chunks: a sample's [16] taps are its own, and a capture of
        # millions of samples would otherwise hold [n, 16] in float64
        for a in range(0, len(t), RESAMPLE_CHUNK):
            tc = t[a:a + RESAMPLE_CHUNK]
            i0 = np.floor(tc).astype(np.int64)
            mu = (tc - i0)[:, None]
            w = 0.54 + 0.46 * np.cos(np.pi * (k - mu) / 8)
            taps = np.sinc(k - mu) * np.where(np.abs(k - mu) <= 8, w, 0)
            taps /= taps.sum(axis=1, keepdims=True)
            out[a:a + len(tc)] = (y[i0[:, None] + k] * taps).sum(axis=1)
        y = out
    n = len(y)
    ph = phase + cfo * np.arange(n)
    if phase_noise_std:
        ph = ph + np.cumsum(rng.normal(0, phase_noise_std, n))
    y = y * np.exp(1j * ph).astype(np.complex64)
    if snr_db is not None:
        sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
        noise = (rng.normal(0, sigma, n) + 1j * rng.normal(0, sigma, n))
        y = y + noise.astype(np.complex64)
    return y.astype(np.complex64)
