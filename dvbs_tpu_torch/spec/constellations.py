"""DVB-S2 constellations in standard bit order (EN 302 307-1 sec. 5.4).

Point tables are indexed by the standard symbol bits (y0 .. y_{m-1}, y0
first/MSB).  The geometry (8PSK Gray map, APSK ring radii from the
gamma ring ratios) reproduces the reference's constellation_t
(reference src/demod/common/dsp/demod/constellation.cpp:22-150),
whose internal index convention is idx = sum_j (1-y_j)<<j; we remap it to
standard order here, so TX mapping, RX demapping and the bit
(de)interleaver all speak the standard's (y0..y_{m-1}) convention.

All tables are unit average power.
"""
from __future__ import annotations

import functools
import numpy as np

from .modcod import QPSK, PSK8, APSK16, APSK32, MOD_BITS

_SQ2 = 1.0 / np.sqrt(2.0)


def _polar(r, n, i):
    a = i * 2 * np.pi / n
    return r * np.cos(a) + 1j * r * np.sin(a)


def _internal_table(kind: str, g1: float | None, g2: float | None) -> np.ndarray:
    """Reference-convention (internal index) constellation, unit power."""
    if kind == "bpsk":
        # constellation.cpp:22-28 (pi/2-BPSK handled at the PL layer)
        return np.array([-1.0 + 0j, 1.0 + 0j])
    if kind == "oqpsk":
        # same points as QPSK; the half-symbol Q offset is a timing
        # property, not a constellation one (constellation.cpp:29)
        kind = QPSK
    if kind == QPSK:
        pts = np.empty(4, np.complex128)
        pts[0] = -_SQ2 - 1j * _SQ2
        pts[1] = +_SQ2 - 1j * _SQ2
        pts[2] = -_SQ2 + 1j * _SQ2
        pts[3] = +_SQ2 + 1j * _SQ2
    elif kind == PSK8:
        r = _SQ2
        pts = np.array([
            0.0 - 1.0j, -r + 1j * r, r - 1j * r, 0.0 + 1.0j,
            -r - 1j * r, -1.0 + 0.0j, 1.0 + 0.0j, r + 1j * r,
        ])
    elif kind == APSK16:
        gamma1 = g1 or 2.57
        r1 = np.sqrt(4.0 / (1.0 + 3.0 * gamma1 ** 2))
        r2 = gamma1 * r1
        pts = np.empty(16, np.complex128)
        ring2 = {15: 1.5, 14: 10.5, 13: 4.5, 12: 7.5, 11: 0.5, 10: 11.5,
                 9: 5.5, 8: 6.5, 7: 2.5, 6: 9.5, 5: 3.5, 4: 8.5}
        for idx, pos in ring2.items():
            pts[idx] = _polar(r2, 12, pos)
        ring1 = {3: 0.5, 2: 3.5, 1: 1.5, 0: 2.5}
        for idx, pos in ring1.items():
            pts[idx] = _polar(r1, 4, pos)
    elif kind == APSK32:
        gamma1 = g1 or 2.53
        gamma2 = g2 or 4.30
        r1 = np.sqrt(8.0 / (1.0 + 3.0 * gamma1 ** 2 + 4.0 * gamma2 ** 2))
        r2 = gamma1 * r1
        r3 = gamma2 * r1
        pts = np.empty(32, np.complex128)
        ring2 = {31: 1.5, 30: 2.5, 29: 10.5, 28: 9.5, 27: 4.5, 26: 3.5,
                 25: 7.5, 24: 8.5, 15: 0.5, 13: 11.5, 11: 5.5, 9: 6.5}
        ring3 = {23: 1, 22: 3, 21: 14, 20: 12, 19: 6, 18: 4, 17: 9, 16: 11,
                 7: 0, 6: 2, 5: 15, 4: 13, 3: 7, 2: 5, 1: 8, 0: 10}
        ring1 = {14: 0.5, 12: 3.5, 10: 1.5, 8: 2.5}
        for idx, pos in ring2.items():
            pts[idx] = _polar(r2, 12, pos)
        for idx, pos in ring3.items():
            pts[idx] = _polar(r3, 16, pos)
        for idx, pos in ring1.items():
            pts[idx] = _polar(r1, 4, pos)
    else:
        raise ValueError(kind)
    # normalize to unit average power
    pts = pts / np.sqrt(np.mean(np.abs(pts) ** 2))
    return pts


@functools.lru_cache()
def points(kind: str, g1: float | None = None, g2: float | None = None) -> np.ndarray:
    """Constellation points indexed by standard symbol value
    (y0<<(m-1) | ... | y_{m-1}).  [2^m] complex64, unit average power."""
    internal = _internal_table(kind, g1, g2)
    m = MOD_BITS.get(kind, 1 if kind == "bpsk" else 2)
    out = np.empty(1 << m, np.complex128)
    for std in range(1 << m):
        internal_idx = 0
        for j in range(m):
            yj = (std >> (m - 1 - j)) & 1
            internal_idx |= (1 - yj) << j
        out[std] = internal[internal_idx]
    return out.astype(np.complex64)


def modulate(symbols: np.ndarray, kind: str,
             g1: float | None = None, g2: float | None = None) -> np.ndarray:
    """Map standard symbol values -> complex points."""
    return points(kind, g1, g2)[symbols]


def bits_to_symbols(bits: np.ndarray, kind: str) -> np.ndarray:
    """Group consecutive bits (y0 first) into symbol values.
    bits [..., n*m] -> [..., n] int32."""
    m = MOD_BITS[kind]
    b = bits.reshape(bits.shape[:-1] + (-1, m)).astype(np.int32)
    weights = (1 << np.arange(m - 1, -1, -1)).astype(np.int32)
    return (b * weights).sum(-1)


def symbols_to_bits(symbols: np.ndarray, kind: str) -> np.ndarray:
    """Inverse of bits_to_symbols. symbols [..., n] -> [..., n*m] uint8."""
    m = MOD_BITS[kind]
    shifts = np.arange(m - 1, -1, -1)
    bits = ((symbols[..., None] >> shifts) & 1).astype(np.uint8)
    return bits.reshape(symbols.shape[:-1] + (symbols.shape[-1] * m,))
