"""DVB-S2 physical-layer header: SOF and PLS codes (EN 302 307-1 sec. 5.5.2).

Reproduces the constants and symbol conventions of the reference's s2_defs.h
(reference src/demod/dvbs2/s2_defs.h) as vectorized numpy:

- SOF: 26-symbol pi/2-BPSK preamble, value 0x18D2E82.
- PLS: 64-bit (32,7) Reed-Muller codewords, index = MODCOD<<2|short<<1|pilots,
  scrambled with 0x719D83C953422DFA; also their pi/2-BPSK symbol form.
- Differential-correlation templates used for frame sync
  (dvbs2_pl_sync.cpp:167-193).
"""
from __future__ import annotations

import functools
import numpy as np

SOF_VALUE = 0x18D2E82
SOF_LEN = 26
PLS_LEN = 64
PLS_COUNT = 128
PLS_SCRAMBLING = 0x719D83C953422DFA

_SQ2 = 1.0 / np.sqrt(2.0)


def sof_bits() -> np.ndarray:
    """SOF bit sequence, MSB first. [26] uint8"""
    return np.array([(SOF_VALUE >> (SOF_LEN - 1 - i)) & 1 for i in range(SOF_LEN)],
                    np.uint8)


def sof_symbols() -> np.ndarray:
    """pi/2-BPSK SOF symbols: angle = pi/4 + (bit*2 + (i&1)) * pi/2
    (s2_defs.h s2_sof ctor). [26] complex64"""
    b = sof_bits().astype(np.float64)
    i = np.arange(SOF_LEN)
    ang = np.pi / 4 + (b * 2 + (i & 1)) * np.pi / 2
    return (np.cos(ang) + 1j * np.sin(ang)).astype(np.complex64)


@functools.lru_cache()
def _pls_tables():
    """Compute all 128 PLS codewords and their symbols (s2_defs.h s2_plscodes)."""
    G = [0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF, 0xFFFFFFFF]
    codewords = np.zeros(PLS_COUNT, np.uint64)
    symbols = np.zeros((PLS_COUNT, PLS_LEN), np.complex64)
    for index in range(PLS_COUNT):
        y = 0
        for row in range(6):
            if (index >> (6 - row)) & 1:
                y ^= G[row]
        code = 0
        for bit in range(31, -1, -1):
            yi = (y >> bit) & 1
            if index & 1:   # bit b7 (pilots) complements odd bits
                code = (code << 2) | (yi << 1) | (yi ^ 1)
            else:
                code = (code << 2) | (yi << 1) | yi
        code ^= PLS_SCRAMBLING
        codewords[index] = np.uint64(code)
        for i in range(PLS_LEN):
            yi = (code >> (PLS_LEN - 1 - i)) & 1
            nyi = yi ^ (i & 1)
            symbols[index, i] = (1 - 2 * int(nyi)) * _SQ2 + 1j * (1 - 2 * int(yi)) * _SQ2
    return codewords, symbols


def pls_codewords() -> np.ndarray:
    """All 128 scrambled 64-bit PLS codewords. [128] uint64"""
    return _pls_tables()[0]


def pls_bit_matrix() -> np.ndarray:
    """PLS codewords as bits, MSB first. [128, 64] uint8"""
    cw = pls_codewords()
    shifts = np.arange(PLS_LEN - 1, -1, -1, dtype=np.uint64)
    return ((cw[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)


def pls_symbols() -> np.ndarray:
    """pi/2-BPSK symbol form of each PLS codeword. [128, 64] complex64"""
    return _pls_tables()[1]


def plheader_symbols(pls_code: int) -> np.ndarray:
    """Full 90-symbol PLHEADER (SOF + PLS) for one PLS index. [90] complex64"""
    return np.concatenate([sof_symbols(), pls_symbols()[pls_code]])


# ---------------------------------------------------------------------------
# Differential-correlation templates for frame sync.
#
# With d[i] = conj(z[i-1]) * z[i] over received symbols z, the expected sign
# of Im/Re contributions at each position inside the 90-symbol header is data
# independent for the SOF (known bits) and for the odd positions of the PLS
# (its scrambler fixes the even->odd transitions); dvbs2_pl_sync.cpp:167-193.
# ---------------------------------------------------------------------------

def sof_diff_template() -> np.ndarray:
    """Signs s[i] in {+1,-1} such that sum_i s[i]*d[i] peaks at SOF.
    Index 0 is unused by the reference (its first diff is zeroed); we keep
    the full 26 signs and let the caller zero d[0] if matching exactly.
    [26] float32"""
    dsof = SOF_VALUE ^ (SOF_VALUE >> 1)
    s = np.empty(SOF_LEN, np.float32)
    for i in range(SOF_LEN):
        s[i] = 1.0 if ((dsof >> (SOF_LEN - 1 - i)) ^ i) & 1 else -1.0
    return s


def pls_diff_template() -> np.ndarray:
    """Signs on odd PLS diff positions (0 elsewhere). [64] float32"""
    dscr = PLS_SCRAMBLING ^ (PLS_SCRAMBLING >> 1)
    s = np.zeros(PLS_LEN, np.float32)
    for i in range(1, PLS_LEN, 2):
        s[i] = -1.0 if (dscr >> (PLS_LEN - 1 - i)) & 1 else 1.0
    return s


def header_diff_templates() -> tuple[np.ndarray, np.ndarray]:
    """(sof_t, pls_t) both length-90 sign templates aligned to the header:
    sof_t covers positions 0..25, pls_t positions 26..89."""
    sof_t = np.zeros(90, np.float32)
    sof_t[:SOF_LEN] = sof_diff_template()
    sof_t[0] = 0.0  # reference zeroes the first differential (no predecessor)
    pls_t = np.zeros(90, np.float32)
    pls_t[SOF_LEN:] = pls_diff_template()
    return sof_t, pls_t
