"""DVB-S2 bit interleaver permutations (EN 302 307-1 sec. 5.3.3).

Semantics match the reference's S2Deinterleaver
(reference src/demod/dvbs2/codings/s2_deinterleaver.cpp:26-136):
the deinterleaver receives the per-symbol demapped bit stream
(m LLRs per symbol, y0 first — note the reference demapper emits them
reversed and its column assignment compensates; here both sides use
standard order) and writes column k's bits contiguously at a per-mode
column offset.  QPSK has no interleaving.

We expose a single permutation array so both directions are gathers:
    deinterleaved[i] = stream[perm[i]]   (RX)
    stream[perm[i]] = codeword[i]        (TX)
"""
from __future__ import annotations

import functools
import numpy as np

from .modcod import QPSK, PSK8, APSK16, APSK32, MOD_BITS, NORMAL


_ROWS = {
    (PSK8, NORMAL): 21600, (PSK8, "short"): 5400,
    (APSK16, NORMAL): 16200, (APSK16, "short"): 4050,
    (APSK32, NORMAL): 12960, (APSK32, "short"): 3240,
}


def column_offsets(kind: str, framesize: str, rate: str) -> list[int]:
    """Output offset of column c_k (k=1..m), where c_k holds standard bit
    y_{m-k} of every symbol; s2_deinterleaver.cpp:26-65."""
    rows = _ROWS[(kind, framesize)]
    m = MOD_BITS[kind]
    if kind == PSK8 and rate == "3/5":
        return [2 * rows, rows, 0]
    return [k * rows for k in range(m)]


@functools.lru_cache()
def deinterleave_perm(kind: str, framesize: str, rate: str) -> np.ndarray:
    """perm with codeword[i] = demap_stream[perm[i]].  [nldpc] int32.

    demap_stream is m LLRs per symbol in standard order (y0 first).
    """
    m = MOD_BITS[kind]
    if kind == QPSK:
        n = 64800 if framesize == NORMAL else 16200
        return np.arange(n, dtype=np.int32)
    rows = _ROWS[(kind, framesize)]
    n = rows * m
    perm = np.empty(n, np.int32)
    offs = column_offsets(kind, framesize, rate)
    j = np.arange(rows, dtype=np.int32)
    for k in range(1, m + 1):          # column c_k holds y_{m-k}
        perm[offs[k - 1] + j] = m * j + (m - k)
    return perm


@functools.lru_cache()
def interleave_perm(kind: str, framesize: str, rate: str) -> np.ndarray:
    """Inverse permutation: demap_stream[i] = codeword[iperm[i]]."""
    perm = deinterleave_perm(kind, framesize, rate)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return inv


def interleave_bits(codeword_bits: np.ndarray, kind: str, framesize: str,
                    rate: str) -> np.ndarray:
    """TX: codeword -> symbol-ordered bit stream. [..., n] -> [..., n]."""
    return codeword_bits[..., interleave_perm(kind, framesize, rate)]


def deinterleave_llrs(stream: np.ndarray, kind: str, framesize: str,
                      rate: str) -> np.ndarray:
    """RX: symbol-ordered LLR stream -> codeword order."""
    return stream[..., deinterleave_perm(kind, framesize, rate)]
