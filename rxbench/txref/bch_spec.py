"""DVB-S2 outer BCH code: generator polynomials, encoder, reference decoder.

Parameters follow EN 302 307-1 sec. 5.3.1 and match the reference wrapper
(reference src/demod/dvbs2/codings/bbframe_bch.{h,cpp}):
 - normal FECFRAME: GF(2^16) poly 0b1_0000_0000_0010_1101, t in {8,10,12}
 - short FECFRAME:  GF(2^14) poly 0b100_0000_0010_1011,   t = 12
Generator polynomial = product of the minimal polynomials of
alpha^1, alpha^3, ..., alpha^(2t-1) — computed here algorithmically instead
of transcribing the twelve polynomial tables (bbframe_bch.cpp:250-364); a
unit test cross-checks the products against the standard's values.

Everything here is numpy host code: it serves as the golden TX encoder and
the rare-path error corrector; the hot RX syndrome computation runs on TPU
as a GF(2) matmul (see dvbs_tpu/ops/bch.py).
"""
from __future__ import annotations

import functools
import numpy as np

from . import gf2m
from .modcod import BCH_PARAMS, NORMAL, SHORT


@functools.lru_cache()
def field_for(framesize: str) -> gf2m.GF2m:
    return gf2m.gf65536() if framesize == NORMAL else gf2m.gf16384()


@functools.lru_cache()
def generator_poly(framesize: str, t: int) -> np.ndarray:
    """g(x) coefficients over GF(2), degree = num parity bits. [deg+1] uint8"""
    gf = field_for(framesize)
    g = np.array([1], np.int64)
    seen = set()
    for i in range(1, 2 * t, 2):
        mp = gf.minimal_polynomial(i)
        key = tuple(mp.tolist())
        assert key not in seen  # odd-power minimal polys are distinct here
        seen.add(key)
        g = gf.poly_mul(g, mp)
    assert np.all((g == 0) | (g == 1))
    return g.astype(np.uint8)


def num_parity_bits(framesize: str, t: int) -> int:
    return len(generator_poly(framesize, t)) - 1


@functools.lru_cache()
def _parity_matrix(framesize: str, rate: str) -> np.ndarray:
    """M[kbch, p] over GF(2): parity = (msg_bits @ M) % 2, where msg bit 0 is
    the first transmitted bit (coefficient of x^(nbch-1)).

    Row i = x^(nbch-1-i) mod g(x).  Built with a byte-stepped LFSR for speed.
    """
    kbch, nbch, t = BCH_PARAMS[(framesize, rate)]
    g = generator_poly(framesize, t)
    p = len(g) - 1
    gint = int("".join(map(str, g[::-1].tolist())), 2)  # bit p = x^p term
    top = 1 << p
    # r_i = x^(p + (kbch-1-i)) mod g, computed iteratively from
    # x^p mod g = g - x^p (the low-order tail of g).
    nby = (p + 7) // 8
    buf = bytearray(kbch * nby)
    r = gint ^ top
    for i in range(kbch - 1, -1, -1):
        buf[i * nby:(i + 1) * nby] = r.to_bytes(nby, "big")
        r <<= 1
        if r & top:
            r ^= gint
    bits = np.unpackbits(np.frombuffer(bytes(buf), np.uint8).reshape(kbch, nby),
                         axis=1)
    return bits[:, nby * 8 - p:]


def parity_matrix(framesize: str, rate: str) -> np.ndarray:
    return _parity_matrix(framesize, rate)


def encode(msg_bits: np.ndarray, framesize: str, rate: str) -> np.ndarray:
    """Systematic BCH encode. msg_bits [..., kbch] uint8 -> [..., nbch]."""
    kbch, nbch, t = BCH_PARAMS[(framesize, rate)]
    assert msg_bits.shape[-1] == kbch
    M = parity_matrix(framesize, rate)
    par = (msg_bits.astype(np.int64) @ M.astype(np.int64)) % 2
    return np.concatenate([msg_bits, par.astype(np.uint8)], axis=-1)


def syndromes(code_bits: np.ndarray, framesize: str, rate: str) -> np.ndarray:
    """S_j = c(alpha^j), j = 1..2t. code_bits [nbch] -> [2t] int64 (numpy path)."""
    kbch, nbch, t = BCH_PARAMS[(framesize, rate)]
    gf = field_for(framesize)
    (idx,) = np.nonzero(code_bits)
    if len(idx) == 0:
        return np.zeros(2 * t, np.int64)
    powers = nbch - 1 - idx  # coefficient power of each set bit
    j = np.arange(1, 2 * t + 1, dtype=np.int64)
    vals = gf.alpha_pow(j[:, None] * powers[None, :])   # [2t, nset]
    return np.bitwise_xor.reduce(vals, axis=1)


def decode(code_bits: np.ndarray, framesize: str, rate: str):
    """Berlekamp-Massey + Chien + bit-flip. Returns (corrected_bits,
    n_corrections) with n_corrections = -1 on decode failure (mirrors the
    reference's corrections counting, bbframe_bch.cpp:380-405)."""
    kbch, nbch, t = BCH_PARAMS[(framesize, rate)]
    s = syndromes(code_bits, framesize, rate)
    if not s.any():
        return code_bits, 0
    gf = field_for(framesize)
    # Berlekamp-Massey for binary BCH (syndromes S_1..S_2t)
    C = np.zeros(2 * t + 1, np.int64); C[0] = 1
    B = np.zeros(2 * t + 1, np.int64); B[0] = 1
    L, mshift = 0, 1
    b = 1
    for n in range(2 * t):
        d = int(s[n])
        for i in range(1, L + 1):
            d ^= int(gf.mul(int(C[i]), int(s[n - i])))
        if d == 0:
            mshift += 1
        elif 2 * L <= n:
            T = C.copy()
            coef = gf.mul(d, gf.inv(b))
            C[mshift:] = C[mshift:] ^ gf.mul(int(coef), B[:len(B) - mshift])
            L = n + 1 - L
            B = T
            b = d
            mshift = 1
        else:
            coef = gf.mul(d, gf.inv(b))
            C[mshift:] = C[mshift:] ^ gf.mul(int(coef), B[:len(B) - mshift])
            mshift += 1
    if L > t:
        return code_bits, -1
    # Chien search over the nbch valid positions
    # error at bit index i <=> locator root alpha^{-(nbch-1-i)}
    powers = nbch - 1 - np.arange(nbch)
    x = gf.alpha_pow(-powers)  # candidate inverse roots
    vals = gf.poly_eval(C[:L + 1], x)
    err_idx = np.nonzero(vals == 0)[0]
    if len(err_idx) != L:
        return code_bits, -1
    out = code_bits.copy()
    out[err_idx] ^= 1
    # verify
    if syndromes(out, framesize, rate).any():
        return code_bits, -1
    return out, int(L)
