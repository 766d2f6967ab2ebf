"""Reed-Solomon (204,188) T=8 for DVB-S (EN 300 421 sec. 4.4.2).

Shortened RS(255,239) over GF(2^8), primitive polynomial
x^8+x^4+x^3+x^2+1 (0x11D), generator roots alpha^0..alpha^15 — the same
code the reference builds via libcorrect
(reference src/demod/dvbs/dvbs_reedsolomon.h:17: fcr=0, gap=1,
nroots=16; shortening pads 51 leading zeros).
Numpy implementation: vectorized syndromes, Berlekamp-Massey + Chien +
Forney on the (rare) nonzero-syndrome path.
"""
from __future__ import annotations

import functools
import numpy as np

from . import gf2m

N_FULL, K_FULL = 255, 239
N, K = 204, 188
PAD = N_FULL - N          # 51
NROOTS = 16
T = 8
FCR = 0                   # first consecutive root exponent


@functools.lru_cache()
def _gf() -> gf2m.GF2m:
    return gf2m.GF2m(8, 0x11D)


@functools.lru_cache()
def generator_poly() -> np.ndarray:
    """g(x) = prod_{i=0..15} (x - alpha^(FCR+i)); coeff index = power."""
    gf = _gf()
    g = np.array([1], np.int64)
    for i in range(NROOTS):
        g = gf.poly_mul(g, np.array([gf.alpha_pow(FCR + i), 1], np.int64))
    return g


def encode(msg: np.ndarray) -> np.ndarray:
    """msg [..., 188] uint8 -> codeword [..., 204] uint8 (systematic)."""
    gf = _gf()
    g = generator_poly()
    squeeze = msg.ndim == 1
    m2 = np.atleast_2d(msg)
    out = np.zeros(m2.shape[:-1] + (N,), np.uint8)
    glow = g[:-1]  # degree NROOTS, monic
    for b in range(m2.shape[0]):
        # polynomial long division: remainder of m(x) * x^16 mod g(x)
        rem = np.zeros(NROOTS, np.int64)
        for byte in m2[b]:
            fb = int(byte) ^ int(rem[-1])
            rem[1:] = rem[:-1]
            rem[0] = 0
            if fb:
                rem ^= gf.mul(fb, glow)
        out[b, :K] = m2[b]
        out[b, K:] = rem[::-1]
    return out[0] if squeeze else out


def syndromes(code: np.ndarray) -> np.ndarray:
    """code [204] uint8 -> [16] int64. Zero vector iff clean.

    Codeword poly: c(x) = sum code[i] * x^(N_FULL-1-PAD-i) (virtual 51-byte
    zero prefix does not affect syndromes).
    """
    gf = _gf()
    (idx,) = np.nonzero(code)
    if len(idx) == 0:
        return np.zeros(NROOTS, np.int64)
    powers = (N - 1 - idx).astype(np.int64)
    j = np.arange(FCR, FCR + NROOTS, dtype=np.int64)
    terms = gf.mul(code[idx][None, :].astype(np.int64),
                   gf.alpha_pow(j[:, None] * powers[None, :]))
    return np.bitwise_xor.reduce(terms, axis=1)


def decode(code: np.ndarray):
    """[204] uint8 -> (corrected [204] uint8, n_corrected | -1 on failure).

    Mirrors the reference's error accounting (corrected byte count;
    -1 on decode failure, dvbs_reedsolomon.h:26-47).
    """
    gf = _gf()
    s = syndromes(code)
    if not s.any():
        return code, 0
    # Berlekamp-Massey (nonbinary)
    C = np.zeros(NROOTS + 1, np.int64); C[0] = 1
    B = np.zeros(NROOTS + 1, np.int64); B[0] = 1
    L, m, b = 0, 1, 1
    for n in range(NROOTS):
        d = int(s[n])
        for i in range(1, L + 1):
            d ^= int(gf.mul(int(C[i]), int(s[n - i])))
        if d == 0:
            m += 1
        elif 2 * L <= n:
            Tp = C.copy()
            coef = gf.mul(d, gf.inv(b))
            C[m:] ^= gf.mul(int(coef), B[:NROOTS + 1 - m])
            L = n + 1 - L
            B = Tp
            b = d
            m = 1
        else:
            coef = gf.mul(d, gf.inv(b))
            C[m:] ^= gf.mul(int(coef), B[:NROOTS + 1 - m])
            m += 1
    if L > T:
        return code, -1
    # Chien search over valid positions: error at byte i <=> root alpha^-(N-1-i)
    pos_pow = (N - 1 - np.arange(N)).astype(np.int64)
    x = gf.alpha_pow(-pos_pow)
    vals = gf.poly_eval(C[:L + 1], x)
    err_idx = np.nonzero(vals == 0)[0]
    if len(err_idx) != L:
        return code, -1
    # Forney: error magnitude e_i = X_i^(1-FCR) * Omega(X_i^-1)/Lambda'(X_i^-1)
    S_poly = s.astype(np.int64)
    # Omega = S(x) * Lambda(x) mod x^NROOTS
    om = np.zeros(NROOTS, np.int64)
    for i in range(NROOTS):
        acc = 0
        for j2 in range(min(i + 1, L + 1)):
            acc ^= int(gf.mul(int(C[j2]), int(S_poly[i - j2])))
        om[i] = acc
    Xinv = gf.alpha_pow(-pos_pow[err_idx])
    Xi = gf.alpha_pow(pos_pow[err_idx])
    om_val = gf.poly_eval(om, Xinv)
    # Lambda'(x): formal derivative (odd-degree coefficients)
    dC = C[1::2].copy()
    lam_d = np.zeros(len(err_idx), np.int64)
    for k, xi in enumerate(Xinv):
        acc = 0
        xpow = 1
        x2 = int(gf.mul(int(xi), int(xi)))
        for c in dC:
            if c:
                acc ^= int(gf.mul(int(c), xpow))
            xpow = int(gf.mul(xpow, x2))
        lam_d[k] = acc
    if np.any(lam_d == 0):
        return code, -1
    mag = gf.mul(gf.pow(Xi, 1 - FCR), gf.div(om_val, lam_d))
    out = code.copy().astype(np.int64)
    out[err_idx] ^= mag
    out = out.astype(np.uint8)
    if syndromes(out).any():
        return code, -1
    return out, int(L)
