"""GF(2^m) arithmetic with numpy log/antilog tables.

Used by the BCH codec (GF(2^16)/GF(2^14), bbframe_bch.h:45-52) and the
RS(204,188) codec (GF(2^8) poly 0x187, dvbs_reedsolomon.h:17).
All operations are vectorized over numpy arrays of element indices.
"""
from __future__ import annotations

import functools
import numpy as np


class GF2m:
    """Galois field GF(2^m) defined by a primitive polynomial (bitmask incl.
    the x^m term, e.g. 0x187 for GF(256) = x^8+x^7+x^2+x+1)."""

    def __init__(self, m: int, poly: int):
        self.m = m
        self.poly = poly
        self.q = 1 << m          # field size
        self.n = self.q - 1      # multiplicative order
        exp = np.zeros(2 * self.n, np.int64)
        log = np.zeros(self.q, np.int64)
        x = 1
        for i in range(self.n):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.q:
                x ^= poly
        assert x == 1, "polynomial is not primitive"
        exp[self.n:] = exp[:self.n]  # wraparound so exp[a+b] works directly
        self.exp_table = exp
        self.log_table = log

    # -- vectorized ops over arrays of field elements (int arrays) ----------

    def mul(self, a, b):
        a = np.asarray(a); b = np.asarray(b)
        out = np.zeros(np.broadcast(a, b).shape, np.int64)
        nz = (a != 0) & (b != 0)
        la = self.log_table[np.broadcast_to(a, out.shape)[nz]]
        lb = self.log_table[np.broadcast_to(b, out.shape)[nz]]
        out[nz] = self.exp_table[la + lb]
        return out

    def inv(self, a):
        a = np.asarray(a)
        if np.any(a == 0):
            raise ZeroDivisionError("GF inverse of 0")
        return self.exp_table[self.n - self.log_table[a]]

    def div(self, a, b):
        return self.mul(a, self.inv(b))

    def pow(self, a, k):
        """a^k elementwise; a scalar or array, k int array (>=0)."""
        a = np.asarray(a); k = np.asarray(k)
        out = np.ones(np.broadcast(a, k).shape, np.int64)
        zero = np.broadcast_to(a, out.shape) == 0
        out[zero & (k > 0)] = 0
        nz = ~zero
        la = self.log_table[np.broadcast_to(a, out.shape)[nz]]
        out[nz] = self.exp_table[(la * np.broadcast_to(k, out.shape)[nz]) % self.n]
        return out

    def alpha_pow(self, k):
        """alpha^k for integer array k (any sign)."""
        k = np.asarray(k)
        return self.exp_table[np.mod(k, self.n)]

    # -- polynomials over GF (coefficient arrays, index = power of x) -------

    def poly_eval(self, coeffs: np.ndarray, x):
        """Evaluate sum_i coeffs[i] * x^i (Horner), x scalar or array."""
        x = np.asarray(x)
        acc = np.zeros(x.shape, np.int64)
        for c in coeffs[::-1]:
            acc = self.mul(acc, x) ^ int(c)
        return acc

    def poly_mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        out = np.zeros(len(a) + len(b) - 1, np.int64)
        for i, ai in enumerate(a):
            if ai:
                out[i:i + len(b)] ^= self.mul(int(ai), b)
        return out

    def minimal_polynomial(self, elem_log: int) -> np.ndarray:
        """Minimal polynomial over GF(2) of alpha^elem_log, as a GF(2)
        coefficient array (index = power of x)."""
        # conjugacy class {e, 2e, 4e, ...} mod n
        conj, e = [], elem_log % self.n
        while e not in conj:
            conj.append(e)
            e = (2 * e) % self.n
        poly = np.array([1], np.int64)
        for e in conj:
            poly = self.poly_mul(poly, np.array([self.exp_table[e], 1], np.int64))
        assert np.all((poly == 0) | (poly == 1)), "minimal poly not over GF(2)"
        return poly


@functools.lru_cache()
def gf65536() -> GF2m:
    """GF(2^16), poly 0b1_0000_0000_0010_1101 (bbframe_bch.h:45)."""
    return GF2m(16, 0b10000000000101101)


@functools.lru_cache()
def gf16384() -> GF2m:
    """GF(2^14), poly 0b100_0000_0010_1011 (bbframe_bch.h:47)."""
    return GF2m(14, 0b100000000101011)


@functools.lru_cache()
def gf256() -> GF2m:
    """GF(2^8), poly 0x187 (libcorrect RS backend, dvbs_reedsolomon.h:17)."""
    return GF2m(8, 0x187)
