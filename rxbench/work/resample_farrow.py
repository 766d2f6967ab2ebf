"""Kernel B, the barrel + Farrow resampler of the `timing` range, on a
step's [C, S] symbols (S = block_symbols): the 2-sps samples read once
(complex64, 2 S a carrier), the positions read once (float32, S) and the
symbols written once (complex64, S): 28 bytes a symbol.

Operations per symbol: TAPS taps, each a polynomial of degree DEG in the
band coordinate (Horner: DEG multiply-adds, 2 DEG operations) times a
complex sample (4 operations): TAPS (2 DEG + 4), with TAPS = 10 and
DEG = 9 as the receiver's interpolator has them."""
from __future__ import annotations

TAPS, DEG = 10, 9


def work(ctx):
    n = ctx.conf["carriers"] * ctx.block_symbols
    return float(n * TAPS * (2 * DEG + 4)), float(n * 28)
