"""The `demap` range: PLS detection, the soft demapper and the bit
deinterleave of every frame of a step.

Operations, per payload symbol of a constellation of M points and
m = log2(M) bits, each exp and log counted as one operation:
- the distance to each of the M points: 2 subtractions, 2 products,
  1 addition, 1 square root: 6 M;
- per bit, a log-sum-exp over the M/2 points whose bit is 0 and one over
  the M/2 whose bit is 1; one over K points takes K - 1 maxima, K
  subtractions, K exps, K - 1 additions, a log and an addition, 4 K; the
  two and their difference and scale: 4 M + 2 per bit.
The PLS detection (90 header symbols against the PLS codes) and the
deinterleave (a permutation) add under 1% and are not counted.

Bytes: the payload and header symbols in (complex64), the LLRs out
(float32, one a bit) and the PLS code and confidence out."""
from __future__ import annotations


def ops_per_symbol(m: int) -> int:
    M = 1 << m
    return 6 * M + m * (4 * M + 2)


def work(ctx):
    cfg = ctx.cfg
    frames = ctx.frames_per_step
    syms = frames * cfg.payload_len
    ops = syms * ops_per_symbol(cfg.mod_bits)
    nbytes = 8 * (syms + 90 * frames) + 4 * frames * cfg.nldpc + 8 * frames
    return float(ops), float(nbytes)
