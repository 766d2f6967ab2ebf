"""Scrambling sequences for DVB-S and DVB-S2 (pure standards math, numpy).

- PL scrambler: Gold-code complex rotation sequence R_n (EN 302 307-1
  sec. 5.5.4); matches the reference's S2Scrambling
  (reference src/demod/dvbs2/codings/s2_scrambling.cpp:9-28).
- BB scrambler: PRBS 1 + x^14 + x^15, seed 100101010000000, applied to the
  BBFRAME payload (EN 302 307-1 sec. 5.2.2); matches BBFrameDescrambler
  (reference src/demod/dvbs2/codings/bbframe_descramble.cpp:122-143).
- DVB-S energy dispersal: same PRBS applied over 8-packet groups with
  inverted sync byte (EN 300 421 sec. 4.4.1); matches DVBSScrambling
  (reference src/demod/dvbs/dvbs_scrambling.h:28-42).
"""
from __future__ import annotations

import functools
import numpy as np

PL_SEQ_LEN = 131072  # 2^18 / 2


@functools.lru_cache()
def pl_scrambler_sequence(codenum: int = 0) -> np.ndarray:
    """R_n in {0,1,2,3}: number of +90deg rotations applied by the PL
    scrambler at payload symbol n (n=0 is the first symbol after the
    PLHEADER). [131072] uint8"""
    def lfsr_x(x):
        bit = ((x >> 7) ^ x) & 1
        return ((bit << 18) | x) >> 1

    def lfsr_y(y):
        bit = ((y >> 10) ^ (y >> 7) ^ (y >> 5) ^ y) & 1
        return ((bit << 18) | y) >> 1

    stx, sty = 0x00001, 0x3FFFF
    for _ in range(codenum):
        stx = lfsr_x(stx)
    rn = np.zeros(PL_SEQ_LEN, np.uint8)
    for i in range(PL_SEQ_LEN):
        rn[i] = (stx ^ sty) & 1
        stx = lfsr_x(stx)
        sty = lfsr_y(sty)
    for i in range(PL_SEQ_LEN):
        rn[i] |= ((stx ^ sty) & 1) << 1
        stx = lfsr_x(stx)
        sty = lfsr_y(sty)
    return rn


@functools.lru_cache()
def pl_scrambler_phasors(codenum: int = 0) -> np.ndarray:
    """exp(+j*pi/2*R_n): multiply TX symbols by this to scramble; multiply RX
    symbols by conj to descramble. [131072] complex64"""
    rn = pl_scrambler_sequence(codenum)
    return np.exp(1j * np.pi / 2 * rn.astype(np.float32)).astype(np.complex64)


def pl_scramble(symbols: np.ndarray, start: int = 0, codenum: int = 0) -> np.ndarray:
    """Scramble payload symbols starting at scrambler position `start`."""
    ph = pl_scrambler_phasors(codenum)[start:start + len(symbols)]
    return (symbols * ph).astype(np.complex64)


def pl_descramble(symbols: np.ndarray, start: int = 0, codenum: int = 0) -> np.ndarray:
    ph = pl_scrambler_phasors(codenum)[start:start + len(symbols)]
    return (symbols * np.conj(ph)).astype(np.complex64)


# ---------------------------------------------------------------------------
# BB scrambler (PRBS 1 + x^14 + x^15)
# ---------------------------------------------------------------------------

_BB_SEED = 0b100101010000000  # MSB-first init sequence, 15 bits


@functools.lru_cache()
def bb_scrambler_bits(nbits: int) -> np.ndarray:
    """First `nbits` of the BB-scrambler PRBS. [nbits] uint8.

    Register holds bits x1..x15 (x1 = MSB); output/feedback = x14 ^ x15.
    """
    reg = _BB_SEED
    out = np.zeros(nbits, np.uint8)
    for i in range(nbits):
        bit = ((reg >> 1) ^ reg) & 1    # x14 ^ x15 (two LSBs)
        out[i] = bit
        reg = (reg >> 1) | (bit << 14)
    return out


@functools.lru_cache()
def bb_scrambler_byte_mask(nbytes: int) -> np.ndarray:
    """The PRBS packed MSB-first into bytes: XOR with a BBFRAME payload
    (de)scrambles it. The reference precomputes the same byte table
    (bbframe_descramble.cpp:122-143). [nbytes] uint8."""
    bits = bb_scrambler_bits(nbytes * 8).reshape(nbytes, 8)
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=1).astype(np.uint8)


def bb_scramble_bytes(data: np.ndarray) -> np.ndarray:
    """XOR a packed-byte BBFRAME payload with the PRBS (involution).
    data: [..., nbytes] uint8."""
    return data ^ bb_scrambler_byte_mask(data.shape[-1])


# ---------------------------------------------------------------------------
# DVB-S energy dispersal (EN 300 421 sec. 4.4.1)
# ---------------------------------------------------------------------------

@functools.lru_cache()
def dvbs_dispersal_mask() -> np.ndarray:
    """PRBS byte mask for one 8-packet (8*188-byte) dispersal group.

    The PRBS (same 1+x^14+x^15, seed 100101010000000) restarts at every
    group. The first packet's sync byte is transmitted inverted (0xB8) and
    the PRBS is NOT applied to any sync byte, but it keeps running during
    the sync bytes of packets 2..8 (its first output bit coincides with the
    first bit after the inverted sync byte).  Returns mask[8*188] uint8 with
    zeros at the 8 sync-byte positions.
    """
    total = 8 * 188
    mask = np.zeros(total, np.uint8)
    reg = _BB_SEED
    # generate PRBS bits for 8*188-1 bytes (everything after the first sync)
    nbytes = total - 1
    bits = np.zeros(nbytes * 8, np.uint8)
    for i in range(nbytes * 8):
        bit = ((reg >> 1) ^ reg) & 1
        bits[i] = bit
        reg = (reg >> 1) | (bit << 14)
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    bytes_ = (bits.reshape(nbytes, 8) * weights).sum(axis=1).astype(np.uint8)
    mask[1:] = bytes_
    mask[::188] = 0  # never scramble sync bytes
    return mask


def dvbs_scramble_group(packets: np.ndarray) -> np.ndarray:
    """Energy-disperse one aligned group of 8 TS packets (involution except
    for the sync-byte inversion). packets: [8*188] uint8 with 0x47 syncs in;
    returns bytes as transmitted (first sync inverted to 0xB8)."""
    out = packets ^ dvbs_dispersal_mask()
    out = out.copy()
    out[0] = 0xB8
    return out


def dvbs_descramble_group(raw: np.ndarray) -> np.ndarray:
    """Inverse of dvbs_scramble_group: restores 8 TS packets with 0x47 syncs."""
    out = raw ^ dvbs_dispersal_mask()
    out = out.copy()
    out[0] = 0x47
    return out
