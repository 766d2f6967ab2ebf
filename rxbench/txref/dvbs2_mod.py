"""DVB-S2 golden modulator (numpy, host): TS bytes -> PLFRAME symbols.

Implements the full EN 302 307-1 TX chain as the loopback oracle for the
TPU receiver:

  TS packets -> mode adaptation (CRC-8 sync replacement, BBHEADER)
  -> BB scrambling -> BCH encode -> LDPC encode -> bit interleave
  -> constellation map -> PL framing (PLHEADER, optional pilot blocks)
  -> PL scrambling

Counterpart of the decode-direction components in the reference
(mode adaptation inverse: bbframe_ts_parser.cpp:174-208; pilots layout:
dvbs2_pll.cpp:34-86; PL scrambler applied from the first post-header
symbol including pilots).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from . import (modcod, bch_spec, ldpc_spec, interleaver, constellations,
               scrambling, plheader, bbheader)


def _crc8_187(data: np.ndarray, crc: int = 0) -> int:
    """CRC-8 (poly 0xAB reflected, as bbframe_ts_parser.check_crc8) over
    packet payload bytes, chained."""
    bits = np.unpackbits(data)
    for bit in bits:
        b = int(bit) ^ (crc & 1)
        crc >>= 1
        if b:
            crc ^= 0xAB
    return crc


@dataclasses.dataclass
class TSStreamState:
    """Mode-adaptation continuity across BBFRAMEs."""
    pending: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint8))
    abs_offset: int = 0   # absolute unit-stream position of pending[0]
    last_crc: int = 0x00


def ts_to_bbframes(ts_packets: np.ndarray, cfg: modcod.ModcodConfig,
                   state: TSStreamState | None = None) -> np.ndarray:
    """Mode adaptation + stream adaptation: pack 188-byte TS packets into
    BBFRAMEs of kbch bits (EN 302 307-1 sec. 5.1-5.2).

    Each packet's sync byte is replaced by the CRC-8 of the *previous*
    packet's 187 payload bytes. Data fields are filled completely
    (dfl = kbch-80, CCM single-stream); SYNCD points at the first CRC-8
    position in the data field. Returns [n_frames, kbch/8] uint8
    (BB-scrambled, ready for BCH).
    """
    if state is None:
        state = TSStreamState()
    pkts = ts_packets.reshape(-1, bbheader.TS_SIZE)
    assert np.all(pkts[:, 0] == bbheader.TS_SYNC)
    units = []
    crc = state.last_crc
    for p in pkts:
        u = p.copy()
        u[0] = crc
        crc = _crc8_187(p[1:])
        units.append(u)
    state.last_crc = crc
    stream = np.concatenate([state.pending] + units) if units else state.pending

    kbch = cfg.kbch
    dfl = kbch - 80
    df_bytes = dfl // 8
    n_frames = len(stream) // df_bytes
    frames = np.zeros((n_frames, kbch // 8), np.uint8)
    base = state.abs_offset
    for f in range(n_frames):
        df = stream[f * df_bytes:(f + 1) * df_bytes]
        # SYNCD: bit distance from DF start to the next unit boundary
        # (= position of a CRC-8 byte; bbframe_ts_parser.cpp:158-169)
        abs_start = base + f * df_bytes
        syncd_bytes = (-abs_start) % bbheader.TS_SIZE
        hdr = bbheader.BBHeader(dfl=dfl, syncd=syncd_bytes * 8)
        frames[f, :10] = hdr.pack()
        frames[f, 10:] = df
    state.pending = stream[n_frames * df_bytes:]
    state.abs_offset = base + n_frames * df_bytes
    return scrambling.bb_scramble_bytes(frames)


def bbframes_to_plframes(bbframes: np.ndarray, cfg: modcod.ModcodConfig
                         ) -> np.ndarray:
    """FEC encode + map + PL-frame each scrambled BBFRAME.
    bbframes [n, kbch/8] uint8 -> [n, plframe_len] complex64."""
    n = bbframes.shape[0]
    bits = np.unpackbits(bbframes, axis=1)
    out = np.empty((n, cfg.plframe_len), np.complex64)
    code = ldpc_spec.get_code(cfg.ldpc_table)
    for i in range(n):
        bch_code = bch_spec.encode(bits[i], cfg.framesize, cfg.rate)
        cw = code.encode(bch_code)
        stream = interleaver.interleave_bits(cw, cfg.constellation,
                                             cfg.framesize, cfg.rate)
        syms = constellations.bits_to_symbols(stream, cfg.constellation)
        payload = constellations.modulate(syms, cfg.constellation,
                                          cfg.g1, cfg.g2)
        out[i] = assemble_plframe(payload, cfg)
    return out


DUMMY_PLFRAME_LEN = 90 + 36 * 90      # EN 302 307-1 sec. 5.5.1


def dummy_plframe() -> np.ndarray:
    """Dummy PLFRAME (MODCOD 0): PLHEADER with PLS code 0 followed by
    36 slots of unmodulated carrier I = Q = 1/sqrt(2), PL-scrambled —
    real transponders insert these between data PLFRAMEs when idle.
    [3330] complex64."""
    frame = np.empty(DUMMY_PLFRAME_LEN, np.complex64)
    frame[:90] = plheader.plheader_symbols(0)
    frame[90:] = scrambling.pl_scramble(
        np.full(36 * 90, (1 + 1j) / np.sqrt(2), np.complex64))
    return frame


def interleave_dummies(plframes: np.ndarray, every: int,
                       n_dummies: int = 1) -> np.ndarray:
    """[n, L] data PLFRAMEs -> flat symbol stream with `n_dummies`
    dummy PLFRAMEs inserted after every `every` data frames."""
    dummy = dummy_plframe()
    out = []
    for i, f in enumerate(plframes):
        out.append(f)
        if (i + 1) % every == 0:
            out.extend([dummy] * n_dummies)
    return np.concatenate(out)


def pilot_symbol_positions(cfg: modcod.ModcodConfig) -> np.ndarray:
    """Start index (within the PLFRAME, incl. header) of each 36-symbol
    pilot block: after every 16 slots of payload (dvbs2_pll.cpp:48-68)."""
    if not cfg.pilots:
        return np.zeros(0, np.int64)
    return 90 + (np.arange(cfg.pilot_blocks) + 1) * (16 * 90) + \
        np.arange(cfg.pilot_blocks) * 36


def assemble_plframe(payload: np.ndarray, cfg: modcod.ModcodConfig
                     ) -> np.ndarray:
    """PLHEADER + payload with pilot insertion + PL scrambling."""
    assert len(payload) == cfg.payload_len
    frame = np.empty(cfg.plframe_len, np.complex64)
    frame[:90] = plheader.plheader_symbols(cfg.pls_code)
    pilot = np.full(36, (1 + 1j) / np.sqrt(2), np.complex64)
    pos = 90
    src = 0
    nblocks = cfg.pilot_blocks
    chunk = 16 * 90 if nblocks else cfg.payload_len
    for blk in range(nblocks + 1):
        take = min(chunk, cfg.payload_len - src)
        frame[pos:pos + take] = payload[src:src + take]
        pos += take
        src += take
        if blk < nblocks:
            frame[pos:pos + 36] = pilot
            pos += 36
    assert pos == cfg.plframe_len and src == cfg.payload_len
    # PL scrambling covers everything after the header (incl. pilots)
    frame[90:] = scrambling.pl_scramble(frame[90:])
    return frame


def modulate_ts(ts_packets: np.ndarray, cfg: modcod.ModcodConfig,
                state: TSStreamState | None = None) -> np.ndarray:
    """Full TX: TS bytes -> concatenated PLFRAME symbol stream."""
    bb = ts_to_bbframes(ts_packets, cfg, state)
    return bbframes_to_plframes(bb, cfg).reshape(-1)


def random_ts_packets(n: int, seed: int = 0) -> np.ndarray:
    """n TS packets with sync bytes and incrementing continuity info."""
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (n, bbheader.TS_SIZE)).astype(np.uint8)
    pkts[:, 0] = bbheader.TS_SYNC
    return pkts.reshape(-1)
