"""GSE mode-adaptation oracle: PDUs -> GSE packets -> BBFRAMEs.

TX counterpart of the RX GSE path (bbframe_ts_parser.cpp:212-384) for
loopback tests: encapsulates PDUs as GSE packets (optionally fragmented
with trailing CRC-32), packs them into generic-continuous BBFRAMEs.
"""
from __future__ import annotations

import numpy as np

from ..spec import bbheader, scrambling
from ..io.bbframe_parser import crc32_checksum
from .dvbs2_mod import TSStreamState  # noqa: F401  (API symmetry)


def gse_packet_unfrag(pdu: bytes, proto: int = 0x0800) -> bytes:
    """Single unfragmented GSE packet, no label (lt=0b11 broadcast)."""
    glen = len(pdu) + 2   # protocol field + pdu
    h1 = 0b11000000 | (0b11 << 4) | ((glen >> 8) & 0x0F)
    return bytes([h1, glen & 0xFF, (proto >> 8) & 0xFF, proto & 0xFF]) + pdu


def gse_packets_fragmented(pdu: bytes, frag_id: int, chunk: int,
                           proto: int = 0x0800) -> list[bytes]:
    """START/middle/END fragment chain with CRC-32 (no label)."""
    total = len(pdu) + 2  # protocol + pdu (total_len semantics)
    crc = 0xFFFFFFFF
    tl = bytes([(total >> 8) & 0xFF, total & 0xFF])
    pr = bytes([(proto >> 8) & 0xFF, proto & 0xFF])
    crc = crc32_checksum(np.frombuffer(tl, np.uint8), crc)
    crc = crc32_checksum(np.frombuffer(pr, np.uint8), crc)
    crc = crc32_checksum(np.frombuffer(pdu, np.uint8), crc)

    first, rest = pdu[:chunk], pdu[chunk:]
    glen = len(first) + 5   # fragid + total_len + proto
    h1 = 0b10000000 | (0b11 << 4) | ((glen >> 8) & 0x0F)
    pkts = [bytes([h1, glen & 0xFF, frag_id]) + tl + pr + first]
    while len(rest) > chunk:
        mid, rest = rest[:chunk], rest[chunk:]
        glen = len(mid) + 1
        h1 = (0b11 << 4) | ((glen >> 8) & 0x0F)
        pkts.append(bytes([h1, glen & 0xFF, frag_id]) + mid)
    tail = rest + crc.to_bytes(4, "big")
    glen = len(tail) + 1
    h1 = 0b01000000 | (0b11 << 4) | ((glen >> 8) & 0x0F)
    pkts.append(bytes([h1, glen & 0xFF, frag_id]) + tail)
    return pkts


def gse_to_bbframes(packets: list[bytes], kbch: int) -> np.ndarray:
    """Pack GSE packets into generic-continuous BBFRAMEs (one packet never
    splits across frames here — padding bytes fill the gap, signalled by a
    zero GSE header as the reference expects). Returns scrambled frames
    [n, kbch/8] uint8."""
    df_bytes = (kbch - 80) // 8
    # the last 2 data-field bytes are always left as padding so the SYNCD
    # resync target below is guaranteed to be a zero byte
    fill_limit = df_bytes - 2
    frames = []
    cur = bytearray()
    for p in packets:
        if len(p) > fill_limit:
            raise ValueError(f"GSE packet of {len(p)} bytes exceeds the "
                             f"{fill_limit}-byte usable data field; "
                             f"fragment it")
        if len(cur) + len(p) > fill_limit:
            cur.extend(b"\x00" * (df_bytes - len(cur)))
            frames.append(bytes(cur))
            cur = bytearray()
        cur.extend(p)
    if cur:
        cur.extend(b"\x00" * (df_bytes - len(cur)))
        frames.append(bytes(cur))
    out = np.zeros((len(frames), kbch // 8), np.uint8)
    # SYNCD points at the tail padding rather than the first packet: the
    # reference resync always enters a frame at syncd/8 + 1 bytes into the
    # data field (bbframe_ts_parser.cpp:158-169), so data-field byte 0 is
    # unreachable after sync loss. Aiming SYNCD at the padding makes the
    # resync frame parse as empty (on both parsers) and every later frame
    # parse losslessly from byte 0.
    syncd = kbch - 80 - 16
    for i, df in enumerate(frames):
        hdr = bbheader.BBHeader(ts_gs=bbheader.TS_GS_GENERIC_CONTINUOUS,
                                upl=0, dfl=kbch - 80, sync=0, syncd=syncd)
        out[i, :10] = hdr.pack()
        out[i, 10:] = np.frombuffer(df, np.uint8)
    return scrambling.bb_scramble_bytes(out)
