"""DVB-S2 BBHEADER build/parse + CRC-8 (EN 302 307-1 sec. 5.1.6).

Field layout and CRC convention match the reference's BBFrameTSParser
(reference src/demod/dvbs2/bbframe_ts_parser.h:37-65, .cpp:44-82):
MATYPE-1 (TS/GS<<6|SIS/MIS<<5|CCM/ACM<<4|ISSYI<<3|NPD<<2|RO), MATYPE-2
(ISI), UPL, DFL, SYNC, SYNCD, CRC-8 over the first 9 bytes with the
bit-serial reversed-0xAB polynomial.
"""
from __future__ import annotations

import dataclasses
import numpy as np

TS_SIZE = 188
TS_SYNC = 0x47

# TS/GS values
TS_GS_GENERIC_PACKETIZED = 0b00
TS_GS_GENERIC_CONTINUOUS = 0b01   # also GSE (bbframe_ts_parser.cpp:212)
TS_GS_RESERVED = 0b10
TS_GS_TRANSPORT = 0b11


@dataclasses.dataclass
class BBHeader:
    ts_gs: int = TS_GS_TRANSPORT
    sis_mis: bool = True          # True = single input stream
    ccm_acm: bool = True          # True = CCM
    issyi: bool = False
    npd: bool = False
    ro: int = 0                   # rolloff: 0=0.35, 1=0.25, 2=0.20
    isi: int = 0
    upl: int = TS_SIZE * 8
    dfl: int = 0
    sync: int = TS_SYNC
    syncd: int = 0

    def pack(self) -> np.ndarray:
        """10-byte BBHEADER incl. CRC-8. [10] uint8"""
        b = np.zeros(10, np.uint8)
        b[0] = ((self.ts_gs & 3) << 6 | int(self.sis_mis) << 5 |
                int(self.ccm_acm) << 4 | int(self.issyi) << 3 |
                int(self.npd) << 2 | (self.ro & 3))
        b[1] = self.isi if not self.sis_mis else 0
        b[2], b[3] = self.upl >> 8, self.upl & 0xFF
        b[4], b[5] = self.dfl >> 8, self.dfl & 0xFF
        b[6] = self.sync
        b[7], b[8] = self.syncd >> 8, self.syncd & 0xFF
        # find crc such that check_crc8(b)==0: bit-serial over 80 bits
        b[9] = _solve_crc(b[:9])
        return b

    @classmethod
    def parse(cls, b: np.ndarray) -> "BBHeader":
        return cls(
            ts_gs=int(b[0]) >> 6,
            sis_mis=bool((b[0] >> 5) & 1),
            ccm_acm=bool((b[0] >> 4) & 1),
            issyi=bool((b[0] >> 3) & 1),
            npd=bool((b[0] >> 2) & 1),
            ro=int(b[0]) & 3,
            isi=int(b[1]) if not ((b[0] >> 5) & 1) else 0,
            upl=int(b[2]) << 8 | int(b[3]),
            dfl=int(b[4]) << 8 | int(b[5]),
            sync=int(b[6]),
            syncd=int(b[7]) << 8 | int(b[8]),
        )


def _crc_run(bits) -> int:
    crc = 0
    for bit in bits:
        b = int(bit) ^ (crc & 1)
        crc >>= 1
        if b:
            crc ^= 0xAB
    return crc


def _solve_crc(hdr9: np.ndarray) -> int:
    """Find the CRC byte making the reference's 80-bit check return 0."""
    bits = np.unpackbits(hdr9)
    state = _crc_run(bits)
    # remaining 8 bits x must drive state to 0; solve bit by bit
    out_bits = []
    for _ in range(8):
        # choose bit so that fed bit (x ^ state&1) keeps us on track; the
        # final state is 0 iff every fed bit mirrors the LFSR output, i.e.
        # x = state&1 makes fed bit 0 -> state just shifts right.
        x = state & 1
        out_bits.append(x)
        state >>= 1
    assert state == 0
    weights = 1 << np.arange(7, -1, -1)
    return int((np.array(out_bits) * weights).sum())


def validate(header: BBHeader, kbch: int) -> bool:
    """Reference validity checks (bbframe_ts_parser.cpp:140-151)."""
    max_dfl = kbch - 80
    if header.dfl > max_dfl or header.syncd >= header.dfl - 8:
        return False
    if header.dfl % 8 != 0:
        return False
    return True


def bbheader_check(frame_bytes: np.ndarray) -> bool:
    """CRC-8 check over the 80-bit header as the reference does."""
    return _crc_run(np.unpackbits(frame_bytes[:10])) == 0
