"""BBFRAME -> TS / GSE->GRE parser (host byte-level state machine).

Behavioral equivalent of the reference's BBFrameTSParser
(reference src/demod/dvbs2/bbframe_ts_parser.cpp:104-388):
- BBHEADER CRC-8 gate, DFL/SYNCD validation, SYNCD-based resync
- TS mode (ts_gs=0b11): 188-byte reassembly across frame boundaries,
  0x47 sync byte re-inserted over the per-packet CRC-8 slot
- GSE mode (ts_gs=0b01): GSE header parse, up to 3 concurrent fragment
  reassemblies with CRC-32 check, each PDU wrapped in a minimal GRE
  header (protocol 0x0800/0x86DD)

A C++ implementation with the same tests lives in native/ (used when
built); this is the reference/pure-Python path.
"""
from __future__ import annotations

import functools
import numpy as np

from ..spec import bbheader

TS_SIZE = 188
TS_SYNC = 0x47


@functools.lru_cache()
def _crc32_table():
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        k = 0
        j = (i << 24) | 0x800000
        while j != 0x80000000:
            k = ((k << 1) & 0xFFFFFFFF) ^ (0x04C11DB7 if ((k ^ j) & 0x80000000) else 0)
            j = (j << 1) & 0xFFFFFFFF
        tab[i] = k
    return tab


def crc32_checksum(buf: np.ndarray, crc: int) -> int:
    tab = _crc32_table()
    for b in np.asarray(buf, np.uint8):
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[((crc >> 24) ^ int(b)) & 0xFF])
    return crc


class BBFrameParser:
    """Stateful parser; feed kbch-bit BBFRAMEs, collect output bytes."""

    def __init__(self, kbch: int):
        self.kbch = kbch
        self.max_dfl = kbch - 80
        self.synched = False
        self.count = 0
        self.partial = np.zeros(TS_SIZE, np.uint8)
        # GSE reassembly slots
        self.gse_active = [False] * 3
        self.gse_id = [0] * 3
        self.gse_proto = [0] * 3
        self.gse_buf = [bytearray() for _ in range(3)]
        self.gse_crc = [0] * 3
        # metrics (sec. 3.5 of SURVEY)
        self.last_header: bbheader.BBHeader | None = None
        self.last_bb_cnt = 0
        self.last_bb_proc = 0
        self.last_gse_crc_err = False
        self.sync_errors = 0          # SYNCD-vs-count mismatches seen

    def get_state(self) -> dict:
        """Opaque mutable-state snapshot (checkpoint/resume); same API
        as NativeTSParser.get_state (different encoding)."""
        return dict(synched=self.synched, count=self.count,
                    partial=self.partial.copy(),
                    gse_active=list(self.gse_active),
                    gse_id=list(self.gse_id),
                    gse_proto=list(self.gse_proto),
                    gse_buf=[bytes(b) for b in self.gse_buf],
                    gse_crc=list(self.gse_crc),
                    last_header=self.last_header,
                    sync_errors=self.sync_errors)

    def set_state(self, st: dict):
        self.synched = st["synched"]
        self.count = st["count"]
        self.partial = st["partial"].copy()
        self.gse_active = list(st["gse_active"])
        self.gse_id = list(st["gse_id"])
        self.gse_proto = list(st["gse_proto"])
        self.gse_buf = [bytearray(b) for b in st["gse_buf"]]
        self.gse_crc = list(st["gse_crc"])
        self.last_header = st["last_header"]
        self.sync_errors = int(st.get("sync_errors", 0))

    def mark_gap(self):
        """Signal that one or more BBFRAMEs were lost upstream (LDPC/BCH
        failure or stream discontinuity): drop partial reassembly and
        realign at the next frame's SYNCD.

        The reference has no such signal — every frame, corrupt or not,
        reaches its parser, and corrupt headers fail the CRC-8 gate
        which sets synched=false (bbframe_ts_parser.cpp:129-131). Here
        unconverged frames are withheld, so the gap must be explicit or
        packet reassembly would silently misalign forever."""
        self.synched = False
        self.count = 0
        # drop partial GSE reassembly: a continuation after the gap
        # would append to a buffer with missing bytes (CRC-32 can never
        # pass) and a new PDU reusing the frag id would concatenate
        self.gse_active = [False] * 3
        self.gse_buf = [bytearray() for _ in range(3)]

    def feed(self, frames: np.ndarray) -> bytes:
        """frames: [n, kbch/8] uint8 plaintext BBFRAMEs. Returns output
        byte stream (TS packets or GRE-encapsulated PDUs)."""
        out = bytearray()
        frames = np.atleast_2d(frames)
        bbproc = 0
        for frame in frames:
            if not bbheader.bbheader_check(frame):
                self.synched = False
                continue
            hdr = bbheader.BBHeader.parse(frame)
            if not bbheader.validate(hdr, self.kbch):
                self.synched = False
                continue
            df = frame[10:10 + hdr.dfl // 8]
            self.last_header = hdr
            bbproc += 1
            # SYNCD resync happens before the mode dispatch, exactly as the
            # reference does (bbframe_ts_parser.cpp:158-169): the first
            # frame after sync loss is entered at syncd/8 + 1 bytes into
            # the data field (the +1 skips the CRC-8 byte that replaces the
            # TS sync byte; the reference applies it to GSE frames too).
            pos = 0
            # SYNCD consistency: while synched in TS mode, the frame's
            # SYNCD must agree with the reassembly count
            # (syncd/8 == (187 - count) mod 188). A mismatch means the
            # byte stream jumped upstream of us (splice, source restart)
            # even though every frame decoded — free-running on would
            # shift EVERY following packet. The reference free-runs
            # (bbframe_ts_parser.cpp:193 disables its check); we resync
            # and count it, losing at most this frame's packets.
            if self.synched and hdr.ts_gs == bbheader.TS_GS_TRANSPORT and \
                    hdr.syncd // 8 != (187 - self.count) % 188:
                self.synched = False
                self.sync_errors += 1
            if not self.synched:
                pos = hdr.syncd // 8 + 1
                if pos > len(df):
                    continue
                self.count = 0
                self.synched = True
            if hdr.ts_gs == bbheader.TS_GS_TRANSPORT:
                self._feed_ts(df, hdr, out, pos)
            elif hdr.ts_gs == bbheader.TS_GS_GENERIC_CONTINUOUS:
                self._feed_gse(df, hdr, out, pos)
            # 0b00 (generic packetized) / 0b10 (reserved): ignored, as the
            # reference does (bbframe_ts_parser.cpp:209-211)
        self.last_bb_cnt = len(frames)
        self.last_bb_proc = bbproc
        return bytes(out)

    # -- TS mode -------------------------------------------------------
    def _feed_ts(self, df: np.ndarray, hdr: bbheader.BBHeader,
                 out: bytearray, pos: int = 0):
        remaining = len(df) - pos
        if self.count > 0:
            take = min(TS_SIZE - self.count, remaining)
            self.partial[self.count:self.count + take] = df[pos:pos + take]
            self.count += take
            pos += take
            if self.count == TS_SIZE:
                out.append(TS_SYNC)
                out.extend(self.partial[:TS_SIZE - 1].tobytes())
                self.count = 0
        n_whole = (len(df) - pos) // TS_SIZE
        for _ in range(n_whole):
            out.append(TS_SYNC)
            out.extend(df[pos:pos + TS_SIZE - 1].tobytes())
            pos += TS_SIZE
        tail = len(df) - pos
        if tail > 0:
            self.partial[:tail] = df[pos:]
            self.count = tail

    # -- GSE mode ------------------------------------------------------
    def _feed_gse(self, df: np.ndarray, hdr: bbheader.BBHeader,
                  out: bytearray, p: int = 0):
        if hdr.issyi or hdr.npd or hdr.upl != 0:
            return
        dfl_bytes = hdr.dfl // 8
        while p < dfl_bytes - 1:
            h1, h2 = int(df[p]), int(df[p + 1])
            start = (h1 >> 7) & 1
            end = (h1 >> 6) & 1
            lt = (h1 >> 4) & 0b11
            if not start and not end and lt == 0:
                break   # padding: leave the frame
            glen = ((h1 & 0x0F) << 8) | h2
            if start and end:
                # unfragmented PDU
                if p + 4 > dfl_bytes:
                    break
                proto = (int(df[p + 2]) << 8) | int(df[p + 3])
                glen -= 2
                ds = 4
                if lt == 0b00:
                    ds += 6
                    glen -= 6
                elif lt == 0b10:
                    ds += 3
                    glen -= 3
                if glen < 0 or p + ds + glen > dfl_bytes:
                    break
                self._emit_gre(out, proto, df[p + ds:p + ds + glen])
                p += ds + glen
            elif start:
                if p + 7 > dfl_bytes:
                    break       # truncated start-fragment header
                frag = int(df[p + 2])
                proto = (int(df[p + 5]) << 8) | int(df[p + 6])
                glen -= 5
                ds = 7
                maclen = 6 if lt == 0b00 else (3 if lt == 0b10 else 0)
                mac = df[p + ds:p + ds + maclen]
                ds += maclen
                glen -= maclen
                if glen < 0 or p + ds + glen > dfl_bytes:
                    break
                for rid in range(3):
                    if not self.gse_active[rid] or self.gse_id[rid] == frag:
                        self.gse_active[rid] = True
                        self.gse_id[rid] = frag
                        self.gse_proto[rid] = proto
                        self.gse_buf[rid] = bytearray(
                            df[p + ds:p + ds + glen].tobytes())
                        crc = 0xFFFFFFFF
                        crc = crc32_checksum(df[p + 3:p + 5], crc)
                        crc = crc32_checksum(df[p + 5:p + 7], crc)
                        if maclen:
                            crc = crc32_checksum(mac, crc)
                        crc = crc32_checksum(df[p + ds:p + ds + glen], crc)
                        self.gse_crc[rid] = crc
                        break
                p += ds + glen
            elif end:
                if p + 3 > dfl_bytes:
                    break       # truncated end-fragment header
                frag = int(df[p + 2])
                glen -= 1
                ds = 3
                if glen < 4 or p + ds + glen > dfl_bytes:
                    break
                for rid in range(3):
                    if self.gse_active[rid] and self.gse_id[rid] == frag:
                        self.gse_active[rid] = False
                        data = df[p + ds:p + ds + glen - 4]
                        self.gse_buf[rid].extend(data.tobytes())
                        crc = crc32_checksum(data, self.gse_crc[rid])
                        rx_crc = int.from_bytes(
                            df[p + ds + glen - 4:p + ds + glen].tobytes(),
                            "big")
                        if crc != rx_crc:
                            self.last_gse_crc_err = True
                        else:
                            self.last_gse_crc_err = False
                            self._emit_gre(out, self.gse_proto[rid],
                                           np.frombuffer(
                                               bytes(self.gse_buf[rid]),
                                               np.uint8))
                        break
                p += ds + glen
            else:
                # middle fragment
                if p + 3 > dfl_bytes:
                    break       # truncated continuation header
                frag = int(df[p + 2])
                glen -= 1
                ds = 3
                if glen < 0 or p + ds + glen > dfl_bytes:
                    break
                for rid in range(3):
                    if self.gse_active[rid] and self.gse_id[rid] == frag:
                        data = df[p + ds:p + ds + glen]
                        self.gse_buf[rid].extend(data.tobytes())
                        self.gse_crc[rid] = crc32_checksum(
                            data, self.gse_crc[rid])
                        break
                p += ds + glen

    @staticmethod
    def _emit_gre(out: bytearray, proto: int, payload: np.ndarray):
        """Minimal GRE header (bbframe_ts_parser.cpp:259-268)."""
        out.extend(b"\x00\x00")
        out.append((proto >> 8) & 0xFF)
        out.append(proto & 0xFF)
        out.extend(np.asarray(payload, np.uint8).tobytes())
