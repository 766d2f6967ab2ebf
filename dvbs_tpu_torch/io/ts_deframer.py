"""DVB-S TS deframer: bit-level sync on the 8x204-byte super-frame.

Vectorized replacement for the reference's bit-serial 1632-byte shifter
(reference src/demod/dvbs/dvbs_ts_deframer.cpp:37-92): the sync
correlation over every bit offset is computed with numpy stride tricks,
matching 0xB8,0x47x7 (normal) or its complement (inverted carrier) with
<= MAX_ERRS total bit errors across the 8 stride-204-byte sync bytes.
On an inverted match the whole frame is complemented (a 180-degree
carrier rotation complements the decoded stream because both CC
generator polynomials have odd weight).
"""
from __future__ import annotations

import numpy as np

FRAME_BYTES = 8 * 204           # 1632
FRAME_BITS = FRAME_BYTES * 8
MAX_ERRS = 8

_SYNCS = np.array([0xB8] + [0x47] * 7, np.uint8)


def _sync_bits() -> np.ndarray:
    return np.unpackbits(_SYNCS).astype(np.int8)


class TSDeframer:
    """Feed decoded bits (uint8 0/1); emits aligned 1632-byte frames."""

    def __init__(self, max_resync_errors: int = 4):
        self._bits = np.zeros(0, np.uint8)
        self.locked = False
        self.inverted = False
        self.bit_offset = 0
        self.frames_ok = 0
        self.sync_errors = 0
        self._bad_streak = 0
        self.max_resync_errors = max_resync_errors

    def get_state(self) -> bytes:
        """Serialized mutable state; same blob layout as the native
        deframer (native/dvbs_native.cpp deframer_get_state) so the two
        implementations are checkpoint-interchangeable."""
        import struct
        head = struct.pack("<BBiqqq", int(self.locked), int(self.inverted),
                           self._bad_streak, self.frames_ok,
                           self.sync_errors, len(self._bits))
        return head + self._bits.astype(np.uint8).tobytes()

    def set_state(self, blob: bytes):
        import struct
        hs = struct.calcsize("<BBiqqq")
        if len(blob) < hs:
            raise ValueError("corrupt deframer state blob")
        locked, inv, streak, fok, serr, nbits = struct.unpack(
            "<BBiqqq", blob[:hs])
        if len(blob) != hs + nbits:
            raise ValueError("corrupt deframer state blob")
        self.locked = bool(locked)
        self.inverted = bool(inv)
        self._bad_streak = streak
        self.frames_ok = fok
        self.sync_errors = serr
        self._bits = np.frombuffer(blob[hs:], np.uint8).copy()

    def _search(self, bits: np.ndarray) -> tuple[int, bool] | None:
        """Find a frame start in the first FRAME_BITS offsets."""
        if len(bits) < 2 * FRAME_BITS:
            return None
        # total sync-byte bit errors at every offset: 8 sync positions at
        # stride 204 bytes, each an 8-bit compare
        errs = np.zeros(FRAME_BITS, np.int32)
        errs_inv = np.zeros(FRAME_BITS, np.int32)
        for k in range(8):
            pos = k * 204 * 8
            w = np.lib.stride_tricks.sliding_window_view(
                bits[pos:pos + FRAME_BITS + 8], 8)[:FRAME_BITS]
            target = np.unpackbits(_SYNCS[k:k + 1])
            d = (w != target[None, :]).sum(1)
            errs += d
            errs_inv += 8 - d
        best = int(np.argmin(errs))
        best_inv = int(np.argmin(errs_inv))
        if errs[best] <= min(MAX_ERRS, errs_inv[best_inv]):
            return best, False
        if errs_inv[best_inv] <= MAX_ERRS:
            return best_inv, True
        return None

    def feed(self, bits: np.ndarray) -> np.ndarray:
        """Returns [n_frames, 1632] uint8 byte frames (sync bytes intact,
        complemented back on inverted carrier)."""
        self._bits = np.concatenate([self._bits, np.asarray(bits, np.uint8)])
        frames = []
        while True:
            if not self.locked:
                found = self._search(self._bits)
                if found is None:
                    # keep at most 2 frames of history for the next search
                    if len(self._bits) > 4 * FRAME_BITS:
                        self._bits = self._bits[-2 * FRAME_BITS:]
                    break
                off, inv = found
                self._bits = self._bits[off:]
                self.locked = True
                self.inverted = inv
                self._bad_streak = 0
            if len(self._bits) < FRAME_BITS:
                break
            fb = self._bits[:FRAME_BITS]
            by = np.packbits(fb)
            if self.inverted:
                by = by ^ np.uint8(0xFF)
            sync_err = int((np.unpackbits(by.reshape(8, 204)[:, 0]) !=
                            np.unpackbits(_SYNCS)).sum())
            if sync_err <= MAX_ERRS:
                frames.append(by)
                self.frames_ok += 1
                self._bad_streak = 0
                self._bits = self._bits[FRAME_BITS:]
            else:
                self.sync_errors += 1
                self._bad_streak += 1
                if self._bad_streak > self.max_resync_errors:
                    self.locked = False
                    self._bad_streak = 0
                    # drop one byte to force a fresh search window
                    self._bits = self._bits[8:]
                else:
                    frames.append(by)     # emit anyway; RS may still fix
                    self._bits = self._bits[FRAME_BITS:]
        return np.stack(frames) if frames else np.zeros((0, FRAME_BYTES),
                                                        np.uint8)
