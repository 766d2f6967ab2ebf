"""ctypes bindings for the native host components (native/dvbs_native.cpp).

Loads native/libdvbs_native.so when present; callers fall back to the
pure-Python implementations otherwise (ts_deframer.py, bbframe_parser.py).
Build with `make -C native`.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_SO = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                   "libdvbs_native.so")
_lib = None


def available() -> bool:
    global _lib
    if _lib is None and os.path.exists(_SO):
        lib = ctypes.CDLL(_SO)
        lib.deframer_create.restype = ctypes.c_void_p
        lib.deframer_create.argtypes = [ctypes.c_int]
        lib.deframer_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("deframer_locked", "deframer_inverted"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("deframer_frames_ok", "deframer_sync_errors"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.deframer_feed.restype = ctypes.c_int
        lib.deframer_feed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.deframer_state_size.restype = ctypes.c_long
        lib.deframer_state_size.argtypes = [ctypes.c_void_p]
        lib.deframer_get_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.deframer_set_state.restype = ctypes.c_int
        lib.deframer_set_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.dvbstail_create.restype = ctypes.c_void_p
        lib.dvbstail_create.argtypes = [ctypes.c_int]
        lib.dvbstail_destroy.argtypes = [ctypes.c_void_p]
        lib.dvbstail_feed.restype = ctypes.c_long
        lib.dvbstail_feed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        for fn in ("dvbstail_frames", "dvbstail_groups_ok",
                   "dvbstail_rs_count", "dvbstail_sync_errors",
                   "dvbstail_frames_total", "dvbstail_pending"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.dvbstail_rs_avg.restype = ctypes.c_double
        lib.dvbstail_rs_avg.argtypes = [ctypes.c_void_p]
        lib.dvbstail_deframer.restype = ctypes.c_void_p
        lib.dvbstail_deframer.argtypes = [ctypes.c_void_p]
        lib.dvbstail_group_sync.restype = ctypes.c_int
        lib.dvbstail_group_sync.argtypes = [ctypes.c_void_p]
        lib.dvbstail_set_group_sync.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int]
        lib.dvbstail_get_fifos.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.dvbstail_set_fifos.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.dvbstail_get_fifo.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.dvbstail_set_fifo.restype = ctypes.c_int
        lib.dvbstail_set_fifo.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.tsparser_create.restype = ctypes.c_void_p
        lib.tsparser_create.argtypes = [ctypes.c_int]
        lib.tsparser_destroy.argtypes = [ctypes.c_void_p]
        lib.tsparser_bb_proc.restype = ctypes.c_long
        lib.tsparser_bb_proc.argtypes = [ctypes.c_void_p]
        lib.tsparser_feed.restype = ctypes.c_long
        lib.tsparser_feed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.tsparser_mark_gap.argtypes = [ctypes.c_void_p]
        lib.tsparser_sync_errors.restype = ctypes.c_long
        lib.tsparser_sync_errors.argtypes = [ctypes.c_void_p]
        lib.tsparser_last_header.restype = ctypes.c_int
        lib.tsparser_last_header.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.tsparser_state_size.restype = ctypes.c_long
        lib.tsparser_state_size.argtypes = [ctypes.c_void_p]
        lib.tsparser_get_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.tsparser_set_state.restype = ctypes.c_int
        lib.tsparser_set_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        globals()["_lib"] = lib
    return _lib is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeTSDeframer:
    """Drop-in for io.ts_deframer.TSDeframer (C++ implementation)."""

    def __init__(self, max_resync_errors: int = 4):
        assert available()
        self._h = _lib.deframer_create(max_resync_errors)

    def __del__(self):
        if getattr(self, "_h", None) and _lib is not None:
            _lib.deframer_destroy(self._h)
            self._h = None

    @property
    def locked(self):
        return bool(_lib.deframer_locked(self._h))

    @property
    def inverted(self):
        return bool(_lib.deframer_inverted(self._h))

    @property
    def frames_ok(self):
        return int(_lib.deframer_frames_ok(self._h))

    @property
    def sync_errors(self):
        return int(_lib.deframer_sync_errors(self._h))

    def feed(self, bits: np.ndarray) -> np.ndarray:
        bits = np.ascontiguousarray(bits, np.uint8)
        max_frames = len(bits) // (1632 * 8) + 3
        out = np.empty(max_frames * 1632, np.uint8)
        n = _lib.deframer_feed(self._h, _ptr(bits), len(bits), _ptr(out),
                               max_frames)
        return out[:n * 1632].reshape(n, 1632).copy()

    def get_state(self) -> bytes:
        """Serialized mutable state; interchangeable with the python
        TSDeframer's blob (same layout)."""
        n = _lib.deframer_state_size(self._h)
        buf = np.empty(n, np.uint8)
        _lib.deframer_get_state(self._h, _ptr(buf))
        return buf.tobytes()

    def set_state(self, blob: bytes):
        buf = np.frombuffer(blob, np.uint8).copy()
        rc = _lib.deframer_set_state(self._h, _ptr(buf), len(buf))
        if rc != 0:
            raise ValueError("corrupt deframer state blob")


class NativeDVBSTail:
    """DVB-S post-Viterbi host tail (C++): deframe -> Forney
    deinterleave -> RS(204,188) -> energy-dispersal descramble, one
    call per block. Mirrors DVBSReceiver._host_tail byte-for-byte
    (reference chain: dvbs_ts_deframer.cpp + dvbs_interleaving.h +
    dvbs_reedsolomon.h + the dispersal PRBS)."""

    _DEINT_SIZES = [(11 - j) * 17 for j in range(12)]

    def __init__(self, max_resync_errors: int = 4):
        assert available()
        self._h = _lib.dvbstail_create(max_resync_errors)

    def __del__(self):
        if getattr(self, "_h", None) and _lib is not None:
            _lib.dvbstail_destroy(self._h)
            self._h = None

    def feed(self, bits: np.ndarray) -> np.ndarray:
        """bits [n] uint8 (0/1 post-Viterbi) -> TS packets [P, 188]."""
        bits = np.ascontiguousarray(bits, np.uint8)
        pend = int(_lib.dvbstail_pending(self._h))
        cap = ((len(bits) // 8 + pend) // (8 * 204) + 2) * 1504
        out = np.empty(cap, np.uint8)
        w = _lib.dvbstail_feed(self._h, _ptr(bits), len(bits), _ptr(out),
                               cap)
        return out[:w].reshape(-1, 188).copy()

    # per-feed stats (same accounting as the python tail)
    @property
    def frames(self):
        return int(_lib.dvbstail_frames(self._h))

    @property
    def groups_ok(self):
        return int(_lib.dvbstail_groups_ok(self._h))

    @property
    def rs_avg_errors(self):
        return float(_lib.dvbstail_rs_avg(self._h))

    @property
    def rs_count(self):
        return int(_lib.dvbstail_rs_count(self._h))

    # cumulative deframer counters
    @property
    def sync_errors(self):
        return int(_lib.dvbstail_sync_errors(self._h))

    @property
    def frames_ok(self):
        return int(_lib.dvbstail_frames_total(self._h))

    # ---- checkpoint: the SAME dict fields as the pure-python receiver
    # (models/dvbs.DVBSReceiver.get_state) so blobs are interchangeable
    def get_state(self) -> dict:
        df = _lib.dvbstail_deframer(self._h)
        n = _lib.deframer_state_size(df)
        dblob = np.empty(n, np.uint8)
        _lib.deframer_get_state(df, _ptr(dblob))
        fifos = np.empty(sum(self._DEINT_SIZES), np.uint8)
        _lib.dvbstail_get_fifos(self._h, _ptr(fifos))
        pend = int(_lib.dvbstail_pending(self._h))
        fifo = np.empty(pend, np.uint8)
        if pend:
            _lib.dvbstail_get_fifo(self._h, _ptr(fifo))
        out, q = [], 0
        for d in self._DEINT_SIZES:
            out.append(fifos[q:q + d].copy())
            q += d
        return dict(deframer_state=dblob.tobytes(), deint_fifos=out,
                    deint_fifo=fifo,
                    group_sync=bool(_lib.dvbstail_group_sync(self._h)))

    def set_state(self, st: dict):
        df = _lib.dvbstail_deframer(self._h)
        blob = np.frombuffer(st["deframer_state"], np.uint8).copy()
        if _lib.deframer_set_state(df, _ptr(blob), len(blob)) != 0:
            raise ValueError("corrupt deframer state blob")
        fifos = np.ascontiguousarray(
            np.concatenate([np.asarray(f, np.uint8)
                            for f in st["deint_fifos"]]))
        if len(fifos) != sum(self._DEINT_SIZES):
            raise ValueError("bad deinterleaver fifo sizes")
        _lib.dvbstail_set_fifos(self._h, _ptr(fifos))
        fifo = np.ascontiguousarray(np.asarray(st["deint_fifo"], np.uint8))
        _lib.dvbstail_set_fifo(self._h, _ptr(fifo), len(fifo))
        _lib.dvbstail_set_group_sync(self._h, int(st["group_sync"]))


class NativeTSParser:
    """BBFRAME parser (C++): TS packets and GSE->GRE, both modes."""

    def __init__(self, kbch: int):
        assert available()
        self.kbch = kbch
        self._h = _lib.tsparser_create(kbch)

    def __del__(self):
        if getattr(self, "_h", None) and _lib is not None:
            _lib.tsparser_destroy(self._h)
            self._h = None

    @property
    def last_bb_proc(self):
        return int(_lib.tsparser_bb_proc(self._h))

    @property
    def sync_errors(self):
        """SYNCD-vs-reassembly-count mismatches (upstream splices)."""
        return int(_lib.tsparser_sync_errors(self._h))

    @property
    def last_header(self):
        """Latest validated BBHEADER (metrics), or None."""
        hdr = np.zeros(10, np.uint8)
        if not _lib.tsparser_last_header(self._h, _ptr(hdr)):
            return None
        from ..spec import bbheader
        return bbheader.BBHeader.parse(hdr)

    def get_state(self) -> bytes:
        """Serialized mutable parser state (checkpoint/resume)."""
        n = _lib.tsparser_state_size(self._h)
        buf = np.empty(n, np.uint8)
        _lib.tsparser_get_state(self._h, _ptr(buf))
        return buf.tobytes()

    def set_state(self, blob: bytes):
        buf = np.frombuffer(blob, np.uint8).copy()
        rc = _lib.tsparser_set_state(self._h, _ptr(buf), len(buf))
        if rc != 0:
            raise ValueError("corrupt TS-parser state blob")

    def mark_gap(self):
        _lib.tsparser_mark_gap(self._h)

    def feed(self, frames: np.ndarray) -> bytes:
        frames = np.ascontiguousarray(np.atleast_2d(frames), np.uint8)
        n = frames.shape[0]
        # GSE PDUs reassembled across earlier frames can emit up to
        # 3 slots x 64 KB beyond this call's data-field bytes
        cap = n * (self.kbch // 8 + 64) + 3 * (1 << 16) + 188
        out = np.empty(cap, np.uint8)
        w = _lib.tsparser_feed(self._h, _ptr(frames), n, _ptr(out), cap)
        return out[:w].tobytes()
