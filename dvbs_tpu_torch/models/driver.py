"""Streaming driver: sample FIFO -> block receiver -> BBFRAME parser.

PyTorch port of dvbs_tpu/models/driver.py; the host logic is the JAX
version's. It feeds fixed-size blocks to the block receiver with one
block of look-ahead (the next block is enqueued on the device before
the current one is fetched), maintains frame-boundary continuity across
blocks, runs the BBFrame TS/GSE parser, aggregates the metric set of the
reference GUI and applies the 50-frame auto-MODCOD consistency vote
(main.cpp:375-408).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from .. import backend
from ..spec import modcod
from ..io.bbframe_parser import BBFrameParser
from ..io import native as _native
from ..profiling import PipelineStats
from .dvbs2 import DVBS2Receiver


def make_bbframe_parser(kbch: int):
    """Native C++ BBFrame TS/GSE parser when built (make -C native) —
    the reference's host tail is C++ (bbframe_ts_parser.cpp:104-388)
    and the python state machine cannot sustain the device rate —
    falling back to the pure-python implementation otherwise."""
    if _native.available():
        return _native.NativeTSParser(kbch)
    return BBFrameParser(kbch)


@dataclasses.dataclass
class Metrics:
    """Rolling metric set mirroring the reference GUI's fields."""
    pl_sync_best_match: float = 0.0
    ldpc_trials: int = 0
    bch_corrections: int = 0
    bch_quality: float = 100.0       # 100 - corrections*0.1 (main.cpp:468-476)
    detected_modcod: int = 0
    detected_shortframes: bool = False
    detected_pilots: bool = False
    frames_seen: int = 0
    frames_ok: int = 0
    bbframes_processed: int = 0
    bbframes_total: int = 0
    coarse_cfo: float = 0.0
    last_header: object = None    # bbheader.BBHeader of the latest BBFRAME
                                  # (MPEGTS/GSE, SIS/MIS, CCM/ACM, ISSY,
                                  # NPD, rolloff — main.cpp:495-500)


class DVBS2Stream:
    """Continuous DVB-S2 demodulation with auto-MODCOD support."""

    GUARD = 64

    def __init__(self, mc: int = 4, short: bool = False, pilots: bool = False,
                 block_symbols: int = 1 << 17, auto_modcod: bool = False,
                 max_ldpc_trials: int = 32, fec: str = "xla",
                 dummy_aware: bool = False, device=None):
        self.device = backend.resolve_device(device)
        self.auto_modcod = auto_modcod
        self.block_symbols = block_symbols
        self.max_ldpc_trials = max_ldpc_trials
        self.fec = fec
        self.dummy_aware = dummy_aware
        # called with the new ModcodConfig after a successful auto-MODCOD
        # switch — the CLI hooks this to persist the vote to Config, as
        # the reference persists after reconfigure (main.cpp:383-408)
        self.on_modcod_switch = None
        self._fifo = np.zeros(0, np.complex64)
        self._vote = collections.deque(maxlen=50)
        self.metrics = Metrics()
        self.stats = PipelineStats()
        self._configure(mc, short, pilots)

    def _configure(self, mc: int, short: bool, pilots: bool):
        self.rx = DVBS2Receiver(mc=mc, short=short, pilots=pilots,
                                block_symbols=self.block_symbols,
                                max_ldpc_trials=self.max_ldpc_trials,
                                fec=self.fec,
                                dummy_aware=self.dummy_aware,
                                device=self.device)
        self.cfg = self.rx.cfg
        self.parser = make_bbframe_parser(self.cfg.kbch)
        self._pending = None         # (rx, device outputs) of dispatched block
        self._next_adv = 2 * self.rx.n_frames * self.cfg.plframe_len
        self._expected_start = None  # next block's frame-grid phase (symbols)
        self._abs_base = 0           # absolute symbol position of block start
        self._last_fed_abs = None    # absolute start of last frame fed

    def feed(self, samples: np.ndarray) -> bytes:
        """Feed 2-sps samples; returns TS/GRE bytes produced.

        Pipelined: while block i's device outputs are fetched and
        host-processed (BCH repair, TS parse), block i+1 is already
        uploaded and enqueued on the device (the reference overlaps the
        same way with per-Processor threads, module_dvbs_demod.h:32-44).
        The look-ahead dispatch uses the steady-state advance (frame
        boundaries sit at the same in-block position every block); the
        measured boundary drift feeds back into the advance one block
        late, well within the locate window's margin.
        """
        self._fifo = np.concatenate([self._fifo,
                                     np.asarray(samples, np.complex64)])
        out = bytearray()
        n = 2 * self.block_symbols
        while True:
            if self._pending is None:
                if len(self._fifo) < n:
                    break
                with self.stats.clock.stage("dispatch"):
                    self._pending = (self.rx,
                                     self.rx.dispatch_block(self._fifo[:n]))
            adv = self._next_adv
            ahead = None
            if len(self._fifo) >= adv + n:
                with self.stats.clock.stage("dispatch"):
                    ahead = (self.rx,
                             self.rx.dispatch_block(self._fifo[adv:adv + n]))
            rx, dev = self._pending
            with self.stats.clock.stage("finalize"):
                res = rx.finalize_block(dev)
            with self.stats.clock.stage("parse"):
                blk = self._parse_frames(res)
            out.extend(blk)
            self.stats.block_done(n, res.frame_ok, res.ldpc_trials, len(blk))
            self._update_metrics(res)
            switched = self._maybe_switch_modcod(res)
            # dummy PLFRAMEs compress the data spacing: the steady
            # F-frames-per-block advance would overrun un-slotted data
            # frames at the seam. Advance only past the last NON-dummy
            # slot and re-center serially (drop the look-ahead — its
            # samples are still in the FIFO) whenever dummies appeared.
            okv = np.asarray(res.frame_ok)
            dummies = [self._is_dummy_slot(res, i) for i in range(len(okv))]
            nd = [i for i in range(len(okv)) if not dummies[i]]
            if res.starts is not None and nd:
                last_end = int(res.starts[nd[-1]]) + rx.cfg.plframe_len
            elif res.starts is not None and len(okv):
                # all slots were dummies: their pitch is DUMMY_LEN, not
                # L — advancing by slot+L would overrun the next data
                last_end = int(res.starts[-1]) + self.DUMMY_LEN
            else:
                last_end = int(res.last_frame_end)
            F_L = rx.n_frames * rx.cfg.plframe_len
            if switched or ahead is None or any(dummies):
                # serial tail: consume by the measured frame positions
                # (re-centers exactly); drop the look-ahead if its
                # config is stale — its samples are still in the FIFO.
                # Progress floor DUMMY_LEN (not L): an all-dummy block
                # may legitimately consume less than one data frame
                adv_actual = 2 * max(last_end - rx.edge_margin - self.GUARD,
                                     self.DUMMY_LEN)
                self._fifo = self._fifo[adv_actual:]
                self._pending = None
                self._next_adv = 2 * self.rx.n_frames * \
                    self.rx.cfg.plframe_len
                self._expected_start = None if switched \
                    else last_end - adv_actual // 2
                self._abs_base += adv_actual // 2
                if switched:
                    self._last_fed_abs = None
            else:
                self._fifo = self._fifo[adv:]
                self._pending = ahead
                self._expected_start = last_end - adv // 2
                self._abs_base += adv // 2
                # boundary drift of the retired block -> advance trim.
                # Gain 1/2 damps the one-block-delayed feedback loop
                # (d[i+1] = d[i] - g*d[i-1] + c has |roots| < 1 only for
                # g < 1; g = 1 is a marginally-stable oscillator)
                d0 = last_end - F_L            # == located starts[0]
                err = int(np.clip((d0 - (rx.edge_margin + self.GUARD)) // 2,
                                  -rx.edge_margin // 2, rx.edge_margin // 2))
                self._next_adv = 2 * (F_L + err)
        return bytes(out)

    def set_params(self, mc: int | None = None, short: bool | None = None,
                   pilots: bool | None = None):
        """Runtime MODCOD/framesize/pilots reconfiguration — the
        setDemodParams path of the reference (main.cpp:245-249,
        module_dvbs2_demod.cpp:118-168). Buffered samples are kept (the
        next block reacquires); any in-flight dispatched block is
        dropped, matching the reference's tempStop/tempStart handshake."""
        self._configure(mc if mc is not None else self.cfg.modcod,
                        short if short is not None
                        else self.cfg.framesize == "short",
                        pilots if pilots is not None else self.cfg.pilots)
        self._vote.clear()

    FRAME_TOL = 12      # symbols of start jitter before a gap is marked
    DUMMY_LEN = 90 + 36 * 90   # dummy PLFRAME (EN 302 307-1 sec. 5.5.1)
    MAX_DUMMIES = 3     # consecutive dummies absorbed without a gap

    def _is_dummy_slot(self, res, i: int) -> bool:
        """Frame slot i holds a detected dummy PLFRAME. The confidence
        bar is LOWER than the modcod vote's 0.7: in an all-dummy block
        no header matches the configured PLS code, the block-common
        freq estimate loses its anchor, and genuine dummies read at
        ~0.65-0.74 confidence."""
        if res.detected_pls is None:
            return False
        conf = (float(res.detected_pls_conf[i])
                if res.detected_pls_conf is not None else 1.0)
        return int(res.detected_pls[i]) >> 2 == 0 and conf >= 0.5


    def _parse_frames(self, res) -> bytes:
        """Feed the block's good BBFRAMEs to the TS/GSE parser, marking
        an explicit gap wherever a frame failed or the frame grid
        jumped (see BBFrameParser.mark_gap) so packet reassembly
        realigns at the next SYNCD instead of silently concatenating
        across the hole. Consecutive good continuous frames are fed as
        one batch (in the common all-good block that is a single native
        parser call)."""
        out = bytearray()
        ok = np.asarray(res.frame_ok)
        starts = res.starts
        L = self.cfg.plframe_len
        fi = 0
        i = 0
        while i < len(ok):
            a = None if starts is None else \
                self._abs_base + int(starts[i])
            if not ok[i]:
                # failed frames are absent from res.bbframes: fi stays.
                # A confidently-detected DUMMY PLFRAME (MODCOD 0) in the
                # slot is NOT a failure: it carries no data-field bytes,
                # so the stream stays contiguous across it — skip
                # without a gap (dummy_plframe in the TX oracle;
                # tests/test_dummy_frames.py). A failed slot that is a
                # re-decode of an already-fed frame (block overlap on a
                # non-L-periodic grid) is no loss either.
                if not self._is_dummy_slot(res, i) and \
                        (a is None or self._last_fed_abs is None
                         or a > self._last_fed_abs + L // 2):
                    self.parser.mark_gap()
                i += 1
                continue
            if a is not None and self._last_fed_abs is not None:
                d = a - self._last_fed_abs
                if d < L // 2:
                    # duplicate of an already-fed frame (the block
                    # advance re-covered it): skip silently
                    fi += 1
                    i += 1
                    continue
                if all(abs(d - L - k * self.DUMMY_LEN) > self.FRAME_TOL
                       for k in range(self.MAX_DUMMIES + 1)):
                    # not one-data-frame(+dummies) away: data was lost
                    # or the grid jumped — realign at the next SYNCD
                    self.parser.mark_gap()
            out.extend(self.parser.feed(res.bbframes[fi:fi + 1]))
            if a is not None:
                self._last_fed_abs = a
            fi += 1
            i += 1
        return bytes(out)

    def _update_metrics(self, res):
        m = self.metrics
        m.pl_sync_best_match = float(res.sync_quality.mean())
        m.ldpc_trials = int(res.ldpc_trials.max(initial=0))
        good = res.bch_corrections[res.bch_corrections >= 0]
        m.bch_corrections = int(good.max(initial=0))
        m.bch_quality = max(0.0, 100.0 - float(good.mean()) * 0.1) \
            if len(good) else 0.0
        m.frames_seen += len(res.frame_ok)
        m.frames_ok += int(res.frame_ok.sum())
        m.bbframes_total = len(res.frame_ok)
        m.bbframes_processed = int(res.frame_ok.sum())
        m.last_header = self.parser.last_header
        m.coarse_cfo = res.coarse_cfo
        if len(res.detected_pls):
            pls = int(np.bincount(res.detected_pls).argmax())
            m.detected_modcod = (pls >> 2) & 0x1F
            m.detected_shortframes = bool((pls >> 1) & 1)
            m.detected_pilots = bool(pls & 1)

    # -- loop-state checkpointing (SURVEY.md sec. 5: all mutable DSP state
    # is a small pytree; config + this dict give seamless restart) --------
    def get_state(self) -> dict:
        """Snapshot for seamless restart. An in-flight dispatched block
        (self._pending) is deliberately NOT captured: its samples are
        still at the head of the FIFO (feed() trims only after
        finalize), so restoring re-dispatches the same block — only its
        device compute is repeated, no data is lost."""
        return dict(pls_code=self.cfg.pls_code,
                    vote=list(self._vote),
                    fifo=self._fifo.copy(),
                    parser_state=self.parser.get_state(),
                    expected_start=self._expected_start,
                    abs_base=self._abs_base,
                    last_fed_abs=self._last_fed_abs)

    def set_state(self, st: dict):
        cfg = modcod.from_pls_code(st["pls_code"])
        self._configure(cfg.modcod, cfg.framesize == "short", cfg.pilots)
        self._vote = collections.deque(st["vote"], maxlen=50)
        self._fifo = st["fifo"].copy()
        self.parser.set_state(st["parser_state"])
        self._expected_start = st.get("expected_start")
        self._abs_base = st.get("abs_base", 0)
        self._last_fed_abs = st.get("last_fed_abs")

    def _maybe_switch_modcod(self, res) -> bool:
        """50-frame consistency vote (main.cpp:383-408). Returns True if
        the receiver was reconfigured (pipelined look-ahead is stale).

        Only confident detections vote: while misconfigured (wrong frame
        length), the locator lands off-SOF on some frames and their PLS
        reads are noise — the soft-correlation confidence separates them.
        """
        conf = res.detected_pls_conf if res.detected_pls_conf is not None \
            else np.ones(len(res.detected_pls))
        for pls, c in zip(res.detected_pls, conf):
            # dummy PLFRAMEs (MODCOD 0) are idle filler, not a signal
            # configuration — they must neither win nor dilute the vote
            if c >= 0.7 and int(pls) >> 2 != 0:
                self._vote.append(int(pls))
        if not self.auto_modcod or len(self._vote) < 50:
            return False
        # 90% supermajority (the reference requires strict unanimity over
        # every frame, main.cpp:383-395, but its per-frame re-correlation
        # never sees misaligned frames; our block locator does while the
        # configured frame length is wrong, so near-miss codewords occur)
        vals, counts = np.unique(np.array(self._vote), return_counts=True)
        top = int(vals[counts.argmax()])
        if counts.max() >= 45 and top != self.cfg.pls_code and \
                (top >> 2) in range(1, 29):
            mc, short, pilots = (top >> 2), bool(top & 2), bool(top & 1)
            try:
                self._configure(mc, short, pilots)
                self._vote.clear()
                if self.on_modcod_switch is not None:
                    self.on_modcod_switch(self.cfg)
                return True
            except ValueError:
                pass
        return False
