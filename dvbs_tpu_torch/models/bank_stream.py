"""Multi-carrier DVB-S2 streaming driver over the carrier bank.

PyTorch port of dvbs_tpu/models/bank_stream.py. The host logic is the
JAX version's, unchanged: per-carrier sample FIFOs with damped-advance
frame-boundary continuity, pipelined look-ahead dispatch, per-carrier
finalize (full-budget LDPC escalation rerun, host BCH repair of flagged
frames, quality gating, TS/GSE parse with mark_gap resync), bank-level
auto-MODCOD, and get_state/set_state checkpoints of the same format.
Only its two seams differ: `_upload` hands the step a tensor on the
bank's device, and `_finalize` fetches with `.cpu()`.
"""
from __future__ import annotations

import collections

import numpy as np

import torch

from .. import backend
from ..spec import modcod, scrambling, bch_spec
from ..ops import frontend
from .driver import make_bbframe_parser


class DVBS2BankStream:
    """Continuous N-carrier DVB-S2 demodulation, one device program."""

    GUARD = 64

    def __init__(self, n_carriers: int, mc: int = 4, short: bool = False,
                 pilots: bool = False, block_symbols: int | None = None,
                 fec: str = "auto", ingest: str = "f16",
                 n_iters: int = 12, max_ldpc_trials: int = 32,
                 sof_threshold: float = 0.6, device=None, program=None,
                 auto_modcod: bool = True, on_modcod_switch=None,
                 vote_frames: int = 50):
        self.C = n_carriers
        self.sof_threshold = sof_threshold
        self.ingest = ingest
        self.n_iters = n_iters
        self._build_opts = dict(
            fec=fec, n_iters=n_iters, max_ldpc_trials=max_ldpc_trials,
            device=backend.resolve_device(device))
        self.auto_modcod = auto_modcod
        self.on_modcod_switch = on_modcod_switch
        # per-carrier confidence-gated PLS vote (reference main.cpp:383-
        # 408 per instance); detected_pls[c] = current top vote or -1
        self._vote_n = vote_frames
        self._votes = [collections.deque(maxlen=vote_frames)
                       for _ in range(n_carriers)]
        self.detected_pls = np.full(n_carriers, -1, np.int64)
        self._configure(mc, short, pilots, block_symbols, program=program)
        self.parsers = [make_bbframe_parser(self.cfg.kbch)
                        for _ in range(n_carriers)]
        self._fifos = [np.zeros(0, np.complex64) for _ in range(n_carriers)]
        self._expected_start = np.full(n_carriers, -1, np.int64)
        self._pending = None
        # rolling metrics (per carrier)
        self.frames_seen = np.zeros(n_carriers, np.int64)
        self.frames_ok = np.zeros(n_carriers, np.int64)
        self.ldpc_trials = np.zeros(n_carriers, np.int32)
        self.sync_quality = np.zeros(n_carriers, np.float32)

    def _configure(self, mc, short, pilots, block_symbols=None,
                   program=None):
        """(Re)build the device program for a MODCOD. Used by __init__
        and by the bank-level auto-MODCOD switch."""
        from ..parallel.mesh import build_carrier_bank, bank_block_symbols
        if block_symbols is None:
            block_symbols = bank_block_symbols(self.C, mc=mc, short=short,
                                               pilots=pilots)
        self.cfg = modcod.get_config(mc, short=short, pilots=pilots)
        self.block_symbols = block_symbols
        if program is not None:
            # share an already-built (compiled) bank program between
            # streams of identical geometry (bench reuses one program
            # for the TS and GSE quality gates)
            self.step_fn, self._example, self._escalate = program
        else:
            self.step_fn, self._example, self._escalate = build_carrier_bank(
                self.C, mc=mc, short=short, pilots=pilots,
                block_symbols=block_symbols,
                n_iters=self._build_opts["n_iters"],
                fec=self._build_opts["fec"],
                ingest="cs4" if self.ingest == "cs4" else "cs8",
                device=self._build_opts["device"],
                stream_outputs=True,
                n_iters_full=self._build_opts["max_ldpc_trials"])
        # geometry mirrors DVBS2Receiver (mesh builds the same core)
        L = self.cfg.plframe_len
        self.edge_margin = 256
        self.F = (block_symbols - 2 * self.edge_margin - 90) // L - 1
        self._next_adv = np.full(self.C, 2 * self.F * L, np.int64)
        # an auto-MODCOD rebuild keeps the bank's frame-lane scale
        # rather than re-deriving the default 128-lane geometry
        self._frames_total = self.F * self.C

    def _maybe_switch_modcod(self) -> bool:
        """Bank-level MODCOD switch: every carrier must reach a 45/50
        supermajority on the SAME new PLS code (the bank shares one
        program; a lone divergent carrier is surfaced via detected_pls
        instead — split it into its own DVBS2Stream)."""
        if not self.auto_modcod:
            return False
        tops = self.detected_pls
        top = tops[0]
        if top < 0 or (tops != top).any() or top == self.cfg.pls_code:
            return False
        need = int(0.9 * self._vote_n + 0.5)
        if not all(len(v) >= self._vote_n and
                   (np.array(v) == top).sum() >= need
                   for v in self._votes):
            return False
        mc = int(top) >> 2
        if mc not in range(1, 29):
            return False
        from ..parallel.mesh import bank_block_symbols
        try:
            short, pilots = bool(top & 2), bool(top & 1)
            self._configure(mc, short, pilots,
                            block_symbols=bank_block_symbols(
                                self.C, mc=mc, short=short, pilots=pilots,
                                frames_total=self._frames_total))
        except ValueError:
            return False
        for v in self._votes:
            v.clear()
        self.detected_pls[:] = -1
        self.parsers = [make_bbframe_parser(self.cfg.kbch)
                        for _ in range(self.C)]
        self._expected_start[:] = -1
        if self.on_modcod_switch is not None:
            self.on_modcod_switch(self.cfg)
        return True

    @property
    def program(self):
        """(step_fn, example, escalate_fn) — pass as `program=` to build
        another stream of identical geometry without recompiling."""
        return self.step_fn, self._example, self._escalate

    # ------------------------------------------------------------------
    def _upload(self, blocks: np.ndarray):
        """blocks [C, n] complex64 -> device input in the bank's ingest
        format (cs4 packs on host; cs8 quantizes at 4.5 bits rms).
        Pre-packed cs4 feeds (uint8 FIFOs, 1 byte = 1 sample) pass
        through untouched. Returns a tensor on the bank's device, or on
        the step's `input_device` where it names one (a sharded step
        takes the host block and each rank uploads its own carriers)."""
        dev = getattr(self.step_fn, "input_device",
                      self._build_opts["device"])
        if blocks.dtype == np.uint8:
            return torch.from_numpy(np.ascontiguousarray(blocks)).to(dev)
        if self.ingest == "cs4":
            packed = np.stack([frontend.pack_cs4(b) for b in blocks])
            return torch.from_numpy(packed).to(dev)
        ri = np.stack([blocks.real, blocks.imag], axis=1)
        rms = np.sqrt(np.mean(ri ** 2, axis=(1, 2), keepdims=True)) + 1e-30
        i8 = np.clip(np.round(ri * (24.0 / rms)), -127, 127).astype(np.int8)
        return torch.from_numpy(i8).to(dev)

    def _have_block(self) -> bool:
        n = 2 * self.block_symbols
        return all(len(f) >= n for f in self._fifos)

    def _dispatch(self):
        n = 2 * self.block_symbols
        blocks = np.stack([f[:n] for f in self._fifos])
        return self.step_fn(self._upload(blocks))

    # ------------------------------------------------------------------
    def feed(self, per_carrier) -> list[bytes]:
        """Feed 2-sps samples (list/array of C streams); returns the TS
        bytes produced per carrier this call. Pipelined like
        DVBS2Stream.feed: the look-ahead block dispatches with the
        predicted per-carrier advance before block i finalizes."""
        for c in range(self.C):
            part = np.asarray(per_carrier[c])
            if part.dtype != np.uint8:          # pre-packed cs4 passthrough
                part = part.astype(np.complex64)
            if self._fifos[c].dtype != part.dtype:
                if len(self._fifos[c]):
                    raise TypeError(
                        f"carrier {c}: feed dtype switched to "
                        f"{part.dtype} with {len(self._fifos[c])} "
                        f"{self._fifos[c].dtype} samples buffered — "
                        "concatenating would silently corrupt the FIFO")
                self._fifos[c] = np.zeros(0, part.dtype)
            self._fifos[c] = np.concatenate([self._fifos[c], part])
        outs = [bytearray() for _ in range(self.C)]
        while True:
            # re-read geometry every pass: an auto-MODCOD switch changes
            # block_symbols / frame length mid-stream
            n = 2 * self.block_symbols
            L = self.cfg.plframe_len
            F_L = self.F * L
            if self._pending is None:
                if not self._have_block():
                    break
                self._pending = self._dispatch()
            # look-ahead dispatch at the predicted advance
            ahead = None
            if all(len(self._fifos[c]) >= self._next_adv[c] + n
                   for c in range(self.C)):
                blocks = np.stack([self._fifos[c][self._next_adv[c]:
                                                  self._next_adv[c] + n]
                                   for c in range(self.C)])
                ahead = self.step_fn(self._upload(blocks))
            res = self._finalize(self._pending, outs)
            last_end = res["last_end"]           # [C] symbols
            if res.get("switched"):
                # program/geometry changed: the look-ahead block (if
                # any) was built by the stale program — discard it and
                # re-dispatch from the trimmed FIFOs (_configure already
                # reset _next_adv; _maybe_switch reset _expected_start)
                for c in range(self.C):
                    adv = 2 * max(int(last_end[c]) - self.edge_margin -
                                  self.GUARD, L)
                    self._fifos[c] = self._fifos[c][adv:]
                self._pending = None
                continue
            if ahead is None:
                for c in range(self.C):
                    adv = 2 * max(int(last_end[c]) - self.edge_margin -
                                  self.GUARD, L)
                    self._fifos[c] = self._fifos[c][adv:]
                    self._next_adv[c] = 2 * F_L
                    self._expected_start[c] = int(last_end[c]) - adv // 2
                self._pending = None
            else:
                for c in range(self.C):
                    adv = int(self._next_adv[c])
                    self._fifos[c] = self._fifos[c][adv:]
                    self._expected_start[c] = int(last_end[c]) - adv // 2
                    # damped one-block-late advance feedback (gain 1/2,
                    # models/driver.py:136-145)
                    d0 = int(last_end[c]) - F_L
                    err = int(np.clip(
                        (d0 - (self.edge_margin + self.GUARD)) // 2,
                        -self.edge_margin // 2, self.edge_margin // 2))
                    self._next_adv[c] = 2 * (F_L + err)
                self._pending = ahead
        return [bytes(o) for o in outs]

    def flush(self) -> list[bytes]:
        """Finalize any in-flight dispatched block without waiting for
        more samples (end of capture / before checkpointing)."""
        outs = [bytearray() for _ in range(self.C)]
        if self._pending is not None:
            L = self.cfg.plframe_len      # pre-switch frame length
            res = self._finalize(self._pending, outs)
            last_end = res["last_end"]
            for c in range(self.C):
                adv = 2 * max(int(last_end[c]) - self.edge_margin -
                              self.GUARD, L)
                self._fifos[c] = self._fifos[c][adv:]
                if not res.get("switched"):
                    self._next_adv[c] = 2 * self.F * L
                    self._expected_start[c] = int(last_end[c]) - adv // 2
            self._pending = None
        return [bytes(o) for o in outs]

    # ------------------------------------------------------------------
    def _finalize(self, dev, outs) -> dict:
        """Fetch one dispatched block, escalate/repair, parse per
        carrier. Mirrors DVBS2Receiver.finalize_block lane-batched."""
        cfg = self.cfg
        llrs = dev.pop("llrs")
        hard_dev = dev.pop("hard")
        small = {k: v.cpu().numpy() for k, v in dev.items() if k != "freq"}
        C, F = self.C, self.F
        quality = small["quality"].reshape(C * F)
        ldpc_ok = small["ldpc_ok"]
        bch_bad = small["bch_bad"]
        kbch_bytes = np.array(small["kbch_bytes"])
        trials = small["trials"]
        sync_ok = quality >= self.sof_threshold
        retried = np.zeros(C * F, bool)
        hard2_dev = None
        retry = (~ldpc_ok) & sync_ok
        if retry.any():
            out2 = self._escalate(llrs)
            hard2_dev = out2.pop("hard")
            out2 = {k: v.cpu().numpy() for k, v in out2.items()}
            for k in ("ldpc_ok", "bch_bad", "kbch_bytes"):
                small[k] = np.where(
                    retry.reshape((-1,) + (1,) * (small[k].ndim - 1)),
                    out2[k], small[k])
            ldpc_ok, bch_bad = small["ldpc_ok"], small["bch_bad"]
            kbch_bytes = np.array(small["kbch_bytes"])
            trials = np.where(retry, self.n_iters + out2["trials"], trials)
            retried = retry
        frame_ok = sync_ok & ~bch_bad
        for lane in np.nonzero(sync_ok & bch_bad)[0]:
            hd = hard2_dev if retried[lane] else hard_dev
            bits = hd[lane, :cfg.nbch].cpu().numpy()
            fixed, ncorr = bch_spec.decode(bits, cfg.framesize, cfg.rate)
            if ncorr < 0:
                continue    # BCH-inconsistent = corrupt (see dvbs2.py)
            frame_ok[lane] = True
            kbch_bytes[lane] = scrambling.bb_scramble_bytes(
                np.packbits(fixed[:cfg.kbch]))
        # per-carrier parse with gap marking (frame failures AND frame-
        # grid jumps — a relocated non-L-periodic frame decodes fine but
        # is not byte-contiguous with its predecessor, models/driver.py)
        fo = frame_ok.reshape(C, F)
        kb = kbch_bytes.reshape(C, F, -1)
        starts = small["starts"]                     # [C, F]
        plsb = small["pls"].reshape(C, F)
        confb = small["pls_conf"].reshape(C, F)
        L = cfg.plframe_len
        TOL = 12
        DUMMY = 90 + 36 * 90    # dummy PLFRAME length (driver.DUMMY_LEN)
        MAXD = 3

        def dummy_deltas_ok(d):
            return any(abs(d - L - k * DUMMY) <= TOL
                       for k in range(MAXD + 1))

        def disc0(c):
            if self._expected_start[c] < 0:
                return False
            dd = (int(starts[c, 0]) - int(self._expected_start[c])) % L
            for k in range(MAXD + 1):
                diff = (dd - k * DUMMY) % L
                if min(diff, L - diff) <= TOL:
                    return False
            return True

        def disc(c, prev_good, i):
            # continuity vs the previous GOOD frame: exactly one data
            # frame + k dummy PLFRAMEs between (dummies carry no data
            # bytes — no gap; models/driver.py:_good_discontinuous)
            if prev_good is None:
                return disc0(c) if i == 0 else not dummy_deltas_ok(
                    int(starts[c, i]) - int(starts[c, i - 1]))
            return not dummy_deltas_ok(
                int(starts[c, i]) - int(starts[c, prev_good]))

        for c in range(C):
            i = 0
            prev_good = None
            while i < F:
                if not fo[c, i]:
                    # detected dummy slots skip gap-free (conf bar 0.5:
                    # all-dummy blocks lose the freq anchor, driver.py)
                    if not (int(plsb[c, i]) >> 2 == 0
                            and confb[c, i] >= 0.5):
                        self.parsers[c].mark_gap()
                    i += 1
                    continue
                if disc(c, prev_good, i):
                    self.parsers[c].mark_gap()
                j = i + 1
                last = i
                while j < F and fo[c, j] and not disc(c, last, j):
                    last = j
                    j += 1
                outs[c].extend(self.parsers[c].feed(
                    np.ascontiguousarray(kb[c, i:j])))
                prev_good = j - 1
                i = j
        self.frames_seen += F
        self.frames_ok += fo.sum(axis=1)
        self.ldpc_trials = trials.reshape(C, F).max(axis=1)
        self.sync_quality = small["quality"].mean(axis=1)
        # bank-level auto-MODCOD vote (confidence-gated, as the single-
        # carrier driver: off-SOF locator hits while misconfigured read
        # noise PLS — the soft-correlation confidence separates them)
        pls = small["pls"].reshape(C, F)
        conf = small["pls_conf"].reshape(C, F)
        for c in range(C):
            for i in range(F):
                # dummy PLFRAMEs (MODCOD 0) neither win nor dilute votes
                if conf[c, i] >= 0.7 and int(pls[c, i]) >> 2 != 0:
                    self._votes[c].append(int(pls[c, i]))
            if len(self._votes[c]) >= self._vote_n:
                vals, counts = np.unique(np.array(self._votes[c]),
                                         return_counts=True)
                self.detected_pls[c] = int(vals[counts.argmax()])
        return dict(last_end=starts[:, -1] + cfg.plframe_len,
                    switched=self._maybe_switch_modcod())

    # ------------------------------------------------------------------
    # checkpoint/resume (SURVEY.md sec. 5): feed() leaves no in-flight
    # block behind only when the FIFO drains; an in-flight dispatched
    # block's samples are still at the FIFO heads (feed trims after
    # finalize), so like DVBS2Stream we simply don't capture it —
    # restore re-dispatches the same samples.
    def get_state(self) -> dict:
        return dict(pls_code=self.cfg.pls_code,
                    fifos=[f.copy() for f in self._fifos],
                    next_adv=self._next_adv.copy(),
                    expected_start=self._expected_start.copy(),
                    parser_state=[p.get_state() for p in self.parsers],
                    frames_seen=self.frames_seen.copy(),
                    frames_ok=self.frames_ok.copy(),
                    votes=[list(v) for v in self._votes])

    def set_state(self, st: dict):
        if st["pls_code"] != self.cfg.pls_code:
            # checkpoint taken after an auto-MODCOD switch: rebuild the
            # program for the checkpointed MODCOD (as DVBS2Stream does),
            # keeping this bank's frame-lane scale
            from ..parallel.mesh import bank_block_symbols
            cfg = modcod.from_pls_code(st["pls_code"])
            short = cfg.framesize == "short"
            self._configure(cfg.modcod, short, cfg.pilots,
                            block_symbols=bank_block_symbols(
                                self.C, mc=cfg.modcod, short=short,
                                pilots=cfg.pilots,
                                frames_total=self._frames_total))
            self.parsers = [make_bbframe_parser(self.cfg.kbch)
                            for _ in range(self.C)]
        self._votes = [collections.deque(v, maxlen=self._vote_n)
                       for v in st.get("votes",
                                       [[] for _ in range(self.C)])]
        self.detected_pls = np.full(self.C, -1, np.int64)
        self._fifos = [np.asarray(f).copy() for f in st["fifos"]]
        self._next_adv = np.asarray(st["next_adv"], np.int64).copy()
        self._expected_start = np.asarray(
            st.get("expected_start", np.full(self.C, -1)), np.int64).copy()
        for p, ps in zip(self.parsers, st["parser_state"]):
            p.set_state(ps)
        self.frames_seen = np.asarray(st["frames_seen"]).copy()
        self.frames_ok = np.asarray(st["frames_ok"]).copy()
        self._pending = None
