"""Multi-carrier DVB-S2 streaming driver over the carrier bank.

PyTorch port of dvbs_tpu/models/bank_stream.py. The host logic is the
JAX version's, unchanged: per-carrier sample FIFOs with damped-advance
frame-boundary continuity, pipelined look-ahead dispatch, per-carrier
finalize (the frame decision of models/frames: quality gating, full-
budget LDPC escalation rerun, host BCH repair of flagged frames; TS/GSE
parse with mark_gap resync), bank-level
auto-MODCOD, and get_state/set_state checkpoints of the same format.
Only its two seams differ: `_upload` hands the step a tensor on the
bank's device, and each step's small outputs come to the host early:
`_dispatch` queues their non-blocking copies to the host (pinned by
PyTorch's caching host allocator, which holds each buffer until its
copy is done) and an event after them right after the step, before
anything else goes on the stream, so that `_finalize` of a block waits
for its own step and copies, not for the look-ahead step queued after
them (a look-ahead block is dispatched only where the FIFOs already
hold it, as when a caller feeds more than a block at once). On the
CPU the outputs are the host tensors themselves and there is no event.

Observability: `stats` (profiling.PipelineStats) counts blocks, frames,
TS bytes, LDPC sweeps, escalations, host BCH repairs, FIFO bytes copied
and bytes uploaded, each block's turn from its step's call to the end
of its finalize, the early fetches issued and those whose copies had
completed when their block's `_finalize` began (`fetches`,
`fetch_ready`), and the step's CUDA-graph captures, replays and eager
steps (the bank's `counts`, parallel/mesh.CarrierBank); its stages are
the spans below, each timed into `stats` and, while a profiler records,
a range of the trace:

    bank.feed       the whole of `feed`
    bank.fifo       FIFO append and trim, the stacking of a block
    bank.upload     `_upload`: packing and the host-to-device copy
    bank.step       the enqueue of one step (the range opens inside the
                    step, parallel/mesh.CarrierBank.forward)
    bank.prefetch   the copies of a step's small outputs to the host and
                    the event after them, queued right after the step
    bank.finalize   the whole of `_finalize`, and inside it
      bank.fetch      the wait on the block's event (its step and its
                      copies) and the host tensors' numpy views
      bank.escalate   the full-budget rerun and its fetch
      bank.bch_repair the host BCH of flagged frames
      bank.parse      gap marking and the TS parsers
      bank.vote       the PLS vote and the MODCOD-switch check
"""
from __future__ import annotations

import collections
import time

import numpy as np

import torch

from .. import backend
from ..profiling import PipelineStats, span
from ..spec import modcod
from ..ops import frontend
from . import frames
from .driver import make_bbframe_parser
from .dvbs2 import (EDGE_MARGIN, GUARD, frames_per_block,
                    look_ahead_advance)


# the step's outputs brought to the host: all but "llrs" and "hard",
# which stay on the device for the escalation and the BCH repair, and
# "freq" and "cfo", which the host does not read
FETCHED = ("kbch_bytes", "trials", "ldpc_ok", "bch_bad", "quality", "pls",
           "pls_conf", "starts")


class DVBS2BankStream:
    """Continuous N-carrier DVB-S2 demodulation, one device program."""

    def __init__(self, n_carriers: int, mc: int = 4, short: bool = False,
                 pilots: bool = False, block_symbols: int | None = None,
                 fec: str = "auto", ingest: str = "f16",
                 n_iters: int = 12, max_ldpc_trials: int = 32,
                 sof_threshold: float = 0.6, device=None, program=None,
                 auto_modcod: bool = True, on_modcod_switch=None,
                 vote_frames: int = frames.VOTE_FRAMES):
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
        self.stats = PipelineStats()
        self._configure(mc, short, pilots, block_symbols, program=program)
        self._fifos = [np.zeros(0, np.complex64) for _ in range(n_carriers)]
        self._expected_start = np.full(n_carriers, -1, np.int64)
        self._pending = None
        # rolling metrics (per carrier)
        self.frames_seen = np.zeros(n_carriers, np.int64)
        self.frames_ok = np.zeros(n_carriers, np.int64)
        self.ldpc_trials = np.zeros(n_carriers, np.int32)
        self.sync_quality = np.zeros(n_carriers, np.float32)
        self._inflight = collections.deque()    # (block, ns at its step)
        self._dispatched = 0                    # blocks stepped

    def _configure(self, mc, short, pilots, block_symbols=None,
                   program=None):
        """(Re)build the device program and the parsers for a MODCOD."""
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
        counts = getattr(self.step_fn, "counts", None)
        if counts is not None:
            self.stats.step_counts.append(counts)
        # geometry mirrors DVBS2Receiver (mesh builds the same core)
        self.edge_margin = EDGE_MARGIN
        self.F = frames_per_block(self.cfg, block_symbols)
        self._next_adv = np.full(self.C, 2 * self.F * self.cfg.plframe_len,
                                 np.int64)
        self._frames_total = self.F * self.C
        self.parsers = [make_bbframe_parser(self.cfg.kbch)
                        for _ in range(self.C)]

    def _reconfigure(self, pls_code: int):
        """Rebuild for `pls_code` at the bank's frame-lane scale, not the
        default 128-lane geometry."""
        from ..parallel.mesh import bank_block_symbols
        cfg = modcod.from_pls_code(pls_code)
        short = cfg.framesize == "short"
        self._configure(cfg.modcod, short, cfg.pilots,
                        block_symbols=bank_block_symbols(
                            self.C, mc=cfg.modcod, short=short,
                            pilots=cfg.pilots,
                            frames_total=self._frames_total))

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
        need = frames.supermajority(self._vote_n)
        if not all(len(v) >= self._vote_n and
                   (np.array(v) == top).sum() >= need
                   for v in self._votes):
            return False
        if int(top) >> 2 not in range(1, 29):
            return False
        try:
            self._reconfigure(int(top))
        except ValueError:
            return False
        for v in self._votes:
            v.clear()
        self.detected_pls[:] = -1
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
        with span("bank.upload", self.stats):
            if blocks.dtype == np.uint8:
                x = np.ascontiguousarray(blocks)
            elif self.ingest == "cs4":
                x = np.stack([frontend.pack_cs4(b) for b in blocks])
            else:
                ri = np.stack([blocks.real, blocks.imag], axis=1)
                rms = np.sqrt(np.mean(ri ** 2, axis=(1, 2),
                                      keepdims=True)) + 1e-30
                x = np.clip(np.round(ri * (24.0 / rms)), -127,
                            127).astype(np.int8)
            self.stats.upload_bytes += x.nbytes
            return torch.from_numpy(x).to(dev)

    def _have_block(self) -> bool:
        n = 2 * self.block_symbols
        return all(len(f) >= n for f in self._fifos)

    def _dispatch(self, starts=None):
        """Stack the block at `starts` (per carrier; the FIFO heads when
        None), upload it and enqueue its step; the block's turn starts
        at the step's call."""
        n = 2 * self.block_symbols
        with span("bank.fifo", self.stats):
            blocks = np.stack([f[a:a + n] for f, a in zip(
                self._fifos, [0] * self.C if starts is None else starts)])
            self.stats.fifo_bytes += blocks.nbytes
        x = self._upload(blocks)
        self._inflight.append((self._dispatched, time.perf_counter_ns()))
        self._dispatched += 1
        with self.stats.timer("bank.step"):
            out = self.step_fn(x)
        with span("bank.prefetch", self.stats):
            out["host"] = self._prefetch(out)
        return out

    def _prefetch(self, out: dict) -> tuple:
        """Queue the copies of a step's FETCHED outputs to the host and,
        for outputs on a card, an event after them on that device's
        current stream: (the host tensors, the event or None)."""
        host = {k: out[k].to("cpu", non_blocking=True) for k in FETCHED}
        dev = out[FETCHED[0]].device
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self.stats.fetches += 1
        return host, event

    # ------------------------------------------------------------------
    def feed(self, per_carrier) -> list[bytes]:
        """Feed 2-sps samples (list/array of C streams); returns the TS
        bytes produced per carrier this call. Pipelined like
        DVBS2Stream.feed: the look-ahead block dispatches with the
        predicted per-carrier advance before block i finalizes."""
        with span("bank.feed", self.stats):
            with span("bank.fifo", self.stats):
                for c in range(self.C):
                    part = np.asarray(per_carrier[c])
                    if part.dtype != np.uint8:  # pre-packed cs4 passthrough
                        part = part.astype(np.complex64)
                    if self._fifos[c].dtype != part.dtype:
                        if len(self._fifos[c]):
                            raise TypeError(
                                f"carrier {c}: feed dtype switched to "
                                f"{part.dtype} with {len(self._fifos[c])} "
                                f"{self._fifos[c].dtype} samples buffered — "
                                "concatenating would silently corrupt the "
                                "FIFO")
                        self._fifos[c] = np.zeros(0, part.dtype)
                    self._fifos[c] = np.concatenate([self._fifos[c], part])
                    self.stats.samples_in += len(part)
                    self.stats.fifo_bytes += self._fifos[c].nbytes
            outs = [bytearray() for _ in range(self.C)]
            while True:
                # re-read geometry every pass: an auto-MODCOD switch
                # changes block_symbols / frame length mid-stream
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
                    ahead = self._dispatch(self._next_adv)
                res = self._finalize(self._pending, outs)
                last_end = res["last_end"]           # [C] symbols
                if res.get("switched"):
                    # program/geometry changed: the look-ahead block (if
                    # any) was built by the stale program — discard it
                    # and re-dispatch from the trimmed FIFOs (_configure
                    # already reset _next_adv; _maybe_switch reset
                    # _expected_start)
                    with span("bank.fifo", self.stats):
                        self._trim(last_end, L, switched=True)
                    self._pending = None
                    self._inflight.clear()
                    continue
                with span("bank.fifo", self.stats):
                    if ahead is None:
                        self._trim(last_end, L, switched=False)
                    else:
                        for c in range(self.C):
                            adv = int(self._next_adv[c])
                            self._fifos[c] = self._fifos[c][adv:]
                            self._expected_start[c] = \
                                int(last_end[c]) - adv // 2
                            self._next_adv[c] = look_ahead_advance(
                                int(last_end[c]), F_L)
                self._pending = ahead
            return [bytes(o) for o in outs]

    def flush(self) -> list[bytes]:
        """Finalize any in-flight dispatched block without waiting for
        more samples (end of capture / before checkpointing)."""
        outs = [bytearray() for _ in range(self.C)]
        if self._pending is not None:
            L = self.cfg.plframe_len      # pre-switch frame length
            res = self._finalize(self._pending, outs)
            self._trim(res["last_end"], L, res.get("switched"))
            self._pending = None
        return [bytes(o) for o in outs]

    def _trim(self, last_end, L: int, switched: bool):
        """Trim each FIFO up to its block's last frame end less the edge
        margin and GUARD (at least L symbols) for a block read at the
        head: unless the MODCOD switched (which reset both), the advance
        back to F frames and the expected start where the frame ended."""
        for c in range(self.C):
            adv = 2 * max(int(last_end[c]) - self.edge_margin - GUARD, L)
            self._fifos[c] = self._fifos[c][adv:]
            if not switched:
                self._next_adv[c] = 2 * self.F * L
                self._expected_start[c] = int(last_end[c]) - adv // 2

    # ------------------------------------------------------------------
    def _finalize(self, dev, outs) -> dict:
        """Read one dispatched block's early fetch, escalate/repair,
        parse per carrier: DVBS2Receiver.finalize_block's frame decision
        (models/frames) over the bank's C x F lanes."""
        with span("bank.finalize", self.stats):
            res = self._finalize_block(dev, outs)
        block, t0 = self._inflight.popleft()
        self.stats.turn(block, time.perf_counter_ns() - t0)
        return res

    def _finalize_block(self, dev, outs) -> dict:
        st = self.stats
        cfg = self.cfg
        llrs, hard = dev["llrs"], dev["hard"]
        host, event = dev["host"]
        with span("bank.fetch", st):
            st.fetch_ready += event is None or event.query()
            if event is not None:
                event.synchronize()
            small = {k: t.numpy() for k, t in host.items()}
        C, F = self.C, self.F
        sync_ok = frames.gate(small["quality"].reshape(C * F),
                              self.sof_threshold)

        def rerun():
            with span("bank.escalate", st):
                st.escalations += 1
                return frames.to_host(self._escalate(llrs))
        retried, hard2 = frames.escalate(small, sync_ok, self.n_iters, rerun)
        with span("bank.bch_repair", st):
            frame_ok, kbch_bytes, corr = frames.bch_repair(
                cfg, sync_ok, small, lambda f: (
                    hard2 if retried[f] else hard)[f, :cfg.nbch].cpu().numpy())
            st.bch_repaired += int(np.count_nonzero(
                small["bch_bad"] & (corr >= 0)))
        trials = small["trials"]
        # per-carrier parse with gap marking (frame failures AND frame-
        # grid jumps — a relocated non-L-periodic frame decodes fine but
        # is not byte-contiguous with its predecessor, models/driver.py)
        fo = frame_ok.reshape(C, F)
        kb = kbch_bytes.reshape(C, F, -1)
        starts = small["starts"]                     # [C, F]
        pls = small["pls"].reshape(C, F)
        conf = small["pls_conf"].reshape(C, F)
        L = cfg.plframe_len

        def disc(c, prev_good, i):
            # a gap before good frame i: not continuous with the previous
            # good frame (else the slot before); the block's first frame
            # off the grid the last block predicted, modulo L
            if prev_good is not None or i > 0:
                p = i - 1 if prev_good is None else prev_good
                return not frames.continuous(
                    int(starts[c, i]) - int(starts[c, p]), L)
            if self._expected_start[c] < 0:
                return False
            dd = (int(starts[c, 0]) - int(self._expected_start[c])) % L
            for k in range(frames.MAX_DUMMIES + 1):
                diff = (dd - k * frames.DUMMY_LEN) % L
                if min(diff, L - diff) <= frames.FRAME_TOL:
                    return False
            return True

        ts_bytes = 0
        with span("bank.parse", st):
            for c in range(C):
                i = 0
                prev_good = None
                n0 = len(outs[c])
                while i < F:
                    if not fo[c, i]:
                        # detected dummy slots skip gap-free
                        if not frames.is_dummy(pls[c, i], conf[c, i]):
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
                ts_bytes += len(outs[c]) - n0
        self.frames_seen += F
        self.frames_ok += fo.sum(axis=1)
        self.ldpc_trials = trials.reshape(C, F).max(axis=1)
        self.sync_quality = small["quality"].mean(axis=1)
        st.block_done(0, frame_ok, trials, ts_bytes)   # samples: as fed
        # bank-level auto-MODCOD vote (confidence-gated, as the single-
        # carrier driver: off-SOF locator hits while misconfigured read
        # noise PLS — the soft-correlation confidence separates them)
        with span("bank.vote", st):
            for c in range(C):
                for i in range(F):
                    if frames.admits_vote(pls[c, i], conf[c, i]):
                        self._votes[c].append(int(pls[c, i]))
                if len(self._votes[c]) >= self._vote_n:
                    vals, counts = np.unique(np.array(self._votes[c]),
                                             return_counts=True)
                    self.detected_pls[c] = int(vals[counts.argmax()])
            switched = self._maybe_switch_modcod()
        return dict(last_end=starts[:, -1] + cfg.plframe_len,
                    switched=switched)

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
            self._reconfigure(st["pls_code"])   # as DVBS2Stream does
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
        self._inflight.clear()
