"""DVB-S receiver pieces that the multi-carrier bank needs.

Port of the parts of dvbs_tpu/models/dvbs.py (DVBSReceiver) that
parallel/dvbs_bank.DVBSBankStream runs: the deframer choice, the
rotation x depuncture-alignment lock search (`_try_lock`, its Viterbi
decode on the receiver's device through ops/viterbi.decode_segments),
and the host tail deframe -> Forney deinterleave -> RS(204,188) ->
energy-dispersal descramble, with its checkpoint fields in dvbs_tpu's
format. The tail is numpy, or the native C++ tail when that library is
built, exactly as in dvbs_tpu.

Not ported yet (ROADMAP queue 1): the receiver's own front end, the
locked chain, dispatch/fetch_locked, process_block and DVBSStream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io import native as _native
from ..io.ts_deframer import TSDeframer as _PyTSDeframer
from ..spec import dvbs_fec, rs_spec, scrambling
from .. import backend
from ..ops import viterbi

BER_THRESHOLD = 0.15
TEST_BITS = 2048


def TSDeframer():
    """Native C++ deframer when built (make -C native), python otherwise."""
    if _native.available():
        return _native.NativeTSDeframer()
    return _PyTSDeframer()


@dataclasses.dataclass
class DVBSBlockResult:
    ts_packets: np.ndarray        # [n, 188] uint8
    viterbi_ber: float
    viterbi_lock: bool
    detected_rate: str | None
    rs_avg_errors: float
    deframer_errors: int
    n_symbols: int
    constellation: np.ndarray | None = None
    frames: int = 0               # 1632-byte super-frames deframed this block
    groups_ok: int = 0            # dispersal groups with all 8 RS decodes ok


class DVBSReceiver:
    """Lock search and host tail of a DVB-S receiver (fixed or searched
    rate), with the lock search's Viterbi decode on `device`."""

    def __init__(self, rate: str | None = None,
                 block_symbols: int = 1 << 16,
                 native_tail: bool | None = None, device=None):
        self.block_symbols = block_symbols
        self.fixed_rate = rate
        self.locked = False
        self.rate: str | None = rate
        self.rotation = 0
        self.drop = 0
        self.ber = 1.0
        self.out_of_sync = 0
        self.device = backend.resolve_device(device)
        if native_tail is None:
            native_tail = _native.available()
        self.native_tail = bool(native_tail)
        self._reset_tail()
        # the locked chain's carried state: not run by the port yet, but
        # part of the checkpoint format dvbs_tpu writes and reads
        self._llr_carry = np.zeros(0, np.float32)
        self._hints = np.array([0, 0, 0, 0, 1], np.float32)
        self.last_consumed = 2 * block_symbols
        self.rs_avg_errors = 0.0

    def _reset_tail(self):
        if self.native_tail:
            self._ntail = _native.NativeDVBSTail()
        else:
            self._ntail = None
            self.deframer = TSDeframer()
            self.deinterleaver = dvbs_fec.ConvDeinterleaver()
            self._deint_fifo = np.zeros(0, np.uint8)
            self._group_sync = False

    @property
    def sync_errors(self) -> int:
        return (self._ntail.sync_errors if self._ntail is not None
                else self.deframer.sync_errors)

    @staticmethod
    def _rotate_serial(soft: np.ndarray, rot: int) -> np.ndarray:
        """Apply a 90-degree rotation hypothesis to serialized (I,Q) softs:
        z' = z * exp(-j*pi/2): I' = Q, Q' = -I."""
        if rot == 0:
            return soft
        pairs = soft.reshape(-1, 2)
        out = np.empty_like(pairs)
        out[:, 0] = pairs[:, 1]
        out[:, 1] = -pairs[:, 0]
        return out.reshape(-1)

    def _try_lock(self, soft: np.ndarray):
        """Batched hypothesis search over rate x rotation x alignment
        (reference viterbi_all.cpp:76-205): the hypotheses are built in
        numpy, decoded on the receiver's device, scored by re-encode BER
        on the host."""
        rates = [self.fixed_rate] if self.fixed_rate else dvbs_fec.RATES
        best = None
        for rate in rates:
            px, py = dvbs_fec.PUNCTURE[rate]
            p = len(px)
            n_kept = int(px.sum() + py.sum())
            drops = list(range(0, 2 * n_kept, 2))
            hyps = []
            keys = []
            need = TEST_BITS + 2 * n_kept
            for rot in (0, 1):
                s = self._rotate_serial(soft[:need + 64], rot)
                for d in drops:
                    dl = dvbs_fec.depuncture(s[d:d + TEST_BITS], rate, 0)
                    hyps.append(dl[:(TEST_BITS * 2 * p) // n_kept // 2])
                    keys.append((rot, d))
            L = min(len(h) for h in hyps)
            batch = np.stack([h[:L] for h in hyps]).astype(np.float32)
            bits = viterbi.decode_segments(
                torch.from_numpy(batch).to(self.device)).cpu().numpy()
            for (rot, d), hyp_bits, hyp_llr in zip(keys, bits, batch):
                re_xy = dvbs_fec.cc_encode(hyp_bits)
                mask = hyp_llr != 0
                hard_rx = (hyp_llr < 0).astype(np.uint8)
                n = mask.sum()
                ber = float((re_xy[mask] != hard_rx[mask]).sum()) / max(n, 1)
                if best is None or ber < best[0]:
                    best = (ber, rate, rot, d)
        if best and best[0] < BER_THRESHOLD:
            self.ber, self.rate, self.rotation, self.drop = best
            self.locked = True
            self.out_of_sync = 0
            self._llr_carry = np.zeros(0, np.float32)
            self._reset_tail()
        else:
            self.locked = False

    def _host_tail(self, bits: np.ndarray, constellation, n_symbols: int
                   ) -> DVBSBlockResult:
        """Pure host: deframe -> deinterleave -> RS -> descramble. One
        C++ call when the native library is built, numpy otherwise."""
        if self._ntail is not None:
            nt = self._ntail
            ts = nt.feed(bits)
            self.rs_avg_errors = nt.rs_avg_errors
            return DVBSBlockResult(ts, self.ber, self.locked, self.rate,
                                   self.rs_avg_errors, nt.sync_errors,
                                   n_symbols, constellation=constellation,
                                   frames=nt.frames, groups_ok=nt.groups_ok)
        frames = self.deframer.feed(bits)
        pkts = []
        rs_errs = []
        groups_ok = 0
        for frame in frames:
            # the Forney deinterleaver delays every byte by 11*17 cycles
            # (2244 bytes = 3 packets), so dispersal-group alignment is
            # re-established on its output stream
            self._deint_fifo = np.concatenate(
                [self._deint_fifo, self.deinterleaver.process(frame)])
        while len(self._deint_fifo) >= 204:
            if not self._group_sync:
                syncs = self._deint_fifo[:len(self._deint_fifo) // 204 * 204:204]
                hits = np.nonzero(syncs == 0xB8)[0]
                if len(hits) == 0:
                    keep = (len(self._deint_fifo) // 204 - 1) * 204
                    self._deint_fifo = self._deint_fifo[max(keep, 0):]
                    break
                self._deint_fifo = self._deint_fifo[hits[0] * 204:]
                self._group_sync = True
            if len(self._deint_fifo) < 8 * 204:
                break
            grp_in = self._deint_fifo[:8 * 204]
            if grp_in[0] != 0xB8:
                self._group_sync = False
                continue
            self._deint_fifo = self._deint_fifo[8 * 204:]
            group = np.empty(8 * 188, np.uint8)
            grp_clean = True
            for k in range(8):
                fixed, nerr = rs_spec.decode(grp_in[k * 204:(k + 1) * 204])
                rs_errs.append(max(nerr, 0) if nerr >= 0 else 8)
                grp_clean = grp_clean and nerr >= 0
                group[k * 188:(k + 1) * 188] = fixed[:188]
            groups_ok += int(grp_clean)
            group = scrambling.dvbs_descramble_group(group)
            pkts.append(group.reshape(8, 188))
        self.rs_avg_errors = float(np.mean(rs_errs)) if rs_errs else 0.0
        ts = np.concatenate(pkts) if pkts else np.zeros((0, 188), np.uint8)
        return DVBSBlockResult(ts, self.ber, self.locked, self.rate,
                               self.rs_avg_errors, self.deframer.sync_errors,
                               n_symbols, constellation=constellation,
                               frames=int(len(frames)), groups_ok=groups_ok)

    # checkpoint: dvbs_tpu's DVBSReceiver fields, one format for both
    # tails, so a blob written by either package restores into the other
    def get_state(self) -> dict:
        if self._ntail is not None:
            tail = self._ntail.get_state()
        else:
            tail = dict(
                deframer_state=self.deframer.get_state(),
                deint_fifos=[f.copy() for f in self.deinterleaver.fifos],
                deint_fifo=self._deint_fifo.copy(),
                group_sync=self._group_sync)
        return dict(locked=self.locked, rate=self.rate,
                    rotation=self.rotation, drop=self.drop, ber=self.ber,
                    out_of_sync=self.out_of_sync,
                    hints=self._hints.copy(),
                    llr_carry=self._llr_carry.copy(),
                    rs_avg_errors=self.rs_avg_errors,
                    last_consumed=self.last_consumed, **tail)

    def set_state(self, st: dict):
        self.locked = bool(st["locked"])
        self.rate = st["rate"]
        self.rotation = int(st["rotation"])
        self.drop = int(st["drop"])
        self.ber = float(st["ber"])
        self.out_of_sync = int(st["out_of_sync"])
        self._hints = np.asarray(st["hints"], np.float32).copy()
        self._llr_carry = np.asarray(st["llr_carry"], np.float32).copy()
        self._reset_tail()
        if self._ntail is not None:
            self._ntail.set_state(st)
        else:
            self.deframer.set_state(st["deframer_state"])
            self.deinterleaver.fifos = [np.asarray(f, np.uint8).copy()
                                        for f in st["deint_fifos"]]
            self._deint_fifo = np.asarray(st["deint_fifo"], np.uint8).copy()
            self._group_sync = bool(st["group_sync"])
        self.rs_avg_errors = float(st["rs_avg_errors"])
        self.last_consumed = int(st["last_consumed"])
