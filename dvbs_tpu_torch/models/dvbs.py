"""DVB-S receiver: feed-forward front end + auto-locking Viterbi chain.

PyTorch port of dvbs_tpu/models/dvbs.py:

  samples (2 sps) -> AGC -> coarse CFO -> matched RRC
  -> feed-forward timing (kernel B) -> V&V carrier track (mod 90 deg)
  -> [lock search: rotation x depuncture-alignment hypotheses, batched
      Viterbi decode + re-encode BER, threshold 0.15]
  -> depuncture -> overlapped segments -> Viterbi (kernel C) -> bits
  -> [host] TS deframer -> conv deinterleave -> RS(204,188)
  -> energy-dispersal descramble -> TS packets

The host logic is dvbs_tpu's, unchanged: the lock search, the hint
carry and its fold of whole-sample timing drift into the FIFO advance,
the 20-strike watchdog, the host tail (numpy, or the native C++ tail
when that library is built) and get_state/set_state in the same format.
The device side is an nn.Module per step: the front end (`ReceiverFront`,
also the base of the bank's front) and the locked chain (`LockedChain`),
which enqueues everything from the samples to the packed bits without a
synchronise. The JAX version's float16 transport is not ported: samples
and soft values stay float32 on the device.

Also here, shared with parallel/dvbs_bank.py: the depuncture, segment,
decode and re-encode-BER steps of a locked chain (`depuncture_decode`,
`reencode_ber`, `pack_bits`).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..profiling import span
from ..io import native as _native
from ..io.ts_deframer import TSDeframer as _PyTSDeframer
from ..spec import dvbs_fec, rs_spec, scrambling
from .. import backend, tables
from ..ops import frontend, plphase, viterbi, viterbi_kernel

BER_THRESHOLD = 0.15
TEST_BITS = 2048
CORE, WING = 2048, 96           # the receiver's Viterbi segments
N_SCATTER = 1024                # constellation points returned per block


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
    constellation: np.ndarray | None = None   # [1024] complex64 scatter
    frames: int = 0               # 1632-byte super-frames deframed this block
    groups_ok: int = 0            # dispersal groups with all 8 RS decodes ok


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

class FrontEnd(nn.Module):
    """The DVB-S sample-domain front end on `device`, batched over
    carriers: its tables (RRC, Oerder-Meyr interpolator, Farrow
    resampler) and the chain both front ends run (`symbols`)."""

    def __init__(self, device):
        super().__init__()
        np_tables = tables.dvbs_front_tables()
        self.farrow_band = tuple(float(v)
                                 for v in np_tables.pop("farrow_band"))
        for k, v in tables.to_torch(np_tables, device).items():
            if k in ("fir_rrc", "fir_mid"):
                v = frontend.bf16_round(v)      # the bf16 matmul's operand
            self.register_buffer(k, v, persistent=False)

    def symbols(self, x: torch.Tensor, hints: torch.Tensor,
                tau_eval: int | None):
        """x complex64 [C, n] at 2 sps, hints [C, >=5] ([cfo, nco_phase,
        tau, theta, first, ...]; first=1 takes fresh coarse-CFO, timing
        and phase estimates) -> (zc [C, n/2] phase-corrected symbols,
        cfo, nco_phase, tau at sample tau_eval (None: the block end),
        f4 the residual frequency, ph the V&V phase [C, n/2])."""
        first = hints[:, 4] > 0.5
        with span("frontend"):
            x = frontend.agc(x)
            cfo = torch.where(first, frontend.coarse_cfo_estimate(x),
                              hints[:, 0])
            nco_phase = torch.where(first, torch.zeros_like(hints[:, 1]),
                                    hints[:, 1])
            x = frontend.mix(x, cfo, nco_phase)
            y = frontend.matched_filter(x, self.rrc_taps, self.fir_rrc)
        with span("timing"):
            tau_hint = torch.where(first, torch.full_like(hints[:, 2],
                                                          math.nan),
                                   hints[:, 2])
            z, _, tau_next = frontend.recover_symbols_full(
                y, self.mid_taps, self.fir_mid, self.farrow_coef,
                self.farrow_band, n_windows=16, tau_hint=tau_hint,
                tau_eval=tau_eval)
        with span("carrier"):
            S = z.shape[-1]
            f4 = frontend.qpsk_residual_freq(z)
            ks = torch.arange(S, dtype=torch.int32, device=z.device)
            z = plphase.derotate(z, f4[:, None] * ks)
            theta0 = torch.where(first, torch.zeros_like(hints[:, 3]),
                                 hints[:, 3])
            ph = plphase.qpsk_vv_track(z, theta0)
            zc = plphase.derotate(z, ph)
        return zc, cfo, nco_phase, tau_next, f4, ph


class ReceiverFront(FrontEnd):
    """The single-carrier receiver's front end (DVBSReceiver._build_front):
    x complex64 [C, n] + hints [C, 5] [cfo, nco_phase, tau, theta, first]
    -> (soft [C, n] float32 serialized (I, Q), new_hints [C, 5] for the
    block that starts where this one ends, scatter [C, 2, 1024] re/im of
    the first corrected symbols)."""

    def forward(self, x: torch.Tensor, hints: torch.Tensor):
        zc, cfo, nco_phase, tau_end, f4, ph = self.symbols(x, hints, None)
        with span("carrier"):
            C, S = zc.shape
            soft = torch.view_as_real(zc).reshape(C, 2 * S)
            new_hints = torch.stack([
                cfo, torch.remainder(nco_phase + cfo * x.shape[-1],
                                     2 * math.pi),
                tau_end, f4 * S + ph[:, -1], torch.zeros_like(cfo)], dim=1)
            scat = torch.stack([zc.real[:, :N_SCATTER],
                                zc.imag[:, :N_SCATTER]], dim=1)
        return soft, new_hints, scat


def depuncture_decode(used: torch.Tensor, pat_idx: torch.Tensor, p: int,
                      core: int, wing: int, decode_segments):
    """The locked chain's Viterbi stage for C carriers of one code rate:
    kept soft values used [C, periods * n_kept] (n_kept = len(pat_idx)
    per puncture period of p pairs) -> (bits [C, n_pairs] uint8, the
    segment cores, and dl [C, n_pairs, 2] the depunctured LLRs, zero at
    the punctured places). The pairs are cut into [C * B, core + 2 wing,
    2] overlapping segments (zero-padded at the stream's edges) for one
    decode_segments call."""
    C = used.shape[0]
    n_kept = pat_idx.shape[0]
    periods = used.shape[1] // n_kept
    n_pairs = periods * p
    B = -(-n_pairs // core)
    T = core + 2 * wing
    dl = used.new_zeros((C, periods, 2 * p))
    dl[:, :, pat_idx] = used.reshape(C, periods, n_kept)   # static columns
    dl = dl.reshape(C, n_pairs, 2)
    padded = used.new_zeros((C, B * core + 2 * wing, 2))
    padded[:, wing:wing + n_pairs] = dl
    # [C * B, T, 2] overlapping windows, copied out (a view when C = 1)
    segs = padded.unfold(1, T, core).transpose(2, 3).reshape(C * B, T, 2) \
        .contiguous()
    bits = decode_segments(segs).reshape(C, B, T)[:, :, wing:wing + core] \
        .reshape(C, -1)[:, :n_pairs]
    return bits, dl


def reencode_ber(bits: torch.Tensor, dl: torch.Tensor, lo: int,
                 TB: int) -> torch.Tensor:
    """Re-encode BER [C] float32 over pairs [lo, lo + TB), erasures
    excluded (the SYNCED watchdog, viterbi_all.cpp:209-273): the decoded
    bits [C, n] re-encoded (the 6 bits before `lo` as the encoder's
    state, zeros before the stream) against the hard decisions of dl
    [C, n, 2]."""
    C = bits.shape[0]
    bp = torch.nn.functional.pad(bits, (6, 0))[:, lo:lo + 6 + TB] \
        .to(torch.int32)

    def enc(poly):
        acc = torch.zeros((C, TB), dtype=torch.int32, device=bits.device)
        for j in range(7):
            if (poly >> j) & 1:
                acc = acc + bp[:, j:j + TB]
        return acc % 2
    exy = torch.stack([enc(dvbs_fec.G1), enc(dvbs_fec.G2)], dim=2)
    chunk = dl[:, lo:lo + TB]
    maskz = chunk != 0
    hard = (chunk < 0).to(torch.int32)
    nm = maskz.sum(dim=(1, 2))
    errs = (maskz & (exy != hard)).sum(dim=(1, 2))
    return (errs / torch.clamp(nm, min=1)).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits [C, n] -> [C, ceil(n/8)] uint8, MSB first, zero-padded."""
    n = bits.shape[-1]
    return frontend.pack_bits_to_bytes(
        torch.nn.functional.pad(bits, (0, -(-n // 8) * 8 - n)))


class LockedChain(nn.Module):
    """The locked steady state of one receiver (_get_locked_chain): front
    end -> rotation -> carry concat -> depuncture -> [B, 2240, 2]
    segments -> Viterbi -> cores -> re-encode BER over the first TB
    pairs -> packed bits, and the new carry. Fixed (rate, rotation,
    carry length, n_samples); it never synchronises.

    forward(x complex64 [1, n], hints [1, 5], carry [c]) -> one uint8
    tensor holding every output, so that the host fetches it in one
    transfer; `split` unpacks it."""

    def __init__(self, front: ReceiverFront, rate: str, rotation: int,
                 carry_len: int, n_samples: int, decode_segments):
        super().__init__()
        self.front = front
        self.rotation = rotation
        self.decode_segments = decode_segments
        px, py = dvbs_fec.PUNCTURE[rate]
        self.p = len(px)
        pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)
        n_kept = int(pat.sum())
        self.register_buffer("pat_idx", torch.from_numpy(
            np.nonzero(pat)[0]).to(front.rrc_taps.device), persistent=False)
        self.c = carry_len
        m = carry_len + n_samples              # serial soft-stream length
        self.n_use = m // n_kept * n_kept
        self.n_pairs = self.n_use // n_kept * self.p
        self.B = -(-self.n_pairs // CORE)
        self.TB = min(TEST_BITS, self.n_pairs)
        self.new_carry = m - self.n_use
        # float32 fields of the output, in order: ber, hints, scatter, carry
        self.fields = (("ber", 1), ("hints", 5), ("scat", 2 * N_SCATTER),
                       ("carry", self.new_carry))

    def forward(self, x: torch.Tensor, hints: torch.Tensor,
                carry: torch.Tensor) -> torch.Tensor:
        soft, new_hints, scat = self.front(x, hints)
        with span("viterbi"):
            s = soft[0]
            if self.rotation:                   # I' = Q, Q' = -I
                pr = s.reshape(-1, 2)
                s = torch.stack([pr[:, 1], -pr[:, 0]], dim=1).reshape(-1)
            stream = torch.cat([carry, s]) if self.c else s
            bits, dl = depuncture_decode(stream[None, :self.n_use],
                                         self.pat_idx, self.p, CORE, WING,
                                         self.decode_segments)
        with span("ber_pack"):
            ber = reencode_ber(bits, dl, 0, self.TB)
            floats = torch.cat([ber, new_hints[0], scat.reshape(-1),
                                stream[self.n_use:]])
            return torch.cat([floats.view(torch.uint8), pack_bits(bits)[0]])

    def split(self, buf: np.ndarray) -> dict:
        """The fetched uint8 buffer -> dict(ber, hints, scat, carry
        float32 arrays, bits packed uint8)."""
        out, lo = {}, 0
        for name, k in self.fields:
            out[name] = buf[lo:lo + 4 * k].view(np.float32)
            lo += 4 * k
        out["bits"] = buf[lo:]
        return out


# ---------------------------------------------------------------------------
# the receiver
# ---------------------------------------------------------------------------

class DVBSReceiver:
    """Streaming DVB-S demodulator with automatic rate/phase lock on
    `device` (None: the card).

    viterbi_impl picks the locked chain's segment decoder
    (viterbi_kernel.select_decoder): "auto" or "pallas" kernel C (its
    plain version for CPU tensors), "xla" the decoder of ops/viterbi.py.
    The lock search and the first block after a lock decode with
    ops/viterbi.py, as in dvbs_tpu."""

    def __init__(self, rate: str | None = None,
                 block_symbols: int = 1 << 16,
                 native_tail: bool | None = None,
                 viterbi_impl: str = "auto", device=None):
        self.block_symbols = block_symbols
        self.fixed_rate = rate
        self.locked = False
        self.rate: str | None = rate
        self.rotation = 0
        self.drop = 0
        self.ber = 1.0
        self.out_of_sync = 0
        self.device = backend.resolve_device(device)
        self._decode_segments = viterbi_kernel.select_decoder(viterbi_impl)
        # host tail: the native C++ tail when built, else numpy —
        # byte-identical, checkpoint-interchangeable
        if native_tail is None:
            native_tail = _native.available()
        self.native_tail = bool(native_tail)
        self._reset_tail()
        self._llr_carry = np.zeros(0, np.float32)
        self._front = ReceiverFront(self.device)
        self._locked_cache = {}     # (rate, rot, carry_len, n) -> LockedChain
        self._hints = np.array([0, 0, 0, 0, 1], np.float32)  # first=1
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

    def _upload(self, samples: np.ndarray) -> torch.Tensor:
        """samples -> complex64 [1, n] on the receiver's device."""
        return torch.from_numpy(np.ascontiguousarray(
            samples, np.complex64)[None]).to(self.device, non_blocking=True)

    def _hints_in(self) -> torch.Tensor:
        return torch.from_numpy(self._hints[None].copy()).to(
            self.device, non_blocking=True)

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def _update_hints(self, new_hints: np.ndarray, n: int):
        """Carry DSP state across blocks: fold whole-sample timing drift
        into the host FIFO advance so the carried tau stays inside the
        resampler span; NCO phase continuity accounts for the advance."""
        old_nco = float(self._hints[1])
        self._hints = new_hints.copy()
        tau_end = float(self._hints[2])
        adv = n - int(round(2.0 * tau_end))
        self.last_consumed = adv
        self._hints[2] = tau_end - round(2.0 * tau_end) / 2.0
        cfo = float(self._hints[0])
        self._hints[1] = (old_nco + cfo * adv) % (2 * np.pi)

    def _get_locked_chain(self, n_samples: int) -> LockedChain:
        """The locked chain for the current (rate, rotation, carry
        length, n_samples): the carry length is constant once the stream
        reaches steady state, so each lock builds a handful at most."""
        key = (self.rate, self.rotation, len(self._llr_carry), n_samples)
        chain = self._locked_cache.get(key)
        if chain is None:
            chain = LockedChain(self._front, self.rate, self.rotation,
                                len(self._llr_carry), n_samples,
                                self._decode_segments)
            self._locked_cache[key] = chain
        return chain

    # ------------------------------------------------------------------
    # Locked-path pipelining: dispatch (enqueue the device chain) / fetch
    # (one transfer, then the DSP state update) / host tail (deframe, RS)
    # are split so DVBSStream runs the host tail of block i while the
    # device computes block i+1 (the reference's per-Processor threads,
    # module_dvbs_demod.h:32-44).
    def dispatch_locked(self, samples: np.ndarray) -> dict:
        """Enqueue one locked block without waiting. Requires self.locked
        and drop == 0. Returns an opaque ctx for fetch_locked."""
        n = len(samples)
        chain = self._get_locked_chain(n)
        carry = torch.from_numpy(self._llr_carry.copy()).to(
            self.device, non_blocking=True)
        with torch.no_grad():
            out = chain(self._upload(samples), self._hints_in(), carry)
        return dict(out=out, chain=chain, n=n)

    def fetch_locked(self, ctx: dict):
        """Fetch a dispatched block's outputs (one transfer) and update
        the DSP state (hints, carry, BER watchdog). Returns (bits,
        constellation, n)."""
        chain = ctx["chain"]
        out = chain.split(ctx["out"].cpu().numpy())
        scat = out["scat"].reshape(2, N_SCATTER)
        constellation = (scat[0] + 1j * scat[1]).astype(np.complex64)
        self._update_hints(out["hints"], ctx["n"])
        self._llr_carry = out["carry"].copy()
        bits = np.unpackbits(out["bits"])[:chain.n_pairs]
        self._watchdog(float(out["ber"][0]))
        return bits, constellation, ctx["n"]

    def _watchdog(self, ber: float):
        """The reference's 20-strike rule on a block's re-encode BER."""
        self.ber = ber
        if ber > BER_THRESHOLD:
            self.out_of_sync += 1
            if self.out_of_sync > 20:
                self.locked = False
        else:
            self.out_of_sync = 0

    def process_block(self, samples: np.ndarray) -> DVBSBlockResult:
        if self.locked and self.drop == 0:
            bits, constellation, n = self.fetch_locked(
                self.dispatch_locked(samples))
            return self._host_tail(bits, constellation, n // 2)

        n = len(samples)
        with torch.no_grad():
            soft_d, hints_d, scat_d = self._front(self._upload(samples),
                                                  self._hints_in())
            buf = torch.cat([soft_d[0], hints_d[0],
                             scat_d.reshape(-1)]).cpu().numpy()
        soft, new_hints = buf[:n], buf[n:n + 5]
        scat = buf[n + 5:].reshape(2, N_SCATTER)
        constellation = (scat[0] + 1j * scat[1]).astype(np.complex64)
        self._update_hints(new_hints, n)
        soft_len = len(soft)

        if not self.locked:
            self._try_lock(soft)
            if not self.locked:
                return DVBSBlockResult(np.zeros((0, 188), np.uint8),
                                       self.ber, False, None, 0.0,
                                       self.sync_errors,
                                       soft_len // 2,
                                       constellation=constellation)

        srot = self._rotate_serial(soft, self.rotation)
        stream = np.concatenate([self._llr_carry, srot[self.drop:]]) \
            if self.drop or len(self._llr_carry) else srot
        self.drop = 0  # only applied once; carry keeps continuity
        px, py = dvbs_fec.PUNCTURE[self.rate]
        n_kept = int(px.sum() + py.sum())
        n_use = (len(stream) // n_kept) * n_kept
        self._llr_carry = stream[n_use:].astype(np.float32)
        dl = dvbs_fec.depuncture(stream[:n_use], self.rate, 0)
        bits = viterbi.decode_stream(dl.astype(np.float32),
                                     device=self.device)

        # watchdog: re-encode BER on a sample of the block
        re_xy = dvbs_fec.cc_encode(bits[:TEST_BITS])
        chunk = dl[:TEST_BITS]
        mask = chunk != 0
        self._watchdog(float((re_xy[:TEST_BITS][mask] !=
                              (chunk < 0).astype(np.uint8)[mask]).mean())
                       if mask.any() else 1.0)
        return self._host_tail(bits, constellation, soft_len // 2)

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


class DVBSStream:
    """FIFO wrapper matching DVBS2Stream's interface for the CLI."""

    def __init__(self, rate: str | None = None, block_symbols: int = 1 << 16,
                 native_tail: bool | None = None,
                 viterbi_impl: str = "auto", device=None):
        self.rx = DVBSReceiver(rate=rate, block_symbols=block_symbols,
                               native_tail=native_tail,
                               viterbi_impl=viterbi_impl, device=device)
        self._fifo = np.zeros(0, np.complex64)
        self.block_symbols = block_symbols
        self.metrics = type("M", (), {})()
        self._reset_metrics()

    def _reset_metrics(self):
        # the DVB-S metric set under its own names (SURVEY.md sec. 3.5 /
        # module_dvbs_demod.cpp:101-115, GUI main.cpp:340-351)
        m = self.metrics
        m.viterbi_ber = 1.0
        m.viterbi_sig_level = 0.0      # 100 - avg30(BER) * (100/0.3)
        m.viterbi_lock = False
        m.viterbi_rate = None          # "1/2".."7/8" once locked
        m.rs_avg_errors = 0.0
        m.deframer_errors = 0
        m.frames_ok = 0
        m.frames_seen = 0
        # 30-entry rolling windows, mirroring the reference GUI's ring
        # buffers (main.cpp:340-351): sig level and RS averages smooth
        # over the last 30 processed blocks
        self._ber_ring = collections.deque(maxlen=30)
        self._rs_ring = collections.deque(maxlen=30)

    def feed(self, samples: np.ndarray) -> bytes:
        """Pipelined: once locked, block i+1 is dispatched to the device
        before block i's host tail (deframe/deinterleave/RS) runs, so
        host FEC overlaps device compute."""
        self._fifo = np.concatenate([self._fifo,
                                     np.asarray(samples, np.complex64)])
        out = bytearray()
        n = 2 * self.block_symbols
        pending = None
        while True:
            if pending is not None:
                bits, const, nn_ = self.rx.fetch_locked(pending)
                self._fifo = self._fifo[self.rx.last_consumed:]
                pending = None
                if self.rx.locked and self.rx.drop == 0 and \
                        len(self._fifo) >= n:
                    pending = self.rx.dispatch_locked(self._fifo[:n])
                res = self.rx._host_tail(bits, const, nn_ // 2)
            elif len(self._fifo) >= n:
                if self.rx.locked and self.rx.drop == 0:
                    pending = self.rx.dispatch_locked(self._fifo[:n])
                    continue
                res = self.rx.process_block(self._fifo[:n])
                self._fifo = self._fifo[self.rx.last_consumed:]
            else:
                break
            out.extend(res.ts_packets.reshape(-1).tobytes())
            m = self.metrics
            m.viterbi_ber = float(res.viterbi_ber)
            self._ber_ring.append(float(res.viterbi_ber))
            m.viterbi_sig_level = max(
                0.0, 100.0 - float(np.mean(self._ber_ring)) * (100.0 / 0.3))
            m.viterbi_lock = bool(res.viterbi_lock)
            m.viterbi_rate = res.detected_rate
            if res.frames:                 # blocks with RS activity only
                self._rs_ring.append(float(res.rs_avg_errors))
            m.rs_avg_errors = float(np.mean(self._rs_ring)) \
                if self._rs_ring else 0.0
            m.deframer_errors = int(res.deframer_errors)
            # real super-frame counts, not block counts: frames_seen is
            # 1632-byte frames deframed, frames_ok is dispersal groups
            # whose 8 RS codewords all decoded
            m.frames_seen += int(res.frames)
            m.frames_ok += int(res.groups_ok)
        return bytes(out)

    def get_state(self) -> dict:
        """Snapshot for seamless restart, in dvbs_tpu's format. feed()
        drains its pipelined dispatch before returning, so there is never
        an in-flight block at snapshot time."""
        m = self.metrics
        return dict(rx=self.rx.get_state(),
                    fifo=self._fifo.copy(),
                    ber_ring=list(self._ber_ring),
                    rs_ring=list(self._rs_ring),
                    metrics={k: getattr(m, k) for k in (
                        "viterbi_ber", "viterbi_sig_level", "viterbi_lock",
                        "viterbi_rate", "rs_avg_errors", "deframer_errors",
                        "frames_ok", "frames_seen")})

    def set_state(self, st: dict):
        self.rx.set_state(st["rx"])
        self._fifo = np.asarray(st["fifo"], np.complex64).copy()
        self._ber_ring = collections.deque(st["ber_ring"], maxlen=30)
        self._rs_ring = collections.deque(st["rs_ring"], maxlen=30)
        for k, v in st["metrics"].items():
            setattr(self.metrics, k, v)
