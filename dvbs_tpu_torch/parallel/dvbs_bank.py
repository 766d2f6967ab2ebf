"""Multi-carrier DVB-S streaming bank: every carrier of a block in one step.

PyTorch port of the streaming half of dvbs_tpu/parallel/dvbs_bank.py
(`unpack_cs4_host`, `_front_first`, `_front_hinted` as `DVBSFront`,
`stream_bank_geometry`, `build_dvbs_stream_bank`, `DVBSBankStream`).
The JAX version vmaps a per-carrier front end; here the front end is
batched over carriers [C, ...], and the step is an nn.Module:

  cs4 unpack -> AGC -> CFO mix with carried NCO phase -> RRC ->
  feed-forward timing (kernel B) -> 4th-power residual frequency ->
  V&V phase -> locked 90-degree rotation -> depuncture -> overlapped
  segments -> Viterbi (kernel C) -> cores -> re-encode BER -> packed
  bits, next-block hints.

The host logic of DVBSBankStream is dvbs_tpu's, unchanged: per-carrier
FIFOs, the lock search with its alignment drop folded into the FIFO,
overlap emission, the 20-strike relock watchdog, the timing-drift fold
into the FIFO advance, and get_state/set_state in the same format. Its
two host<->device seams are `_upload` and one fetch per block.

Not ported yet (ROADMAP queue 1): `build_dvbs_bank`, the non-streaming
first-block bank.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..io import native as _native
from ..spec import dvbs_fec
from .. import backend, tables
from ..models.dvbs import DVBSReceiver
from ..ops import frontend, plphase, viterbi_kernel

TEST_BITS = 2048
BER_THRESHOLD = 0.15

# hint columns: [cfo, nco_phase, tau, theta, first, rot]
FIRST_HINTS = (0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def unpack_cs4_host(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of frontend.pack_cs4 (for the lock pass)."""
    hi = ((packed.astype(np.int16) >> 4) ^ 8) - 8
    lo = ((packed.astype(np.int16) & 15) ^ 8) - 8
    return (hi + 1j * lo).astype(np.complex64)


class DVBSFront(nn.Module):
    """The hint-carrying DVB-S front end (dvbs_bank._front_hinted),
    batched over carriers: re/im
    [C, 2, n] (int8, float16 or float32) + hints [C, 6] -> (soft [C, n]
    float32 serialized (I, Q), new_hints [C, 6]).

    hints: [cfo, nco_phase, tau, theta, first, rot]. first=1 takes
    fresh coarse-CFO, timing and phase estimates (the first-block
    front); rot applies the locked 90-degree rotation. The stream
    advances u_soft samples per block, so the carried tau and theta are
    evaluated there (dvbs_bank._front_hinted)."""

    def __init__(self, u_soft: int, device):
        super().__init__()
        self.u_soft = u_soft
        np_tables = tables.dvbs_front_tables()
        self.farrow_band = tuple(float(v)
                                 for v in np_tables.pop("farrow_band"))
        for k, v in tables.to_torch(np_tables, device).items():
            if k in ("fir_rrc", "fir_mid"):
                v = frontend.bf16_round(v)      # the bf16 matmul's operand
            self.register_buffer(k, v, persistent=False)

    def forward(self, ri: torch.Tensor, hints: torch.Tensor):
        first = hints[:, 4] > 0.5
        with record_function("frontend"):
            x = torch.complex(ri[:, 0].to(torch.float32),
                              ri[:, 1].to(torch.float32))
            x = frontend.agc(x)
            cfo = torch.where(first, frontend.coarse_cfo_estimate(x),
                              hints[:, 0])
            nco_phase = torch.where(first, torch.zeros_like(hints[:, 1]),
                                    hints[:, 1])
            x = frontend.mix(x, cfo, nco_phase)
            y = frontend.matched_filter(x, self.rrc_taps, self.fir_rrc)
        with record_function("timing"):
            tau_hint = torch.where(first, torch.full_like(hints[:, 2],
                                                          math.nan),
                                   hints[:, 2])
            z, _, tau_next = frontend.recover_symbols_full(
                y, self.mid_taps, self.fir_mid, self.farrow_coef,
                self.farrow_band, n_windows=16, tau_hint=tau_hint,
                tau_eval=self.u_soft)
        with record_function("carrier"):
            S = z.shape[-1]
            f4 = frontend.qpsk_residual_freq(z)
            ks = torch.arange(S, dtype=torch.int32, device=z.device)
            z = plphase.derotate(z, f4[:, None] * ks)
            theta0 = torch.where(first, torch.zeros_like(hints[:, 3]),
                                 hints[:, 3])
            ph = plphase.qpsk_vv_track(z, theta0)
            zc = plphase.derotate(z, ph)
            # locked rotation z * exp(-j pi/2): I' = Q, Q' = -I
            rot = (hints[:, 5] > 0.5)[:, None]
            re = torch.where(rot, zc.imag, zc.real)
            im = torch.where(rot, -zc.real, zc.imag)
            soft = torch.stack([re, im], dim=-1).reshape(z.shape[0], -1)
            k_next = self.u_soft // 2       # symbol where the next block starts
            new_hints = torch.stack([
                cfo, nco_phase, tau_next, f4 * k_next + ph[:, k_next - 1],
                torch.zeros_like(cfo), hints[:, 5]], dim=1)
        return soft, new_hints


def _front_first(front: DVBSFront, ri: torch.Tensor) -> torch.Tensor:
    """dvbs_bank._front_first for C carriers: the hinted front with
    first=1, rot=0 gives the same soft values. -> soft [C, n]."""
    hints = torch.tensor([FIRST_HINTS] * ri.shape[0], dtype=torch.float32,
                         device=ri.device)
    return front(ri, hints)[0]


def stream_bank_geometry(rate: str, block_samples: int, wing: int = 96,
                         front_margin: int = 512):
    """Soft-domain window geometry for seam-clean streaming
    (dvbs_bank.stream_bank_geometry): every block decodes its whole soft
    window but emits only [ov_soft, ov_soft + u_soft), so emitted bits
    get >= `wing` pairs of real soft context on both sides. Units: 1
    soft value = 1 sample (at 2 sps) = 1/2 symbol."""
    px, py = dvbs_fec.PUNCTURE[rate]
    p = len(px)
    n_kept = int(px.sum() + py.sum())
    chunk = n_kept * 2 // math.gcd(n_kept, 2)     # lcm: whole symbols
    ov_soft = -(-max(-(-wing // p) * n_kept, front_margin) // chunk) * chunk
    n_soft = block_samples
    u_soft = (n_soft - 2 * ov_soft) // chunk * chunk
    if u_soft <= 0:
        raise ValueError("block too small for the overlap window")
    win_soft = u_soft + 2 * ov_soft
    pairs = dict(p=p, n_kept=n_kept,
                 ov=ov_soft // n_kept * p,
                 u=u_soft // n_kept * p,
                 win=win_soft // n_kept * p)
    return dict(chunk=chunk, ov_soft=ov_soft, u_soft=u_soft,
                win_soft=win_soft, pairs=pairs)


class DVBSStreamBank(nn.Module):
    """The steady-state streaming bank step (build_dvbs_stream_bank's
    step): forward(samples, hints [C, 6]) -> dict(bits [C, win/8] uint8
    packed decoded bits of the whole window, ber [C] float32 re-encode
    BER over the emitted head, hints [C, 6] next-block hints)."""

    def __init__(self, n_carriers: int, rate: str, block_samples: int,
                 core: int, wing: int, ingest: str, device):
        super().__init__()
        self.C, self.core, self.wing, self.ingest = (n_carriers, core, wing,
                                                     ingest)
        self.geom = geom = stream_bank_geometry(rate, block_samples,
                                                wing=wing)
        px, py = dvbs_fec.PUNCTURE[rate]
        self.p = len(px)
        pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)
        self.n_kept = int(pat.sum())
        self.periods = geom["win_soft"] // self.n_kept
        self.n_pairs = self.periods * self.p
        self.B = -(-self.n_pairs // core)
        self.ov_p, self.u_p = geom["pairs"]["ov"], geom["pairs"]["u"]
        self.TB = min(TEST_BITS, self.u_p)
        self.front = DVBSFront(geom["u_soft"], device)
        self.register_buffer("pat_idx", torch.from_numpy(
            np.nonzero(pat)[0]).to(device), persistent=False)

    def forward(self, samples: torch.Tensor, hints: torch.Tensor) -> dict:
        C, core, wing = self.C, self.core, self.wing
        if self.ingest == "cs4":
            with record_function("frontend"):
                samples = frontend.unpack_cs4(samples)
        soft, new_hints = self.front(samples, hints)
        with record_function("viterbi"):
            used = soft[:, :self.geom["win_soft"]].reshape(
                C, self.periods, self.n_kept)
            dl = soft.new_zeros((C, self.periods, 2 * self.p))
            dl[:, :, self.pat_idx] = used           # static-column scatter
            dl = dl.reshape(C, self.n_pairs, 2)
            T = core + 2 * wing
            padded = soft.new_zeros((C, self.B * core + 2 * wing, 2))
            padded[:, wing:wing + self.n_pairs] = dl
            segs = padded.unfold(1, T, core)        # [C, B, 2, T]
            segs = segs.transpose(2, 3).reshape(C * self.B, T, 2)
            bits_seg = viterbi_kernel.decode_segments(segs)
            bits = bits_seg.reshape(C, self.B, T)[:, :, wing:wing + core] \
                .reshape(C, -1)[:, :self.n_pairs]
        with record_function("ber_pack"):
            ber = self._reencode_ber(bits, dl)
            nb8 = -(-self.n_pairs // 8) * 8
            bits_pad = torch.nn.functional.pad(bits, (0, nb8 - self.n_pairs))
            packed = frontend.pack_bits_to_bytes(bits_pad)
        return dict(bits=packed, ber=ber, hints=new_hints)

    def _reencode_ber(self, bits: torch.Tensor, dl: torch.Tensor):
        """Re-encode BER over the first TB pairs of the emitted window,
        erasures excluded (the SYNCED watchdog, viterbi_all.cpp:209-273)."""
        C, ov, TB = self.C, self.ov_p, self.TB
        bp = torch.nn.functional.pad(bits, (6, 0))[:, ov:ov + 6 + TB] \
            .to(torch.int32)

        def enc(poly):
            acc = torch.zeros((C, TB), dtype=torch.int32, device=bits.device)
            for j in range(7):
                if (poly >> j) & 1:
                    acc = acc + bp[:, j:j + TB]
            return acc % 2
        exy = torch.stack([enc(dvbs_fec.G1), enc(dvbs_fec.G2)], dim=2)
        chunk = dl[:, ov:ov + TB]
        maskz = chunk != 0
        hard = (chunk < 0).to(torch.int32)
        nm = maskz.sum(dim=(1, 2))
        errs = (maskz & (exy != hard)).sum(dim=(1, 2))
        return (errs / torch.clamp(nm, min=1)).to(torch.float32)


def build_dvbs_stream_bank(n_carriers: int, rate: str = "1/2",
                           block_samples: int = 1 << 17, core: int = 512,
                           wing: int = 96, ingest: str = "cs4",
                           device=None):
    """The streaming bank on `device`: returns (step, example, geom)
    as dvbs_bank.build_dvbs_stream_bank. step(samples, hints [C, 6])
    takes cs4 uint8 [C, n] or float16 re/im [C, 2, n] (ingest)."""
    if ingest not in ("cs4", "f16"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    step = DVBSStreamBank(n_carriers, rate, block_samples, core, wing,
                          ingest, backend.resolve_device(device))
    C, n = n_carriers, block_samples
    if ingest == "cs4":
        example = np.zeros((C, n), np.uint8)
    else:
        example = np.zeros((C, 2, n), np.float16)
    geom = dict(step.geom)
    geom["n_pairs"] = step.n_pairs
    geom["emit"] = (step.ov_p, step.u_p)
    return step, example, geom


class DVBSBankStream:
    """Continuous N-carrier DVB-S demodulation, one device step per block.

    The first block of a carrier runs the host lock search (rotation x
    depuncture alignment) on the first-block front's soft values; the
    alignment drop folds into that carrier's FIFO, so the steady state
    is drop-free and rectangular across carriers. Every block is then
    one bank step with hint continuity; the per-carrier re-encode BER
    drives the reference's 20-strike relock watchdog, and a struck
    carrier relocks from its own samples without disturbing the rest
    (rotation is a hint, not a rebuild)."""

    def __init__(self, n_carriers: int, rate: str = "1/2",
                 block_samples: int = 1 << 17, ingest: str = "f16",
                 device=None):
        self.C = n_carriers
        self.rate = rate
        self.n = block_samples
        self.ingest = ingest
        self.device = backend.resolve_device(device)
        self.step, _, self.geom = build_dvbs_stream_bank(
            n_carriers, rate=rate, block_samples=block_samples,
            ingest="cs4" if ingest == "cs4" else "f16", device=self.device)
        self._fifos = [np.zeros(0, np.complex64) for _ in range(n_carriers)]
        self._hints = np.zeros((n_carriers, 6), np.float32)
        self._hints[:, 4] = 1.0                     # first
        self._locked = np.zeros(n_carriers, bool)
        self._first_emit = np.ones(n_carriers, bool)
        self.out_of_sync = np.zeros(n_carriers, np.int32)
        self.ber = np.ones(n_carriers, np.float32)
        # the native C++ tail when built (make -C native), numpy otherwise
        self._native_tail = _native.available()
        self._tails = [self._make_tail() for _ in range(n_carriers)]
        self.last_debug = None
        self.steps_run = 0          # bank steps run by feed
        self.tail_seconds = 0.0     # host time spent in the TS tails

    def _make_tail(self):
        if self._native_tail:
            return _native.NativeDVBSTail()
        return DVBSReceiver(rate=self.rate, native_tail=False,
                            device=self.device)

    def _tail_feed(self, c: int, bits: np.ndarray) -> bytes:
        t0 = time.perf_counter()
        if self._native_tail:
            ts = self._tails[c].feed(bits)
        else:
            ts = self._tails[c]._host_tail(bits, None, 0).ts_packets
        self.tail_seconds += time.perf_counter() - t0
        return ts.reshape(-1).tobytes()

    # ------------------------------------------------------------------
    def _lock_carrier(self, c: int) -> bool:
        """Host lock pass on carrier c's current FIFO head; folds the
        depuncture alignment into the FIFO and marks the carrier fresh."""
        y = self._fifos[c][:self.n]
        if y.dtype == np.uint8:                 # pre-packed cs4 stream
            y = unpack_cs4_host(y)
        rms = np.sqrt(np.mean(np.abs(y) ** 2)) + 1e-30
        ri = np.stack([y.real, y.imag]).astype(np.float32) / rms
        soft = _front_first(self.step.front, torch.from_numpy(ri[None])
                            .to(self.device))[0].cpu().numpy()
        rx = DVBSReceiver(rate=self.rate, block_symbols=self.n // 2,
                          device=self.device)
        rx._try_lock(soft)
        if not rx.locked:
            self.ber[c] = rx.ber
            return False
        self._fifos[c] = self._fifos[c][rx.drop:]
        self._hints[c] = [0, 0, 0, 0, 1.0, float(rx.rotation)]
        self._locked[c] = True
        self._first_emit[c] = True
        self.out_of_sync[c] = 0
        self.ber[c] = rx.ber
        self._tails[c] = self._make_tail()
        return True

    def _upload(self, blocks: np.ndarray) -> torch.Tensor:
        """blocks [C, n] -> the step's input on the bank's device: cs4
        uint8 [C, n] (pre-packed uint8 FIFOs pass through) or float16
        re/im [C, 2, n] normalized per carrier."""
        if blocks.dtype == np.uint8:            # pre-packed cs4
            return torch.from_numpy(np.ascontiguousarray(blocks)) \
                .to(self.device)
        if self.ingest == "cs4":
            return torch.from_numpy(np.stack([frontend.pack_cs4(b)
                                              for b in blocks])) \
                .to(self.device)
        rms = np.sqrt(np.mean(np.abs(blocks) ** 2, axis=1,
                              keepdims=True)) + 1e-30
        bn = blocks / rms
        return torch.from_numpy(np.stack([bn.real.astype(np.float16),
                                          bn.imag.astype(np.float16)],
                                         axis=1)).to(self.device)

    # ------------------------------------------------------------------
    def feed(self, per_carrier) -> list[bytes]:
        """Feed 2-sps samples (complex, or pre-packed cs4 uint8) of C
        streams; returns the TS bytes produced per carrier this call."""
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
        while all(len(f) >= self.n for f in self._fifos):
            for c in range(self.C):
                if not self._locked[c]:
                    self._lock_carrier(c)
            # a fresh lock folds its alignment drop into the FIFO
            # (shrinking it by up to 2*n_kept samples): re-check that
            # every carrier still holds a full block before stacking
            if not all(len(f) >= self.n for f in self._fifos):
                break
            # unlocked carriers still ride the bank (their bits are
            # discarded); each may relock on a later block
            blocks = np.stack([f[:self.n] for f in self._fifos])
            dev_in = self._upload(blocks)
            hints_in = torch.from_numpy(self._hints.copy()).to(self.device)
            res = self.step(dev_in, hints_in)
            out = {k: v.cpu().numpy() for k, v in res.items()}
            self.steps_run += 1
            # a self-consistent (input, hints, output) of the latest block
            self.last_debug = dict(dev_in=dev_in, hints=hints_in, out=out)
            new_hints = out["hints"]
            ber = out["ber"]
            ov_p, u_p = self.geom["emit"]
            bits_all = np.unpackbits(out["bits"], axis=1)
            for c in range(self.C):
                adv = self.geom["u_soft"]
                if self._locked[c]:
                    # watchdog (reference 20-strike rule)
                    self.ber[c] = float(ber[c])
                    if ber[c] > BER_THRESHOLD:
                        self.out_of_sync[c] += 1
                        if self.out_of_sync[c] > 20:
                            self._locked[c] = False
                            self._hints[c, 4] = 1.0
                    else:
                        self.out_of_sync[c] = 0
                        lo = 0 if self._first_emit[c] else ov_p
                        outs[c].extend(self._tail_feed(
                            c, np.ascontiguousarray(
                                bits_all[c, lo:ov_p + u_p])))
                        self._first_emit[c] = False
                    # fold whole-sample timing drift into the advance
                    # (models/dvbs.DVBSReceiver._update_hints)
                    old_nco = float(self._hints[c, 1])
                    h = new_hints[c].copy()
                    tau = float(h[2])
                    adv = self.geom["u_soft"] - int(round(2.0 * tau))
                    h[2] = tau - round(2.0 * tau) / 2.0
                    h[1] = (old_nco + h[0] * adv) % (2 * np.pi)
                    self._hints[c] = h
                self._fifos[c] = self._fifos[c][adv:]
        return [bytes(o) for o in outs]

    # ------------------------------------------------------------------
    @property
    def locked(self) -> np.ndarray:
        return self._locked.copy()

    def get_state(self) -> dict:
        return dict(rate=self.rate,
                    fifos=[f.copy() for f in self._fifos],
                    hints=self._hints.copy(),
                    locked=self._locked.copy(),
                    first_emit=self._first_emit.copy(),
                    out_of_sync=self.out_of_sync.copy(),
                    ber=self.ber.copy(),
                    tails=[t.get_state() for t in self._tails])

    def set_state(self, st: dict):
        if st["rate"] != self.rate:
            raise ValueError(f"checkpoint of rate {st['rate']}, stream "
                             f"runs {self.rate}")
        # a pre-packed cs4 FIFO stays uint8 (dvbs_tpu casts every FIFO
        # to complex64 here, which breaks the next cs4 feed)
        self._fifos = [np.asarray(f).copy() if np.asarray(f).dtype == np.uint8
                       else np.asarray(f, np.complex64).copy()
                       for f in st["fifos"]]
        self._hints = np.asarray(st["hints"], np.float32).copy()
        self._locked = np.asarray(st["locked"], bool).copy()
        self._first_emit = np.asarray(st["first_emit"], bool).copy()
        self.out_of_sync = np.asarray(st["out_of_sync"], np.int32).copy()
        self.ber = np.asarray(st["ber"], np.float32).copy()
        self._tails = [self._make_tail() for _ in range(self.C)]
        for t, ts in zip(self._tails, st["tails"]):
            t.set_state(ts)
