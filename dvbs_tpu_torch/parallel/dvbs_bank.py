"""Multi-carrier DVB-S streaming bank: every carrier of a block in one step.

PyTorch port of dvbs_tpu/parallel/dvbs_bank.py (`unpack_cs4_host`,
`_front_first`, `_front_hinted` as `DVBSFront`, `stream_bank_geometry`,
`build_dvbs_stream_bank`, `DVBSBankStream`, `build_dvbs_bank`).
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

Also `build_dvbs_bank`, the first-block bank: every block demodulated
with fresh estimates, each carrier's rotation and alignment drop found
by the host lock search on the first call and fixed afterwards.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from ..profiling import span
from ..io import native as _native
from ..spec import dvbs_fec
from .. import backend
from ..models.dvbs import (BER_THRESHOLD, TEST_BITS, DVBSReceiver,
                           FrontEnd, depuncture_decode, pack_bits,
                           reencode_ber)
from ..ops import frontend, viterbi_kernel

# hint columns: [cfo, nco_phase, tau, theta, first, rot]
FIRST_HINTS = (0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def unpack_cs4_host(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of frontend.pack_cs4 (for the lock pass)."""
    hi = ((packed.astype(np.int16) >> 4) ^ 8) - 8
    lo = ((packed.astype(np.int16) & 15) ^ 8) - 8
    return (hi + 1j * lo).astype(np.complex64)


class DVBSFront(FrontEnd):
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
        super().__init__(device)
        self.u_soft = u_soft

    def forward(self, ri: torch.Tensor, hints: torch.Tensor):
        with span("frontend"):
            x = torch.complex(ri[:, 0].to(torch.float32),
                              ri[:, 1].to(torch.float32))
        zc, cfo, nco_phase, tau_next, f4, ph = self.symbols(x, hints,
                                                            self.u_soft)
        with span("carrier"):
            # locked rotation z * exp(-j pi/2): I' = Q, Q' = -I
            rot = (hints[:, 5] > 0.5)[:, None]
            re = torch.where(rot, zc.imag, zc.real)
            im = torch.where(rot, -zc.real, zc.imag)
            soft = torch.stack([re, im], dim=-1).reshape(zc.shape[0], -1)
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
                 core: int, wing: int, ingest: str, decode_segments,
                 device):
        super().__init__()
        self.C, self.core, self.wing, self.ingest = (n_carriers, core, wing,
                                                     ingest)
        self.decode_segments = decode_segments
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
        if self.ingest == "cs4":
            with span("frontend"):
                samples = frontend.unpack_cs4(samples)
        soft, new_hints = self.front(samples, hints)
        with span("viterbi"):
            bits, dl = depuncture_decode(
                soft[:, :self.geom["win_soft"]], self.pat_idx, self.p,
                self.core, self.wing, self.decode_segments)
        with span("ber_pack"):
            ber = reencode_ber(bits, dl, self.ov_p, self.TB)
            packed = pack_bits(bits)
        return dict(bits=packed, ber=ber, hints=new_hints)


def build_dvbs_stream_bank(n_carriers: int, rate: str = "1/2",
                           block_samples: int = 1 << 17, core: int = 512,
                           wing: int = 96, ingest: str = "cs4",
                           viterbi_impl: str = "auto", device=None):
    """The streaming bank on `device`: returns (step, example, geom)
    as dvbs_bank.build_dvbs_stream_bank. step(samples, hints [C, 6])
    takes cs4 uint8 [C, n] or float16 re/im [C, 2, n] (ingest);
    viterbi_impl as viterbi_kernel.select_decoder."""
    if ingest not in ("cs4", "f16"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    step = DVBSStreamBank(n_carriers, rate, block_samples, core, wing,
                          ingest, viterbi_kernel.select_decoder(viterbi_impl),
                          backend.resolve_device(device))
    C, n = n_carriers, block_samples
    if ingest == "cs4":
        example = np.zeros((C, n), np.uint8)
    else:
        example = np.zeros((C, 2, n), np.float16)
    geom = dict(step.geom)
    geom["n_pairs"] = step.n_pairs
    geom["emit"] = (step.ov_p, step.u_p)
    return step, example, geom


class DVBSBank(nn.Module):
    """The first-block bank's step once its carriers are locked
    (dvbs_bank.build_dvbs_bank's `_build(rots, drops)`): every block
    with first-block estimates, each carrier's rotation and alignment
    drop fixed. forward(samples) -> dict(bits [C, n_pairs/8] uint8
    packed decoded bits, ber [C] float32 re-encode BER over the first
    TB pairs)."""

    def __init__(self, front: DVBSFront, rots, drops, rate: str,
                 block_samples: int, core: int, wing: int, ingest: str,
                 decode_segments):
        super().__init__()
        self.front, self.core, self.wing, self.ingest = (front, core, wing,
                                                         ingest)
        self.drops = [int(d) for d in drops]
        self.decode_segments = decode_segments
        px, py = dvbs_fec.PUNCTURE[rate]
        self.p = len(px)
        pat = np.stack([px, py], axis=1).reshape(-1).astype(bool)
        n_kept = int(pat.sum())
        # one stream length for every carrier whatever its drop (drops
        # are < 2 * n_kept)
        self.n_use = (block_samples - 2 * n_kept) // n_kept * n_kept
        self.n_pairs = self.n_use // n_kept * self.p
        self.TB = min(TEST_BITS, self.n_pairs)
        dev = front.rrc_taps.device
        self.register_buffer("pat_idx", torch.from_numpy(
            np.nonzero(pat)[0]).to(dev), persistent=False)
        # first-block estimates, each carrier's rotation as the front's
        # rot hint (the same soft values as rotating afterwards)
        hints = np.asarray([FIRST_HINTS] * len(self.drops), np.float32)
        hints[:, 5] = np.asarray(rots, np.float32)
        self.register_buffer("hints", torch.from_numpy(hints).to(dev),
                             persistent=False)

    def forward(self, samples: torch.Tensor) -> dict:
        if self.ingest == "cs4":
            with span("frontend"):
                samples = frontend.unpack_cs4(samples)
        soft, _ = self.front(samples, self.hints)
        with span("viterbi"):
            used = torch.stack([soft[c, d:d + self.n_use]
                                for c, d in enumerate(self.drops)])
            bits, dl = depuncture_decode(used, self.pat_idx, self.p,
                                         self.core, self.wing,
                                         self.decode_segments)
        with span("ber_pack"):
            ber = reencode_ber(bits, dl, 0, self.TB)
            packed = pack_bits(bits)
        return dict(bits=packed, ber=ber)


def _lock(front: DVBSFront, samples: torch.Tensor, rate: str,
          ingest: str):
    """build_dvbs_bank's acquisition: the first-block front for every
    carrier at once, then the lock search per carrier on the host.
    Returns (rotations, drops); raises RuntimeError where a carrier
    does not lock."""
    ri = frontend.unpack_cs4(samples) if ingest == "cs4" else samples
    with torch.no_grad():
        softs = _front_first(front, ri).cpu().numpy()
    rots, drops = [], []
    for c, soft in enumerate(softs):
        rx = DVBSReceiver(rate=rate, block_symbols=front.u_soft // 2,
                          device=ri.device)
        rx._try_lock(soft)
        if not rx.locked:
            raise RuntimeError(f"carrier {c}: no Viterbi lock "
                               f"(best BER {rx.ber:.3f})")
        rots.append(rx.rotation)
        drops.append(rx.drop)
    return rots, drops


def build_dvbs_bank(n_carriers: int, rate: str = "1/2",
                    block_samples: int = 1 << 17, core: int = 512,
                    wing: int = 96, ingest: str = "cs4",
                    viterbi_impl: str = "auto", device=None):
    """The first-block DVB-S bank on `device` (None: the card): returns
    (step, example) as dvbs_bank.build_dvbs_bank. step(samples) ->
    dict(bits [C, nb] uint8 packed decoded bits, ber [C] float32
    re-encode BER, n_pairs int).

    samples: [C, n] uint8 packed cs4 IQ (ingest="cs4") or [C, 2, n]
    float16 re/im (ingest="f16"), a tensor on the device. The first call
    locks each carrier on the host (rotation x alignment search) and
    builds the step (`DVBSBank`); every call is then one device step."""
    if ingest not in ("cs4", "f16"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    decode_segments = viterbi_kernel.select_decoder(viterbi_impl)
    front = DVBSFront(block_samples, backend.resolve_device(device))
    state = {}

    def step(samples: torch.Tensor) -> dict:
        if "bank" not in state:
            rots, drops = _lock(front, samples, rate, ingest)
            state["bank"] = DVBSBank(front, rots, drops, rate,
                                     block_samples, core, wing, ingest,
                                     decode_segments)
        with torch.no_grad():
            out = state["bank"](samples)
        out["n_pairs"] = state["bank"].n_pairs
        return out

    C, n = n_carriers, block_samples
    if ingest == "cs4":
        example = np.zeros((C, n), np.uint8)
    else:
        example = np.zeros((C, 2, n), np.float16)
    return step, example


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
                 viterbi_impl: str = "auto", device=None):
        self.C = n_carriers
        self.rate = rate
        self.n = block_samples
        self.ingest = ingest
        self.device = backend.resolve_device(device)
        self.step, _, self.geom = build_dvbs_stream_bank(
            n_carriers, rate=rate, block_samples=block_samples,
            ingest="cs4" if ingest == "cs4" else "f16",
            viterbi_impl=viterbi_impl, device=self.device)
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
