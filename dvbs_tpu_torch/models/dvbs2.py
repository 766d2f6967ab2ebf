"""DVB-S2 receiver: its block symbol program, batched over carriers,
and the single-carrier block receiver.

PyTorch port of dvbs_tpu/models/dvbs2.py. `SymbolProgram` is the `_build`
program: samples -> AGC -> coarse CFO mix -> RRC matched filter ->
feed-forward timing recovery -> PL-frame sync -> block-common FED and
L&R frequency -> header phase -> phase track -> PLS detect -> soft demap
-> deinterleave, for C carriers at once. With pilots (any
constellation) the phase track is the pilot-anchor track and the
payload is the frame with its pilot blocks cut out; without pilots QPSK
runs the 4th-power V&V track and 8PSK, 16APSK and 32APSK the
decision-directed track, each from the header phase. `dummy_aware`
swaps in the chained frame locator and the coherence-gated frequency
estimates for streams that hold dummy PLFRAMEs.

`DVBS2Receiver` is the fixed-MODCOD block receiver: geometry, the
symbol program at C = 1, the FEC (the float decode_qc, or the int8
layered decoder's kernel on the F frames as they are), the two-pass
escalation, and the host side (sync-quality gate, BCH repair of flagged
frames). `equalize=True` inserts the block LMS equalizer
(ops/equalizer.lms_equalize) after timing recovery and before PL sync,
where dvbs_tpu inserts it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..spec import bch_spec, modcod, scrambling
from .. import backend, tables
from ..ops import (bch, demap, equalizer, frontend, interleaver,
                   ldpc_kernel, ldpc_qc, plhdr, plphase, plsync)


class SymbolProgram(nn.Module):
    """The per-block symbol program of one receiver geometry. Its
    buffers are the constant tables (tables.receiver_tables, or a dict
    of the same keys); forward maps samples [C, 2, n] (int8 or float,
    stacked I/Q) to per-carrier outputs. With `equalize` the timing-
    recovered symbols go through ops/equalizer.lms_equalize."""

    def __init__(self, cfg: modcod.ModcodConfig, block_symbols: int,
                 n_frames: int, edge_margin: int, device,
                 np_tables: dict | None = None, dummy_aware: bool = False,
                 equalize: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dummy_aware = dummy_aware
        self.equalize = equalize
        self.F = n_frames
        self.edge_margin = edge_margin
        np_tables = np_tables or tables.receiver_tables(cfg, block_symbols)
        np_tables = dict(np_tables)
        self.farrow_band = tuple(float(v)
                                 for v in np_tables.pop("farrow_band"))
        # the pilot grid is static: slices and windows, not a gather
        self.pstarts = [int(p) for p in np_tables.pop("pilot_starts", ())]
        for k, v in tables.to_torch(np_tables, device).items():
            if k in ("fir_rrc", "fir_mid"):
                v = frontend.bf16_round(v)      # the bf16 matmul's operand
            if k == "bch_M":
                v = v.to(torch.float32)
            self.register_buffer(k, v, persistent=False)

    def forward(self, samples_ri: torch.Tensor) -> dict:
        """samples [C, 2, n] -> llrs [C, F, nldpc], scatter, quality,
        freq, cfo, pls, pls_conf, starts. Each stage runs inside a
        profiler range of its layer's name."""
        cfg = self.cfg
        L = cfg.plframe_len
        F = self.F
        C = samples_ri.shape[0]
        with record_function("frontend"):
            x = torch.complex(samples_ri[:, 0].to(torch.float32),
                              samples_ri[:, 1].to(torch.float32))
            x = frontend.agc(x)
            cfo = frontend.coarse_cfo_estimate(x)
            x = frontend.mix(x, cfo)
            y = frontend.fir_filter(x, self.rrc_taps, self.fir_rrc)
        with record_function("timing"):
            z, _, _ = frontend.recover_symbols_full(
                y, self.mid_taps, self.fir_mid, self.farrow_coef,
                self.farrow_band, n_windows=16)
        if self.equalize:
            with record_function("equalizer"):
                z = equalizer.lms_equalize(z)
        with record_function("plsync"):
            score, _ = plsync.correlate(z, self.corr_T)
            locate = plsync.locate_frames_chain if self.dummy_aware \
                else plsync.locate_frames
            starts, quality = locate(score, L, F, margin=self.edge_margin)
            frames = plsync.extract_frames(z, starts, L)     # [C, F, L]
        with record_function("phase"):
            pilots = (self.pstarts, self.pilot_descr) if cfg.pilots else None
            fed = plphase.coarse_fed_common(frames, self.hdr_syms, pilots,
                                            robust=self.dummy_aware)
            frames = plphase.apply_freq(frames, fed[:, None].expand(C, F))
            flr = plphase.lr_freq_common(frames, self.hdr_syms, pilots,
                                         robust=self.dummy_aware)
            frames = plphase.apply_freq(frames, flr[:, None].expand(C, F))
            freq = (fed + flr)[:, None].expand(C, F)
            theta0 = plphase.header_phase(frames, self.hdr_syms)  # [C, F]
            if cfg.pilots:
                frames_c = plphase.derotate(frames, plphase.pilot_anchor_phases(
                    frames, theta0, pilots))
                payload = plphase.extract_payload(
                    frames_c, self.pstarts, L) * self.payload_descr
            else:
                frames_c = plphase.derotate(frames, theta0[..., None])
                payload = frames_c[..., 90:] * self.descr
                if cfg.constellation == modcod.QPSK:
                    vv = plphase.qpsk_vv_track(payload,
                                               torch.zeros_like(theta0))
                else:
                    with record_function("dd_phase_track"):
                        vv = plphase.dd_phase_track(
                            payload, torch.zeros_like(theta0),
                            self.demap_pts)
                payload = plphase.derotate(payload, vv)
            header = frames_c[..., :90]
        with record_function("demap"):
            pls_idx, pls_conf = plhdr.detect_pls(header, self.pls_syms)
            llrs = demap.soft_demap(payload, cfg.constellation,
                                    self.demap_pts, self.demap_mask0)
            llrs = interleaver.deinterleave(llrs, cfg.constellation,
                                            cfg.framesize, cfg.rate)
        scat = torch.cat([header[:, 0], payload[:, 0, :1958]], dim=-1)
        return dict(llrs=llrs,                        # [C, F, nldpc]
                    scatter=torch.stack([scat.real, scat.imag], dim=1),
                    quality=quality, freq=freq, cfo=cfo[:, None],
                    pls=pls_idx, pls_conf=pls_conf, starts=starts)


def run_fec(program: SymbolProgram, llrs: torch.Tensor, n_iters: int,
            fec: str, kt: dict | None = None, keep_hard: bool = True
            ) -> dict:
    """LDPC decode + BCH syndrome check + byte packing + BB descramble
    of llrs [B, nldpc] float, on the device. fec "xla" is the float
    decode_qc, "pallas" the int8 layered decoder (kernel A on a CUDA
    tensor) in calls of at most ldpc_kernel.CALL_FRAMES frames, each
    frame count as it is. Returns kbch_bytes [B, kbch/8] uint8, trials,
    ldpc_ok, bch_bad [B] (and hard [B, nldpc] with keep_hard)."""
    cfg = program.cfg
    with record_function("ldpc"):
        if fec == "xla":
            hard, n_bad, trials = ldpc_qc.decode_qc(
                llrs, cfg.ldpc_table, n_iters=n_iters)
        else:
            hard, n_bad, trials = ldpc_kernel.decode_calls(
                ldpc_kernel.quantize_llrs(llrs), cfg.ldpc_table, n_iters,
                kt=kt)
    with record_function("bch_pack"):
        bch_bad = bch.syndrome_nonzero(hard[:, :cfg.nbch], program.bch_M)
        packed = frontend.pack_bits_to_bytes(hard[:, :cfg.kbch]) \
            ^ program.bb_mask
    d = dict(kbch_bytes=packed, trials=trials, ldpc_ok=n_bad == 0,
             bch_bad=bch_bad)
    if keep_hard:
        d["hard"] = hard
    return d


def device_kernel_tables(program: SymbolProgram) -> dict:
    """The int8 decoder's schedule with its tables, and the packed
    schedule the CUDA kernel reads, already on the program's device."""
    kt = dict(tables.kernel_tables(program.cfg.ldpc_table))
    kt.update(g_tab=program.ldpc_g, s_tab=program.ldpc_s,
              f_tab=program.ldpc_f,
              sched=tables.pack_schedule(program.ldpc_g, program.ldpc_s,
                                         program.ldpc_f).contiguous())
    return kt


@dataclasses.dataclass
class BlockResult:
    """Host-side result of one processed block."""
    bbframes: np.ndarray          # [F_ok, kbch/8] uint8 (descrambled)
    frame_ok: np.ndarray          # [F] bool (LDPC converged & BCH fixable)
    sync_quality: np.ndarray      # [F] float32 (PL correlation peak)
    freq_err: np.ndarray          # [F] float32 rad/symbol residual
    ldpc_trials: np.ndarray       # [F] int32
    bch_corrections: np.ndarray   # [F] int32 (-1 = failure)
    detected_pls: np.ndarray      # [F] int32
    coarse_cfo: float             # rad/sample applied to the block
    n_symbols: int                # symbols consumed (frames * L)
    last_frame_end: int = 0       # symbol index just past the last frame
    constellation: np.ndarray | None = None  # [2048] complex64 scatter
                                  # (first 90 points = PLHEADER)
    detected_pls_conf: np.ndarray | None = None  # [F] float32 confidence
    starts: np.ndarray | None = None  # [F] int32 located frame starts


EDGE_MARGIN = 256       # symbols kept clear at each end of a block


def frames_per_block(cfg: modcod.ModcodConfig, block_symbols: int) -> int:
    """PL frames a block of `block_symbols` symbols decodes."""
    return (block_symbols - 2 * EDGE_MARGIN - 90) // cfg.plframe_len - 1


class DVBS2Receiver:
    """Fixed-MODCOD DVB-S2 block receiver (dvbs2.DVBS2Receiver) on
    `device` (None: the card).

    fec: "xla" runs the float decode_qc; "pallas" routes every decode
    through the int8 layered decoder, kernel A on the card. The kernel
    takes the block's F frames as they are: the JAX version pads them
    cyclically to its 128 lanes, and its copies clear at their
    originals' sweep, so hard, n_bad and trials of the F frames are the
    same."""

    def __init__(self, mc: int = 4, short: bool = True, pilots: bool = False,
                 block_symbols: int = 1 << 15, max_ldpc_trials: int = 32,
                 sof_threshold: float = 0.6, equalize: bool = False,
                 fec: str = "xla", dummy_aware: bool = False, device=None,
                 np_tables: dict | None = None):
        if fec not in ("xla", "pallas"):
            raise ValueError(f"unknown fec {fec!r}")
        self.cfg = modcod.get_config(mc, short=short, pilots=pilots)
        self.block_symbols = block_symbols
        self.max_ldpc_trials = max_ldpc_trials
        self.sof_threshold = sof_threshold
        self.fec = fec
        self.dummy_aware = dummy_aware
        self.edge_margin = EDGE_MARGIN
        self.n_frames = frames_per_block(self.cfg, block_symbols)
        if self.n_frames < 1:
            raise ValueError("block_symbols must cover at least 2 PL frames")
        self.device = backend.resolve_device(device)
        self.program = SymbolProgram(self.cfg, block_symbols, self.n_frames,
                                     self.edge_margin, self.device,
                                     np_tables, dummy_aware=dummy_aware,
                                     equalize=equalize)
        self._kt = device_kernel_tables(self.program)
        # two-pass escalation: every block pays a short pass, the rare
        # unconverged block reruns with the full budget
        self.pass1_iters = min(10, max_ldpc_trials)
        self._two_pass = max_ldpc_trials > self.pass1_iters

    def _fec(self, llrs: torch.Tensor, n_iters: int) -> dict:
        return run_fec(self.program, llrs, n_iters, self.fec, self._kt)

    # ------------------------------------------------------------------
    def dispatch_block(self, samples: np.ndarray) -> dict:
        """Upload one block of 2-sps samples and enqueue the device chain
        (symbol program, LDPC, BCH syndromes, packing) without waiting:
        returns a dict of tensors on the device. The host is free to
        finalize the previous block meanwhile."""
        s = np.asarray(samples)
        scale = np.sqrt(np.mean(np.abs(s) ** 2)) + 1e-30
        ri = np.stack([s.real, s.imag]).astype(np.float32) / np.float32(scale)
        with torch.no_grad():
            dev_in = torch.from_numpy(ri[None]).to(self.device,
                                                   non_blocking=True)
            out = {k: v[0] for k, v in self.program(dev_in).items()}
            llrs = out.pop("llrs")
            out.update(self._fec(llrs, self.pass1_iters))
        if self._two_pass:
            out["_llrs"] = llrs     # stays on the device, for escalation
        return out

    def finalize_block(self, out: dict) -> BlockResult:
        """Fetch a dispatched block's small outputs and run the host side:
        the full-budget rerun of a block with unconverged, well-synced
        frames, and BCH repair of flagged frames (only their hard-bit
        rows are fetched)."""
        cfg = self.cfg
        llrs = out.pop("_llrs", None)
        hard_dev = out.pop("hard")
        out = {k: v.cpu().numpy() for k, v in out.items()}
        F = out["ldpc_ok"].shape[0]
        retried = np.zeros(F, bool)
        hard2_dev = None
        if llrs is not None:
            retry = (~out["ldpc_ok"]) & (out["quality"] >= self.sof_threshold)
            if retry.any():
                with torch.no_grad():
                    out2 = self._fec(llrs, self.max_ldpc_trials)
                hard2_dev = out2.pop("hard")
                out2 = {k: v.cpu().numpy() for k, v in out2.items()}
                for k in ("ldpc_ok", "bch_bad", "kbch_bytes"):
                    out[k] = np.where(
                        retry.reshape((-1,) + (1,) * (out[k].ndim - 1)),
                        out2[k], out[k])
                out["trials"] = np.where(
                    retry, self.pass1_iters + out2["trials"], out["trials"])
                retried = retry
        plain = np.array(out["kbch_bytes"])   # descrambled on the device
        bch_bad = out["bch_bad"]
        # frames below the PL-sync correlation threshold are noise:
        # rejected before any host BCH work is spent on them
        sync_ok = out["quality"] >= self.sof_threshold
        bch_corr = np.full(F, -1, np.int32)
        frame_ok = sync_ok & ~bch_bad
        bch_corr[frame_ok] = 0
        for f in np.nonzero(sync_ok & bch_bad)[0]:
            hd = hard2_dev if retried[f] else hard_dev
            bits = hd[f, :cfg.nbch].cpu().numpy()
            fixed, ncorr = bch_spec.decode(bits, cfg.framesize, cfg.rate)
            bch_corr[f] = ncorr
            if ncorr < 0:
                # BCH-inconsistent even after repair: the LDPC decoder
                # settled on a wrong codeword; one garbage BBHEADER would
                # desync the TS parser, so the frame is rejected and the
                # parser gets a mark_gap instead
                continue
            frame_ok[f] = True
            plain[f] = scrambling.bb_scramble_bytes(
                np.packbits(fixed[:cfg.kbch]))
        return BlockResult(
            bbframes=plain[frame_ok],
            frame_ok=frame_ok,
            sync_quality=out["quality"],
            freq_err=out["freq"],
            ldpc_trials=out["trials"],
            bch_corrections=bch_corr,
            detected_pls=out["pls"].astype(np.int32),
            coarse_cfo=float(out["cfo"][0]),
            n_symbols=int(self.n_frames * cfg.plframe_len),
            last_frame_end=int(out["starts"][-1]) + cfg.plframe_len,
            constellation=(out["scatter"][0] +
                           1j * out["scatter"][1]).astype(np.complex64),
            detected_pls_conf=out["pls_conf"],
            starts=out["starts"],
        )

    def process_symbols_block(self, samples: np.ndarray) -> BlockResult:
        """Process one block of 2-sps samples (length 2*block_symbols)."""
        return self.finalize_block(self.dispatch_block(samples))
