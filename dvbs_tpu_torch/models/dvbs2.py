"""DVB-S2 receiver geometry and its block symbol program, batched over
carriers.

PyTorch port of dvbs_tpu/models/dvbs2.py (DVBS2Receiver and the `_build`
program): samples -> AGC -> coarse CFO mix -> RRC matched filter ->
feed-forward timing recovery -> PL-frame sync -> block-common FED and
L&R frequency -> header phase -> phase track -> PLS detect -> soft demap
-> deinterleave, for C carriers at once. With pilots (any
constellation) the phase track is the pilot-anchor track and the
payload is the frame with its pilot blocks cut out; without pilots the
port runs QPSK, whose 4th-power V&V track follows the header phase.
Pilotless 8PSK, 16APSK and 32APSK (the decision-directed track) raise.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from dvbs_tpu.spec import modcod
from .. import tables
from ..ops import demap, frontend, interleaver, plhdr, plphase, plsync

_ROADMAP = ("pilotless {} (plphase.dd_phase_track) is not ported yet "
            "(ROADMAP queue 1): the port's receiver runs every "
            "constellation with pilots, and QPSK without")


class SymbolProgram(nn.Module):
    """The per-block symbol program of one receiver geometry. Its
    buffers are the constant tables (tables.receiver_tables, or a dict
    of the same keys); forward maps samples [C, 2, n] (int8 or float,
    stacked I/Q) to per-carrier outputs."""

    def __init__(self, cfg: modcod.ModcodConfig, block_symbols: int,
                 n_frames: int, edge_margin: int, device,
                 np_tables: dict | None = None):
        super().__init__()
        if not cfg.pilots and cfg.constellation != modcod.QPSK:
            raise NotImplementedError(_ROADMAP.format(cfg.constellation))
        self.cfg = cfg
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
        with record_function("plsync"):
            score, _ = plsync.correlate(z, self.corr_T)
            starts, quality = plsync.locate_frames(
                score, L, F, margin=self.edge_margin)
            frames = plsync.extract_frames(z, starts, L)     # [C, F, L]
        with record_function("phase"):
            pilots = (self.pstarts, self.pilot_descr) if cfg.pilots else None
            fed = plphase.coarse_fed_common(frames, self.hdr_syms, pilots)
            frames = plphase.apply_freq(frames, fed[:, None].expand(C, F))
            flr = plphase.lr_freq_common(frames, self.hdr_syms, pilots)
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
                vv = plphase.qpsk_vv_track(payload, torch.zeros_like(theta0))
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


class DVBS2Receiver:
    """Fixed-MODCOD receiver geometry (dvbs2.DVBS2Receiver.__init__) and
    its symbol program on `device`."""

    def __init__(self, mc: int = 4, short: bool = True, pilots: bool = False,
                 block_symbols: int = 1 << 15, max_ldpc_trials: int = 32,
                 sof_threshold: float = 0.6, device="cpu",
                 np_tables: dict | None = None):
        self.cfg = modcod.get_config(mc, short=short, pilots=pilots)
        self.block_symbols = block_symbols
        self.max_ldpc_trials = max_ldpc_trials
        self.sof_threshold = sof_threshold
        L = self.cfg.plframe_len
        self.edge_margin = 256
        self.n_frames = (block_symbols - 2 * self.edge_margin - 90) // L - 1
        if self.n_frames < 1:
            raise ValueError("block_symbols must cover at least 2 PL frames")
        self.device = torch.device(device)
        self.program = SymbolProgram(self.cfg, block_symbols, self.n_frames,
                                     self.edge_margin, self.device,
                                     np_tables)
