"""Single-device multi-carrier bank: every carrier of a block in one step.

PyTorch port of `bank_block_symbols` and `build_carrier_bank` of
dvbs_tpu/parallel/mesh.py. The JAX version vmaps the per-carrier symbol
program; here the program is batched over carriers, and the FEC decodes
all C*F frames of the block (the int8 layered decoder in 128-frame
calls, or the float decode_qc), then checks BCH syndromes, packs the
kbch bits to bytes and BB-descrambles them on the device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..spec import modcod
from ..models.dvbs2 import DVBS2Receiver, frames_per_block, run_fec
from ..ops import frontend, ldpc_kernel


def bank_block_symbols(n_carriers: int = 8, mc: int = 4,
                       short: bool = False, pilots: bool = False,
                       frames_total: int = 128) -> int:
    """Smallest per-carrier block that brings the bank's frame total to
    `frames_total` without exceeding it (mesh.bank_block_symbols)."""
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    per = max(1, frames_total // n_carriers)
    raw = (per + 1) * cfg.plframe_len + 2 * 256 + 90
    return -(-raw // 64) * 64


class CarrierBank(nn.Module):
    """The bank step: symbol program + FEC + BCH check + packing."""

    def __init__(self, rx: DVBS2Receiver, n_carriers: int, n_iters: int,
                 ingest: str, stream_outputs: bool):
        super().__init__()
        self.rx = rx
        self.program = rx.program
        self.C = n_carriers
        self.n_iters = n_iters
        self.ingest = ingest
        self.stream_outputs = stream_outputs

    def fec(self, llrs: torch.Tensor, n_iters: int) -> dict:
        """llrs [C*F, nldpc] float -> kbch_bytes, trials, ldpc_ok,
        bch_bad (and hard with stream_outputs)."""
        return run_fec(self.program, llrs, n_iters, self.rx.fec,
                       self.rx._kt, keep_hard=self.stream_outputs)

    def forward(self, samples: torch.Tensor) -> dict:
        if self.ingest == "cs4":
            with record_function("frontend"):
                samples = frontend.unpack_cs4(samples)
        out = self.program(samples)
        llrs = out["llrs"].reshape(-1, self.rx.cfg.nldpc)
        fd = self.fec(llrs, self.n_iters)
        fd.update(quality=out["quality"], pls=out["pls"],
                  pls_conf=out["pls_conf"])
        if self.stream_outputs:
            fd.update(starts=out["starts"], cfo=out["cfo"],
                      freq=out["freq"], llrs=llrs)
        return fd


def build_carrier_bank(n_carriers: int, mc: int = 4, short: bool = False,
                       pilots: bool = False, block_symbols: int = 1 << 17,
                       n_iters: int = 12, fec: str = "auto",
                       ingest: str = "cs8", stream_outputs: bool = False,
                       n_iters_full: int = 32, device=None,
                       np_tables: dict | None = None):
    """The bank on `device` (None: the card): returns (step_fn, example_input), or with
    stream_outputs (step_fn, example_input, escalate_fn).

    step(samples) maps cs8 int8 [C, 2, n] or cs4 uint8 [C, n] (ingest)
    to kbch_bytes [C*F, kbch/8] uint8 (BB-descrambled), trials, ldpc_ok,
    bch_bad [C*F], quality, pls, pls_conf [C, F]; stream_outputs adds
    starts [C, F], cfo [C, 1], freq [C, F], hard [C*F, nldpc] and llrs
    [C*F, nldpc], and escalate(llrs) reruns the FEC at n_iters_full.

    fec: "int8" or "pallas" (the int8 layered decoder), "xla" (the
    float decode_qc), or "auto": as dvbs_tpu, the int8 decoder when the
    bank's frame total C * F is one decode call's CALL_FRAMES (128, the
    size bank_block_symbols gives), the float decoder otherwise.
    """
    if fec == "auto":
        F = frames_per_block(modcod.get_config(mc, short=short,
                                               pilots=pilots), block_symbols)
        fec = "pallas" if n_carriers * F == ldpc_kernel.CALL_FRAMES \
            else "xla"
    elif fec == "int8":
        fec = "pallas"
    if fec not in ("pallas", "xla"):
        raise ValueError(f"unknown fec {fec!r}")
    if ingest not in ("cs8", "cs4"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    rx = DVBS2Receiver(mc=mc, short=short, pilots=pilots,
                       block_symbols=block_symbols,
                       max_ldpc_trials=n_iters, fec=fec, device=device,
                       np_tables=np_tables)
    bank = CarrierBank(rx, n_carriers, n_iters, ingest, stream_outputs)
    if ingest == "cs4":
        example = np.zeros((n_carriers, 2 * block_symbols), np.uint8)
    else:
        example = np.zeros((n_carriers, 2, 2 * block_symbols), np.int8)
    if not stream_outputs:
        return bank, example

    def escalate(llrs: torch.Tensor) -> dict:
        """Full-budget rerun of every lane."""
        return bank.fec(llrs, n_iters_full)
    return bank, example, escalate
