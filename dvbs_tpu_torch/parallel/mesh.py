"""Multi-carrier banks: on one device, and sharded over carrier ranks.

PyTorch port of dvbs_tpu/parallel/mesh.py.

- `bank_block_symbols` and `build_carrier_bank`: the single-device
  bank. The JAX version vmaps the per-carrier symbol program; here the
  program is batched over carriers, and the FEC decodes all C*F frames
  of the block (the int8 layered decoder in 128-frame calls, or the
  float decode_qc), then checks BCH syndromes, packs the kbch bits to
  bytes and BB-descrambles them on the device.
- `build_multi_carrier` and `build_carrier_bank_sharded`: the same
  programs over a `carrier` mesh of torch.distributed ranks
  (parallel/collectives.py), one device each. Every rank runs its own
  carriers and ends in an all_gather, so each rank holds the global
  outputs that dvbs_tpu's shard_map returns to its one controller; the
  sharded bank's triple drives DVBS2BankStream unchanged, its host tail
  running alike on every rank. The bank's llrs stay on their rank, as
  dvbs_tpu keeps them sharded: only the escalation reads them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from .. import graphs
from ..profiling import span
from ..spec import modcod
from ..models.dvbs2 import (EDGE_MARGIN, DVBS2Receiver, frames_per_block,
                            run_fec)
from ..ops import frontend, ldpc_kernel
from . import collectives


def bank_block_symbols(n_carriers: int = 8, mc: int = 4,
                       short: bool = False, pilots: bool = False,
                       frames_total: int = 128) -> int:
    """Smallest per-carrier block that brings the bank's frame total to
    `frames_total` without exceeding it (mesh.bank_block_symbols)."""
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    per = max(1, frames_total // n_carriers)
    raw = (per + 1) * cfg.plframe_len + 2 * EDGE_MARGIN + 90
    return -(-raw // 64) * 64


class CarrierBank(nn.Module):
    """The bank step: symbol program + FEC + BCH check + packing.

    On a CUDA input the step runs as CUDA graphs (graphs.StepGraph): the
    first call for an input key (shape, dtype, device) runs `enqueue`
    eagerly, which sets up what a capture cannot; the second captures it
    in segments cut at its layer spans; every later call replays them
    inside those spans. A new key captures again; a CPU input runs
    eagerly. `counts` holds the steps run eagerly and replayed and the
    captures (each capture's call also replays)."""

    def __init__(self, rx: DVBS2Receiver, n_carriers: int, n_iters: int,
                 ingest: str, stream_outputs: bool):
        super().__init__()
        self.rx = rx
        self.program = rx.program
        self.C = n_carriers
        self.n_iters = n_iters
        self.ingest = ingest
        self.stream_outputs = stream_outputs
        self.counts = dict(graph_captures=0, graph_replays=0, eager_steps=0)
        self._graph = None          # the chain of the latest key captured
        self._warm = set()          # keys run eagerly once

    def fec(self, llrs: torch.Tensor, n_iters: int) -> dict:
        """llrs [C*F, nldpc] float -> kbch_bytes, trials, ldpc_ok,
        bch_bad (and hard with stream_outputs)."""
        return run_fec(self.program, llrs, n_iters, self.rx.fec,
                       self.rx._kt, keep_hard=self.stream_outputs)

    def forward(self, samples: torch.Tensor) -> dict:
        with span("bank.step"):
            key = graphs.input_key(samples)
            if samples.device.type != "cuda" or key not in self._warm:
                self._warm.add(key)
                self.counts["eager_steps"] += 1
                return self.enqueue(samples)
            if self._graph is None or self._graph.key != key:
                self._graph = None          # its pool goes first
                self._graph = graphs.StepGraph(self.enqueue, samples)
                self.counts["graph_captures"] += 1
            self.counts["graph_replays"] += 1
            return self._graph(samples)

    def enqueue(self, samples: torch.Tensor) -> dict:
        """The step's launches (forward less its `bank.step` span)."""
        if self.ingest == "cs4":
            with span("frontend"):
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


# ---------------------------------------------------------------------------
# sharded over a carrier mesh
# ---------------------------------------------------------------------------

class MultiCarrierStep(nn.Module):
    """One rank's multi-carrier demod step: its carriers through the
    receiver's symbol program and full-budget FEC, the lock count summed
    over the mesh, the outputs gathered."""

    def __init__(self, rx: DVBS2Receiver, mesh: collectives.Mesh, cl: int):
        super().__init__()
        self.rx = rx
        self.program = rx.program
        self.mesh = mesh
        self.cl = cl

    def forward(self, samples) -> dict:
        """samples: the global [C, 2, n] input (numpy or a tensor on any
        device); only this rank's carriers are uploaded. Returns hard
        [C, F, nldpc], trials, ldpc_ok, quality, pls [C, F] and locked
        [1] (frames decoded over the mesh), on every rank."""
        x = collectives.local_lanes(samples, self.mesh.rank, self.cl,
                                    self.mesh.device)
        out = self.program(x)
        llrs = out["llrs"]                       # [c, F, N]
        c, F, N = llrs.shape
        fd = run_fec(self.program, llrs.reshape(c * F, N),
                     self.rx.max_ldpc_trials, "xla")
        ok = fd["ldpc_ok"].reshape(c, F)
        locked = collectives.psum(ok.sum(dtype=torch.int32).reshape(1),
                                  self.mesh.group)
        with span("gather"):
            g = collectives.gather_dict(dict(
                hard=fd["hard"].reshape(c, F, N),
                trials=fd["trials"].reshape(c, F), ldpc_ok=ok,
                quality=out["quality"], pls=out["pls"]), self.mesh.group)
        g["locked"] = locked
        return g


def build_multi_carrier(n_devices: int, carriers_per_device: int = 1,
                        mc: int = 4, short: bool = True,
                        block_symbols: int = 1 << 15, device=None):
    """The multi-carrier demod step of this rank of an n_devices carrier
    mesh (the default process group, collectives.init_mesh) on `device`
    (None: the card).

    Returns (step, example, mesh). step maps the global [C, 2, n] float
    input (rank d owns carriers [d*cpd, (d+1)*cpd)) to the per-carrier
    outputs plus the mesh's lock count "locked" [1], the same on every
    rank. FEC: the float decode_qc at the receiver's full trial budget,
    as dvbs_tpu's (no host escalation inside the step).
    """
    device = collectives.mesh_device(device, n_devices)
    rx = DVBS2Receiver(mc=mc, short=short, block_symbols=block_symbols,
                       device=device)
    mesh = collectives.Mesh(dict(carrier=n_devices), dist.group.WORLD,
                            device)
    step = MultiCarrierStep(rx, mesh, carriers_per_device)
    example = np.zeros((n_devices * carriers_per_device, 2,
                        2 * block_symbols), np.float16)
    return step, example, mesh


class ShardedBank(nn.Module):
    """One rank's step of the sharded bank: the single-device bank
    (CarrierBank, float decode_qc over all local lanes) on its carriers,
    every output but the llrs gathered. `input_device` is the CPU: a
    stream hands the step its host block and each rank uploads its own
    carriers."""

    input_device = torch.device("cpu")

    def __init__(self, bank: CarrierBank, mesh: collectives.Mesh,
                 n_iters_full: int):
        super().__init__()
        self.bank = bank
        self.mesh = mesh
        self.n_iters_full = n_iters_full

    def forward(self, samples) -> dict:
        with span("bank.step"):
            x = collectives.local_lanes(samples, self.mesh.rank, self.bank.C,
                                        self.mesh.device)
            out = self.bank.enqueue(x)
            llrs = out.pop("llrs")
            with span("gather"):
                out = collectives.gather_dict(out, self.mesh.group)
            out["llrs"] = llrs
            return out

    def escalate(self, llrs: torch.Tensor) -> dict:
        """Full-budget rerun: this rank's llrs (the step's "llrs") decoded
        at n_iters_full, gathered."""
        return collectives.gather_dict(self.bank.fec(llrs, self.n_iters_full),
                                       self.mesh.group)


def build_carrier_bank_sharded(n_devices: int, carriers_per_device: int = 1,
                               mc: int = 4, short: bool = False,
                               pilots: bool = False,
                               block_symbols: int | None = None,
                               n_iters: int = 12, n_iters_full: int = 32,
                               ingest: str = "cs8", device=None):
    """The carrier-sharded bank with DVBS2BankStream's output contract,
    for this rank of an n_devices mesh on `device` (None: the card).

    Returns (step, example, escalate), the triple DVBS2BankStream takes
    as `program=`. step maps the global cs8 int8 [C, 2, n] or cs4 uint8
    [C, n] block (C = n_devices * carriers_per_device) to
    build_carrier_bank's stream outputs for all C carriers on every
    rank, but for "llrs": this rank's lanes only [cpd*F, nldpc];
    escalate(llrs) reruns them at n_iters_full and gathers the result.
    FEC is the float decode_qc, as in dvbs_tpu.
    """
    device = collectives.mesh_device(device, n_devices)
    if ingest not in ("cs8", "cs4"):
        raise ValueError(f"unknown ingest format {ingest!r}")
    C = n_devices * carriers_per_device
    if block_symbols is None:
        block_symbols = bank_block_symbols(C, mc=mc, short=short,
                                           pilots=pilots)
    rx = DVBS2Receiver(mc=mc, short=short, pilots=pilots,
                       block_symbols=block_symbols,
                       max_ldpc_trials=n_iters, fec="xla", device=device)
    mesh = collectives.Mesh(dict(carrier=n_devices), dist.group.WORLD,
                            device)
    step = ShardedBank(CarrierBank(rx, carriers_per_device, n_iters, ingest,
                                   stream_outputs=True), mesh, n_iters_full)
    if ingest == "cs4":
        example = np.zeros((C, 2 * block_symbols), np.uint8)
    else:
        example = np.zeros((C, 2, 2 * block_symbols), np.int8)
    return step, example, step.escalate
