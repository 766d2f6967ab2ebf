"""Time-block sharding: one carrier's stream split across ranks.

PyTorch port of dvbs_tpu/parallel/timeshard.py on torch.distributed
(parallel/collectives.py). A single high-rate carrier is sharded along
TIME: each rank owns A = 2 * F * L contiguous samples and decodes the
PL frames that start inside it. Its window is the streaming driver's
block, so it reaches `halo = 2 * block_symbols - A` samples into the
following shards: the overlap-save halo comes around the ring in
`ceil(halo / A)` successive `ring_shift`s, each forwarding one more
shard. With the halo attached each shard's output is the serial block
receiver's on the same window.

The last shard's halo wraps around to shard 0 (the ring closes), so its
trailing frames read wrapped samples: a streaming caller feeds slabs
with one shard of overlap, or ignores the last shard's frames.

`build_grid_sharded` lays ranks on a {carrier, time} grid: one time ring
per carrier, made by `dist.new_group`, and no cross-carrier traffic.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..profiling import span
from ..models.dvbs2 import DVBS2Receiver, run_fec
from . import collectives


class TimeShardedStep(nn.Module):
    """One rank's step: its shard of the global input, the halo from the
    ring, the receiver's symbol program and full-budget FEC on the
    window, then every rank's outputs gathered."""

    def __init__(self, rx: DVBS2Receiver, mesh: collectives.Mesh, A: int):
        super().__init__()
        self.rx = rx
        self.program = rx.program
        self.mesh = mesh
        self.A = A
        self.n = 2 * rx.block_symbols
        self.hops = -(-(self.n - A) // A)

    def window(self, chunk: torch.Tensor) -> torch.Tensor:
        """chunk [2, A] -> this rank's window [2, n]: its shard and the
        heads of the next `hops` shards of its time ring."""
        parts, nxt = [chunk], chunk
        with span("halo"):
            for _ in range(self.hops):
                nxt = collectives.ring_shift(nxt, self.mesh.time_group)
                parts.append(nxt)
        return torch.cat(parts, dim=-1)[:, :self.n]

    def forward(self, shards) -> dict:
        """shards: the global input, [D, 2, A] (or [C, T, 2, A] for the
        grid, read as [C*T, 2, A]), a numpy array or a tensor on any
        device; only this rank's shard is uploaded. Returns the
        per-shard outputs stacked on the mesh's axes, on every rank."""
        shape = tuple(self.mesh.shape.values())
        shards = shards.reshape((-1,) + tuple(shards.shape[-2:]))
        chunk = collectives.local_lanes(shards, self.mesh.rank, 1,
                                        self.mesh.device)[0]
        out = self.program(self.window(chunk.to(torch.float32))[None])
        out = {k: v[0] for k, v in out.items()}
        llrs = out.pop("llrs")
        out.pop("scatter")
        out.update(run_fec(self.program, llrs, self.rx.max_ldpc_trials,
                           "xla"))
        with span("gather"):
            out = collectives.gather_dict({k: v[None] for k, v in
                                           out.items()}, self.mesh.group)
        return {k: v.reshape(shape + tuple(v.shape[1:]))
                for k, v in out.items()}


def _geometry(mc: int, short: bool, block_symbols: int, device):
    rx = DVBS2Receiver(mc=mc, short=short, block_symbols=block_symbols,
                       device=device)
    A = 2 * rx.n_frames * rx.cfg.plframe_len     # samples owned per shard
    halo = 2 * block_symbols - A
    if halo <= 0:
        raise ValueError(f"block {block_symbols} yields no overlap "
                         f"(halo {halo})")
    return rx, A


def build_time_sharded(n_devices: int, mc: int = 4, short: bool = True,
                       block_symbols: int = 1 << 15, device=None):
    """The time-sharded demod step of this rank of an n_devices mesh (the
    default process group, collectives.init_mesh) on `device` (None:
    the card).

    Returns (step, example, mesh, A). step maps the global [D, 2, A]
    float32 input (rank d owns samples [d*A, (d+1)*A) of one carrier's
    2-sps stream) to the per-shard outputs stacked on axis 0, the same
    on every rank: the serial block receiver's symbol program and its
    full-budget FEC on each window (hard, trials, ldpc_ok, bch_bad,
    kbch_bytes, quality, freq, cfo, pls, pls_conf, starts).
    """
    device = collectives.mesh_device(device, n_devices)
    rx, A = _geometry(mc, short, block_symbols, device)
    mesh = collectives.Mesh(dict(time=n_devices), dist.group.WORLD, device,
                            time_group=dist.group.WORLD)
    step = TimeShardedStep(rx, mesh, A)
    example = np.zeros((n_devices, 2, A), np.float32)
    return step, example, mesh, A


def build_grid_sharded(n_carriers: int, n_time: int, mc: int = 4,
                       short: bool = True, block_symbols: int = 1 << 15,
                       device=None):
    """2D carrier x time sharding over n_carriers * n_time ranks: rank
    c * n_time + t owns slice t of carrier c's stream. Every rank makes
    every carrier's time ring (`dist.new_group`, in the same order);
    the halo rides this rank's ring only, so the carriers never talk.

    Returns (step, example, mesh, A); step maps [C, T, 2, A] to
    per-shard outputs stacked on [C, T, ...].
    """
    device = collectives.mesh_device(device, n_carriers * n_time)
    rx, A = _geometry(mc, short, block_symbols, device)
    rank = dist.get_rank()
    rings = [dist.new_group(list(range(c * n_time, (c + 1) * n_time)))
             for c in range(n_carriers)]
    mesh = collectives.Mesh(dict(carrier=n_carriers, time=n_time),
                            dist.group.WORLD, device,
                            time_group=rings[rank // n_time])
    step = TimeShardedStep(rx, mesh, A)
    example = np.zeros((n_carriers, n_time, 2, A), np.float32)
    return step, example, mesh, A

