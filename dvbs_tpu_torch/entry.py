"""Entry points of the port: a single-card compile check and the
multi-device dry run, the PyTorch twins of dvbs_tpu's
`__graft_entry__.entry` and `dryrun_multichip`.

The rank programs below (`*_rank`) are what each spawned rank of
`parallel.collectives.spawn` runs: module-level functions of the
package, so a rank imports torch and this package and nothing else.

    python -m dvbs_tpu_torch.entry 4 --device cpu   # 4 gloo ranks
    torchrun --nproc-per-node=<cards> -m dvbs_tpu_torch.entry

(under torchrun each process is one rank: NCCL on the card of its
local rank, so the same command on several hosts, each given torchrun's
--nnodes, --node-rank and --rdzv-endpoint, spans them).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import backend
from .parallel import collectives

BLOCK = 1 << 15                 # symbols a block: QPSK 1/2 short frames


def entry(device=None):
    """(program, example_args): the single-carrier DVB-S2 block program
    of the flagship configuration (QPSK 1/2 short frames, 2^15 symbols)
    on `device` (None: the card). The port's program is batched over
    carriers and maps [C, 2, n] samples, here C = 1; dvbs_tpu's `_sym_fn`
    maps one carrier's [2, n]."""
    from .models.dvbs2 import DVBS2Receiver
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=BLOCK, device=device)
    example = torch.zeros((1, 2, 2 * BLOCK), dtype=torch.float32,
                          device=rx.device)
    return rx.program, (example,)


def _rank_device():
    """The device of a rank of the default group: the CPU for gloo, the
    rank's card for NCCL."""
    return "cpu" if dist.get_backend() == "gloo" else None


def _numpy(d: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in d.items()}


def multi_carrier_rank(samples: np.ndarray, carriers_per_device: int
                       ) -> dict:
    """A rank of build_multi_carrier (the flagship block) over the whole
    group: one step on the global `samples`; the gathered outputs as
    numpy."""
    from .parallel.mesh import build_multi_carrier
    step, _, _ = build_multi_carrier(
        dist.get_world_size(), carriers_per_device, 4, True, BLOCK,
        device=_rank_device())
    with torch.no_grad():
        return _numpy(step(samples))


def time_sharded_rank(shards: np.ndarray, mc: int = 4, short: bool = True,
                      block_symbols: int = BLOCK) -> dict:
    """A rank of build_time_sharded over the whole group: one step on the
    global [D, 2, A] `shards`; the gathered outputs as numpy."""
    from .parallel.timeshard import build_time_sharded
    step, _, _, _ = build_time_sharded(dist.get_world_size(), mc, short,
                                       block_symbols, device=_rank_device())
    with torch.no_grad():
        return _numpy(step(shards))


def grid_sharded_rank(shards: np.ndarray) -> dict:
    """A rank of build_grid_sharded (the flagship block) on the global
    [C, T, 2, A] `shards`; the gathered outputs as numpy."""
    from .parallel.timeshard import build_grid_sharded
    step, _, _, _ = build_grid_sharded(shards.shape[0], shards.shape[1], 4,
                                       True, BLOCK, device=_rank_device())
    with torch.no_grad():
        return _numpy(step(shards))


def bank_step_rank(samples: np.ndarray, carriers_per_device: int,
                   block_symbols: int, n_iters: int) -> tuple:
    """A rank of build_carrier_bank_sharded (QPSK 1/2 short frames, cs4):
    one step on the global `samples` (gathered, but the llrs: this
    rank's lanes) and the full-budget escalation of its llrs (gathered),
    as numpy."""
    from .parallel.mesh import build_carrier_bank_sharded
    step, _, escalate = build_carrier_bank_sharded(
        dist.get_world_size(), carriers_per_device, mc=4, short=True,
        block_symbols=block_symbols, n_iters=n_iters, ingest="cs4",
        device=_rank_device())
    with torch.no_grad():
        out = step(samples)
        return _numpy(out), _numpy(escalate(out["llrs"]))


def bank_stream_rank(sigs: list, block_symbols: int) -> dict:
    """A rank of the dry run's DVBS2BankStream over
    build_carrier_bank_sharded (a carrier a rank, QPSK 1/2 short frames,
    cs8, 16 sweeps): every carrier's signal fed a block at a time, then
    flushed. Returns each carrier's TS bytes, the stream's frames_ok and
    frames_seen, and its frames a block F."""
    from .models.bank_stream import DVBS2BankStream
    from .parallel.mesh import build_carrier_bank_sharded
    C = dist.get_world_size()
    program = build_carrier_bank_sharded(
        C, 1, mc=4, short=True, block_symbols=block_symbols, n_iters=16,
        ingest="cs8", device=_rank_device())
    st = DVBS2BankStream(C, mc=4, short=True, block_symbols=block_symbols,
                         ingest="cs8", program=program,
                         device=program[0].mesh.device)
    nblk = 2 * st.block_symbols
    outs = [bytearray() for _ in range(C)]
    for lo in range(0, len(sigs[0]), nblk):
        for o, ts in zip(outs, st.feed([s[lo:lo + nblk] for s in sigs])):
            o.extend(ts)
    for o, ts in zip(outs, st.flush()):
        o.extend(ts)
    return dict(ts=[bytes(o) for o in outs], frames_ok=st.frames_ok,
                frames_seen=st.frames_seen, F=st.F)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _signal(cfg, n_pkts: int, pkt_seed: int, snr_db: float, cfo: float,
            delay: float, seed: int):
    """(2-sps impaired samples, packets sent) of one carrier."""
    from .tx import channel, dvbs2_mod
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=pkt_seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=snr_db, cfo=cfo,
                       delay_samples=delay, seed=seed)
    return y, pkts


def multi_carrier_signals(C: int, n: int) -> np.ndarray:
    """The dry run's distinct carriers (payload, CFO, SNR, delay), float32
    [C, 2, n]: a broken shard fails its own carrier's check."""
    from .spec import modcod
    cfg = modcod.get_config(4, short=True)
    out = np.zeros((C, 2, n), np.float32)
    for c in range(C):
        y, _ = _signal(cfg, 160, 100 + c, 7.0 + 0.5 * c,
                       (0.002 + 0.003 * c) * np.pi, 0.1 * c, c)
        out[c] = np.stack([y[:n].real, y[:n].imag])
    return out


def grid_signals(C: int, T: int, A: int) -> np.ndarray:
    """The dry run's grid input [C, T, 2, A]: carrier c's stream cut
    into T slices of A samples."""
    from .spec import modcod
    cfg = modcod.get_config(4, short=True)
    out = np.zeros((C, T, 2, A), np.float32)
    for c in range(C):
        y, _ = _signal(cfg, 400, 200 + c, 8.0, 0.002 * (c + 1) * np.pi, 0.0,
                       300 + c)
        for t in range(T):
            yt = y[t * A:(t + 1) * A]
            out[c, t] = np.stack([yt.real, yt.imag])
    return out


def stream_signals(C: int, need: int):
    """The dry run's streamed carriers: ([samples per carrier], [packet
    bytes sent per carrier])."""
    from .spec import modcod
    cfg = modcod.get_config(4, short=True)
    sigs, sents = [], []
    for c in range(C):
        y, pkts = _signal(cfg, 220, 400 + c, 8.0, 0.003 * (c + 1) * np.pi,
                          0.1 * c, 500 + c)
        if len(y) < need:
            raise ValueError(f"carrier {c}: {len(y)} samples < {need}")
        sigs.append(y[:need])
        sents.append(pkts.tobytes())
    return sigs, sents


def dryrun_rank(n_devices: int) -> list:
    """One rank of the dry run (dvbs_tpu's __graft_entry__.dryrun_multichip
    on torch.distributed): its three parts, each checked; returns the
    lines it reports."""
    from .models.dvbs2 import frames_per_block
    from .parallel.mesh import bank_block_symbols
    from .spec import modcod
    cfg = modcod.get_config(4, short=True)
    lines = []
    # the multi-carrier step, a distinct signal per carrier
    out = multi_carrier_rank(multi_carrier_signals(n_devices, 2 * BLOCK), 1)
    ok = out["ldpc_ok"]                            # [C, F]
    locked = int(out["locked"][0])
    per_carrier = ok.all(axis=1)
    if not per_carrier.all():
        raise AssertionError(f"carriers failed: "
                             f"{np.nonzero(~per_carrier)[0].tolist()} "
                             f"(ok map {ok.tolist()})")
    if locked != ok.size:
        raise AssertionError(f"only {locked}/{ok.size} frames locked")
    lines.append(f"dryrun_multichip({n_devices}): {locked}/{ok.size} frames "
                 f"decoded across a {n_devices}-rank carrier mesh; "
                 f"per-carrier signals distinct")
    if n_devices % 2 == 0 and n_devices >= 4:
        # the {carrier, time} grid: each carrier's own halo ring
        C, T = n_devices // 2, 2
        L = cfg.plframe_len
        F = frames_per_block(cfg, BLOCK)
        gout = grid_sharded_rank(grid_signals(C, T, 2 * F * L))
        gok = gout["ldpc_ok"]                      # [C, T, F]
        if not gok[:, 0].all():
            raise AssertionError(f"grid shards failed: {gok.tolist()}")
        lines.append(f"dryrun_multichip({n_devices}): 2D grid "
                     f"{{'carrier': {C}, 'time': {T}}} halo-exchange decode "
                     f"ok ({int(gok[:, 0].sum())} wrap-free frames)")
    # the streaming driver over the sharded bank: >= 2 block seams
    bs = bank_block_symbols(n_devices, mc=4, short=True, frames_total=8)
    F = frames_per_block(cfg, bs)
    need = 2 * bs + 2 * 2 * F * cfg.plframe_len + 2 * cfg.plframe_len
    sigs, sents = stream_signals(n_devices, need)
    st = bank_stream_rank(sigs, bs)
    if not ((st["frames_ok"] == st["frames_seen"]).all() and
            (st["frames_seen"] >= 3 * F).all()):
        raise AssertionError(f"sharded stream lost frames: "
                             f"{st['frames_ok']}/{st['frames_seen']}")
    for c in range(n_devices):
        got = st["ts"][c]
        if not (len(got) >= 188 * 10 and sents[c].find(got[:188 * 5]) >= 0):
            raise AssertionError(f"carrier {c} TS mismatch")
    lines.append(f"dryrun_multichip({n_devices}): DVBS2BankStream streamed "
                 f"{int(st['frames_seen'][0])} frames/carrier across a "
                 f"{n_devices}-rank mesh with contiguous TS")
    return lines


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the multi-device dry run over n_devices ranks, each checked as
    dvbs_tpu's dryrun_multichip checks its mesh (same signals, seeds and
    assertions): the multi-carrier step (every frame of every distinct
    carrier, locked == C*F), the {n/2, 2} grid for even n >= 4 (every
    wrap-free shard), and DVBS2BankStream over build_carrier_bank_sharded
    (contiguous TS per carrier).

    device "cpu" spawns n gloo ranks on the CPU; the card (None) spawns
    one NCCL rank per card and raises RuntimeError if there are fewer
    than n_devices. The twin of dvbs_tpu's tools/dryrun_multihost.py is
    the same rank program, `dryrun_rank`, under torchrun on each host
    (`main`): the global rank joins through torchrun's TCP store and the
    local rank picks the card. No test runs it across hosts.
    """
    device = backend.resolve_device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}): "
                           f"{torch.cuda.device_count()} CUDA devices")
    lines = collectives.spawn(dryrun_rank, n_devices, device.type, n_devices)
    for line in lines[0]:
        print(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's multi-device dry "
                                 "run")
    ap.add_argument("n_devices", type=int, nargs="?", default=1)
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks; default: the cards")
    args = ap.parse_args(argv)
    if all(k in os.environ for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE")):
        # under torchrun: this process is one rank, on its host's card
        # of its local rank
        dev = backend.resolve_device(args.device)
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        world = int(os.environ["WORLD_SIZE"])
        collectives.init_mesh(world, int(os.environ["RANK"]), dev)
        try:
            lines = dryrun_rank(world)
        finally:
            collectives.close_mesh()
        if int(os.environ["RANK"]) == 0:
            print("\n".join(lines))
        return 0
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
