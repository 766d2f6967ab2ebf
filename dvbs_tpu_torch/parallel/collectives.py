"""The port's device mesh on torch.distributed: one rank per device.

dvbs_tpu shards its programs with `shard_map` over a JAX mesh and one
controller sees global arrays. Here every rank is a process that runs
the same program on its own shard (SPMD), and the collectives below do
what the mesh axes did:

- `psum`: `jax.lax.psum`, an all_reduce;
- `ring_shift`: `jax.lax.ppermute` with the pairs (d, (d - 1) % n),
  each rank receiving its right neighbour's shard;
- `gather_lanes`: the `P("carrier")` / `P("time")` output layout, an
  all_gather concatenated in rank order, so every rank holds the
  global result.

`init_mesh` joins a rank to the group through a FileStore (no network):
NCCL with one card per rank, or gloo on the CPU. `spawn` starts the
ranks of a CPU or card mesh as processes from one caller. Under
torchrun a rank joins through torchrun's env:// rendezvous instead (a
TCP store, which also spans hosts) and names its card by its local
rank (`entry.main`); no test runs it across hosts.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import multiprocessing
import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=300)
SPAWN_DEADLINE = 900.0          # seconds for all of a spawn's ranks


@dataclasses.dataclass
class Mesh:
    """A process group with its axes: `shape` maps axis names to sizes
    ({"carrier": 4}, {"time": 4}, {"carrier": 2, "time": 2}), `group`
    is the whole mesh and `time_group` this rank's time ring (the whole
    mesh for a 1-D time mesh, None for a carrier mesh)."""
    shape: dict
    group: object
    device: torch.device
    time_group: object = None

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def init_mesh(world: int, rank: int, device, store_path: str | None = None
              ) -> torch.device:
    """Join rank `rank` of `world` to the default process group: NCCL on
    the CUDA device's card (`cuda:{rank}` when it names no index: the
    ranks of one host), gloo for the CPU. The ranks meet in a FileStore
    at `store_path` (a file none of them has used before); without one,
    at the address torchrun sets in the environment. Returns the rank's
    device."""
    device = torch.device(device)
    if device.type == "cuda":
        index = rank if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} has no card {index}: "
                               f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group for device {device}")
    kw = dict(backend=backend, rank=rank, world_size=world, timeout=TIMEOUT)
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return device


def close_mesh() -> None:
    """Leave the default process group (a no-op if there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_device(device, n_ranks: int) -> torch.device:
    """The device this rank of an `n_ranks` mesh runs on. `device` is
    the caller's (resolved: None means the card), and the default
    process group must be up with `n_ranks` ranks on the backend that
    serves it: NCCL for the card, gloo for the CPU."""
    from .. import backend
    device = backend.resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.collectives."
                           "init_mesh (or run under torchrun) first")
    world = dist.get_world_size()
    if world != n_ranks:
        raise ValueError(f"a mesh of {n_ranks} ranks, but the process group "
                         f"has {world}")
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"{device.type} ranks need a {want} process group, "
                           f"not {dist.get_backend()}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of x over the group's ranks, on every rank."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def ring_shift(x: torch.Tensor, group=None) -> torch.Tensor:
    """The shard of the next rank of the ring (group rank r receives
    from r + 1 and sends to r - 1, mod its size). In a ring of one a
    rank is its own neighbour: x itself."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    peer = (lambda g: g) if group is None else \
        (lambda g: dist.get_global_rank(group, g))
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer((r - 1) % n), group),
        dist.P2POp(dist.irecv, out, peer((r + 1) % n), group)])
    for req in reqs:
        req.wait()
    return out


def gather_lanes(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x concatenated along axis 0 in rank order, on every
    rank. Booleans travel as uint8."""
    n = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    x = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if is_bool else out


def gather_dict(d: dict, group=None) -> dict:
    """gather_lanes of every tensor of d."""
    return {k: gather_lanes(v, group) for k, v in d.items()}


def local_lanes(x, rank: int, per_rank: int, device: torch.device
                ) -> torch.Tensor:
    """This rank's lanes x[rank * per_rank : (rank + 1) * per_rank] of a
    global input (numpy array or tensor on any device), on `device`:
    only these lanes are uploaded."""
    x = x[rank * per_rank:(rank + 1) * per_rank]
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x.copy())
    return x.to(device)


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(fn_name: str, rank: int, world: int, device: str,
               store_path: str, args: tuple, results) -> None:
    """One spawned rank: join the mesh, run fn(*args), report."""
    torch.set_num_threads(1)
    try:
        init_mesh(world, rank, device, store_path)
        mod, name = fn_name.rsplit(".", 1)
        out = getattr(importlib.import_module(mod), name)(*args)
        results.put((rank, True, out))
    except Exception:                       # reported to the caller
        results.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


def spawn(fn, world: int, device, *args) -> list:
    """Run fn(*args) on `world` ranks, each a spawned process that has
    joined the default group (gloo for device "cpu", NCCL on one card a
    rank for "cuda"); returns the ranks' results in rank order. `fn` is
    a module-level function of an importable module, and its arguments
    and result are pickled. A rank that raises, or the whole run taking
    longer than SPAWN_DEADLINE seconds, raises RuntimeError after every
    rank is stopped."""
    device = torch.device(device)
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks need {world} cards; "
                           f"{torch.cuda.device_count()} CUDA devices")
    name = f"{fn.__module__}.{fn.__qualname__}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    outs, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            name, r, world, device.type, os.path.join(tmp, "store"), args,
            results)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = datetime.datetime.now() + \
                datetime.timedelta(seconds=SPAWN_DEADLINE)
            while len(outs) + len(errors) < world:
                left = (deadline - datetime.datetime.now()).total_seconds()
                try:
                    rank, ok, out = results.get(
                        timeout=min(max(left, 0.1), 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if left > 0 and not dead:
                        continue
                    errors.append(f"ranks {sorted(set(range(world)) - set(outs))}"
                                  f" gave no result (exit codes "
                                  f"{[p.exitcode for p in procs]})")
                    break
                if ok:
                    outs[rank] = out
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            if errors:
                for p in procs:
                    p.terminate()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError(f"{name} on {world} {device.type} ranks failed: "
                           + "\n".join(errors))
    return [outs[r] for r in range(world)]
