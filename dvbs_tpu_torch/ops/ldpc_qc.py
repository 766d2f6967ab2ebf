"""QC-LDPC posterior layout and the float layered decoder.

PyTorch port of dvbs_tpu/ops/ldpc_qc.py. In the POST layout
[G+q, 360, B] info bit i sits at (i // 360, i % 360) and parity bit
a = r + q*c at (G + r, c), so both directions are a reshape and a
transpose. `decode_qc` is the float layered offset-min-sum decoder with
bf16 messages and per-frame trial counts: plain PyTorch, as the JAX
version is plain XLA. Where the JAX version rolls [360, B] tiles, this
one gathers a layer's rolled tiles with one precomputed index and adds
the deltas back with index_add_, one call per occurrence rank of a group
within the layer so that no call hits an element twice and the sums
keep the JAX version's order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables
from ..tables import LANES


def llr_to_post(llr: torch.Tensor, G: int, q: int) -> torch.Tensor:
    """[B, N] codeword order -> POST layout [G+q, 360, B]."""
    B = llr.shape[0]
    K = G * LANES
    info = llr[:, :K].T.reshape(G, LANES, B)
    par = llr[:, K:].reshape(B, LANES, q).permute(2, 1, 0)
    return torch.cat([info, par], dim=0)


def post_to_hard(post: torch.Tensor, G: int, q: int) -> torch.Tensor:
    """POST layout [G+q, 360, B] -> hard bits [B, N] uint8."""
    B = post.shape[-1]
    info = (post[:G].reshape(G * LANES, B) < 0).to(torch.uint8).T
    par = (post[G:].permute(2, 1, 0) < 0).to(torch.uint8).reshape(B, q * LANES)
    return torch.cat([info, par], dim=1)


@functools.lru_cache()
def _schedule(table: str) -> dict:
    """The decoder's static index tables (numpy), from the schedule of
    tables.kernel_tables (entry e of layer r reads group g rolled by s;
    the last two valid entries are the parity groups, and layer 0's
    wrap edge carries F_MASK0). Per layer r: idx [D, 360] flat POST
    rows that entry e reads (roll(post[g], s)[c] = post[g, (c - s) %
    360]) and ranks, the entries grouped by occurrence rank of their
    group. For the syndrome: idx_all [q, Dmax, 360] and valid_all, with
    padding and the wrap edge marked invalid."""
    kt = tables.kernel_tables(table)
    q, Dmax = kt["q"], kt["Dmax"]
    c = np.arange(LANES)
    layers = []
    idx_all = np.zeros((q, Dmax, LANES), np.int64)
    valid_all = np.zeros((q, Dmax, LANES), bool)
    for r in range(q):
        ents = [(int(g), int(s), int(f)) for g, s, f in zip(
            kt["g_tab"][r], kt["s_tab"][r], kt["f_tab"][r])
            if f & tables.F_VALID]
        idx = np.stack([g * LANES + (c - s) % LANES for g, s, _ in ents])
        seen: dict = {}
        ranks: list = []
        for e, (g, _, _) in enumerate(ents):
            k = seen.get(g, 0)
            seen[g] = k + 1
            if k == len(ranks):
                ranks.append([])
            ranks[k].append(e)
        D = len(ents)
        idx_all[r, :D] = idx
        valid_all[r, :D] = True
        mask0 = bool(ents[-1][2] & tables.F_MASK0)
        if mask0:
            valid_all[r, D - 1, 0] = False
        layers.append(dict(idx=idx, ranks=ranks, mask0=mask0))
    return dict(G=kt["G"], q=q, layers=layers, idx_all=idx_all,
                valid_all=valid_all)


@functools.lru_cache()
def _schedule_on(table: str, device: str) -> dict:
    """_schedule's index tables as tensors on `device`."""
    sch = _schedule(table)
    dev = torch.device(device)
    layers = []
    for lay in sch["layers"]:
        idx = torch.from_numpy(lay["idx"]).to(dev)
        layers.append(dict(
            idx=idx.reshape(-1), D=idx.shape[0], mask0=lay["mask0"],
            ranks=[(torch.tensor(es, device=dev), idx[es].reshape(-1))
                   for es in lay["ranks"]]))
    return dict(G=sch["G"], q=sch["q"], layers=layers,
                idx_all=torch.from_numpy(sch["idx_all"]).to(dev).reshape(-1),
                valid_all=torch.from_numpy(sch["valid_all"]).to(dev),
                shape_all=sch["idx_all"].shape)


def decode_qc(llr: torch.Tensor, table: str, n_iters: int = 16,
              beta: float = 2.0, track_trials: bool = True):
    """QC layered offset-min-sum decode, a fixed number of sweeps.

    llr [B, N] float, positive = bit 0. Returns (hard [B, N] uint8,
    n_bad_checks [B] int32, trials [B] int32: the sweep after which the
    frame's checks first cleared, n_iters if never). With track_trials
    the syndrome is evaluated after every sweep. Messages are stored as
    bf16 and the posterior takes the rounded message, as in the JAX
    version."""
    sch = _schedule_on(table, str(llr.device))
    G, q = sch["G"], sch["q"]
    B = llr.shape[0]
    dev = llr.device
    post = llr_to_post(llr.to(torch.float32), G, q).reshape(-1, B).contiguous()
    msgs = [torch.zeros((lay["D"], LANES, B), dtype=torch.bfloat16,
                        device=dev) for lay in sch["layers"]]
    # a fill, not a copy from the host: the step is captured (graphs.py)
    big = torch.full((), 1e30, dtype=torch.float32, device=dev)
    q_all, D_all, _ = sch["shape_all"]

    def syndrome_bad() -> torch.Tensor:
        neg = (post[sch["idx_all"]] < 0).reshape(q_all, D_all, LANES, B)
        neg = neg & sch["valid_all"][..., None]
        return (neg.sum(dim=1) % 2).sum(dim=(0, 1)).to(torch.int32)

    first_ok = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for it in range(n_iters):
        for r, lay in enumerate(sch["layers"]):
            D = lay["D"]
            old = msgs[r].to(torch.float32)
            v = post[lay["idx"]].reshape(D, LANES, B) - old
            a = torch.abs(v)
            neg = v < 0
            if lay["mask0"]:
                a[D - 1, 0] = 1e30
                neg[D - 1, 0] = False
            m1, am = torch.min(a, dim=0)      # first index of equal values
            onehot = torch.arange(D, device=dev)[:, None, None] == am
            m2 = torch.min(torch.where(onehot, big, a), dim=0).values
            nneg = neg.sum(dim=0)
            stot = 1.0 - 2.0 * (nneg % 2).to(torch.float32)
            sg = torch.where(neg, -1.0, 1.0)
            excl = torch.where(onehot, m2, m1)
            news = stot * sg * torch.clamp(excl - beta, min=0.0)
            if lay["mask0"]:
                news[D - 1, 0] = 0.0
            news_q = news.to(torch.bfloat16)
            delta = news_q.to(torch.float32) - old
            msgs[r] = news_q
            for es, rows in lay["ranks"]:
                post.index_add_(0, rows, delta[es].reshape(-1, B))
        if track_trials:
            clean = syndrome_bad() == 0
            first_ok = torch.where(
                (first_ok < 0) & clean,
                torch.full_like(first_ok, it + 1), first_ok)
    if track_trials:
        trials = torch.where(first_ok < 0,
                             torch.full_like(first_ok, n_iters), first_ok)
    else:
        trials = torch.full((B,), n_iters, dtype=torch.int32, device=dev)
    bad = syndrome_bad()
    hard = post_to_hard(post.reshape(G + q, LANES, B), G, q)
    return hard, bad, trials
