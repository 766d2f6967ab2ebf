"""DVB-S2 PL frame synchronization, batched over carriers.

PyTorch port of dvbs_tpu/ops/plsync.py: the differential SOF+PLS
correlation at every symbol offset as one banded-template matmul (bf16
inputs, float32 products), the parallel frame locator with its
per-frame relocation fallback, the chained locator for grids that hold
dummy PLFRAMEs, and frame extraction. Window starts are
clamped to [0, n - L] where the JAX version's dynamic_slice clamps.
"""
from __future__ import annotations

import torch

from .frontend import bf16_round


def correlate(z: torch.Tensor, T: torch.Tensor):
    """z [C, n] complex symbols, T the template matrix [blk+89, 2*blk]
    (tables.template_matrix). Returns (score [C, n-89] float32,
    cvec [C, n-89] complex64)."""
    C, n = z.shape
    d = torch.cat([torch.zeros_like(z[:, :1]),
                   z[:, 1:] * torch.conj(z[:, :-1])], dim=1)
    nout = n - 89
    blk = T.shape[1] // 2
    nb = -(-nout // blk)
    parts = []
    for p in (d.real, d.imag):
        if (nb + 1) * blk > n:
            p = torch.nn.functional.pad(p, (0, (nb + 1) * blk - n))
        else:
            p = p[:, :(nb + 1) * blk]
        a = p.reshape(C, nb + 1, blk)
        w = torch.cat([a[:, :-1], a[:, 1:]], dim=2)[:, :, :blk + 89]
        parts.append((bf16_round(w) @ T).reshape(C, nb, blk, 2))
    re, im = parts
    csof = torch.complex(re[..., 0], im[..., 0]).reshape(C, nb * blk)[:, :nout]
    cpls = torch.complex(re[..., 1], im[..., 1]).reshape(C, nb * blk)[:, :nout]
    c0 = csof + cpls
    c1 = csof - cpls
    pick1 = torch.abs(c1) > torch.abs(c0)
    c = torch.where(pick1, c1, c0) / (25.0 + 32.0)
    return torch.abs(c), c


def _windows(x: torch.Tensor, lo: torch.Tensor, length: int):
    """x [C, n], lo [C, F] -> x[c, lo[c, f] : lo[c, f] + length]
    as [C, F, length] (lo already in range)."""
    C = x.shape[0]
    idx = lo[..., None] + torch.arange(length, device=x.device)
    return torch.gather(x, 1, idx.reshape(C, -1)).reshape(*lo.shape, length)


def locate_frames(score: torch.Tensor, frame_len: int, n_frames: int,
                  search: int = 4, margin: int = 0,
                  fallback_threshold: float | None = 0.6):
    """score [C, n] -> (starts [C, F] int32, quality [C, F] float32):
    global argmax in [margin, margin + L), then +-search refinement per
    frame, then the relocation fallback for weak frames (see
    dvbs_tpu/ops/plsync.locate_frames)."""
    C, n = score.shape
    dev = score.device
    L = frame_len
    lo0 = torch.full((C, 1), min(max(margin, 0), n - L), dtype=torch.int64,
                     device=dev)
    p0 = margin + torch.argmax(_windows(score, lo0, L)[:, 0], dim=-1)
    base = p0[:, None] + torch.arange(n_frames, device=dev) * L   # [C, F]
    offs = torch.arange(-search, search + 1, device=dev)
    cand = torch.clamp(base[..., None] + offs, 0, n - 1)           # [C, F, 2s+1]
    vals = torch.gather(score, 1, cand.reshape(C, -1)).reshape(cand.shape)
    best = torch.argmax(vals, dim=-1, keepdim=True)
    starts = torch.gather(cand, 2, best)[..., 0]
    quality = torch.gather(vals, 2, best)[..., 0]
    if fallback_threshold is not None:
        lo = torch.clamp(base - L // 2, 0, n - L)
        win = _windows(score, lo, L)                               # [C, F, L]
        ridx = torch.argmax(win, dim=-1, keepdim=True)
        rstart = lo + ridx[..., 0]
        rq = torch.gather(win, 2, ridx)[..., 0]
        territory_ok = (base - L // 2 >= 0) & (base + L // 2 <= n - L)
        use = (quality < fallback_threshold) & (rq > quality) & territory_ok
        starts = torch.where(use, rstart, starts)
        quality = torch.where(use, rq, quality)
    return starts.to(torch.int32), quality


DUMMY_LEN = 90 + 36 * 90     # dummy PLFRAME (EN 302 307-1 sec. 5.5.1)


def locate_frames_chain(score: torch.Tensor, frame_len: int, n_frames: int,
                        search: int = 4, margin: int = 0,
                        threshold: float = 0.6):
    """Chained frame slotting for grids that are not L-periodic (dummy
    PLFRAMEs between data frames): each slot chains from the previous
    slot's refined start over the pitches {DUMMY_LEN, L, L + DUMMY_LEN,
    L + 2 DUMMY_LEN} and takes the earliest candidate whose refined
    correlation is above `threshold`, else the best one. A loop of
    n_frames - 1 small gathers, batched over carriers, with no host
    wait. score [C, n] -> (starts [C, F] int32, quality [C, F])."""
    C, n = score.shape
    dev = score.device
    L = frame_len
    lo0 = torch.full((C, 1), min(max(margin, 0), n - L), dtype=torch.int64,
                     device=dev)
    p0 = margin + torch.argmax(_windows(score, lo0, L)[:, 0], dim=-1)
    offs = torch.arange(-search, search + 1, device=dev)
    pitches = torch.tensor([DUMMY_LEN, L, L + DUMMY_LEN, L + 2 * DUMMY_LEN],
                           device=dev)
    c0 = torch.clamp(p0[:, None] + offs, 0, n - 1)              # [C, 2s+1]
    v0 = torch.gather(score, 1, c0)
    k0 = torch.argmax(v0, dim=-1, keepdim=True)
    prev = torch.gather(c0, 1, k0)[:, 0]
    starts, quality = [prev], [torch.gather(v0, 1, k0)[:, 0]]
    for _ in range(n_frames - 1):
        cc = torch.clamp((prev[:, None] + pitches)[..., None] + offs,
                         0, n - 1)                              # [C, 4, 2s+1]
        v = torch.gather(score, 1, cc.reshape(C, -1)).reshape(cc.shape)
        q, r = torch.max(v, dim=-1)        # first index of equal values
        above = q > threshold
        # argmax of a 0/1 row: the earliest candidate above threshold
        first = torch.argmax(above.to(torch.int8), dim=-1)
        i = torch.where(above.any(dim=-1), first, torch.argmax(q, dim=-1))
        ri = torch.gather(r, 1, i[:, None])
        prev = torch.gather(cc, 1, i[:, None, None].expand(C, 1, cc.shape[2])
                            )[:, 0].gather(1, ri)[:, 0]
        starts.append(prev)
        quality.append(torch.gather(q, 1, i[:, None])[:, 0])
    return (torch.stack(starts, dim=1).to(torch.int32),
            torch.stack(quality, dim=1))


def extract_frames(z: torch.Tensor, starts: torch.Tensor, frame_len: int
                   ) -> torch.Tensor:
    """z [C, n], starts [C, F] -> frames [C, F, frame_len]. As
    lax.dynamic_slice: a negative start counts from the end, then each
    start is clamped to [0, n - frame_len]."""
    n = z.shape[1]
    lo = starts.to(torch.int64)
    lo = torch.clamp(torch.where(lo < 0, lo + n, lo), 0, n - frame_len)
    return _windows(z, lo, frame_len)
