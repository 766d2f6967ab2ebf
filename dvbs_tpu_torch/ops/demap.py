"""Soft demapper: exact LLRs over subsets of the constellation.

PyTorch port of dvbs_tpu/ops/demap.py: per-bit log-ratio of summed
exp(-distance/npwr) over the points whose bit is 0 and 1, with the
reference's per-constellation scales (tables.DEMAP_SCALES) and its int8
clamp by repeated halving. Positive = bit 0.
"""
from __future__ import annotations

import torch

from .. import tables


def _clamp_halving(x: torch.Tensor) -> torch.Tensor:
    """Halve until |x| <= 127 (constellation.cpp:263-270)."""
    mag = torch.abs(x)
    k = torch.ceil(torch.log2(torch.clamp(mag / 127.0, min=1.0)))
    return x * torch.exp2(-k)


def soft_demap(syms: torch.Tensor, kind: str, pts: torch.Tensor,
               mask0: torch.Tensor, npwr: float = 1.0) -> torch.Tensor:
    """syms [...] complex -> LLRs [..., m] float32. pts [S] complex64
    and mask0 [m, S] bool from tables.demap_tables(kind, g1, g2)."""
    ss, ps, sca = tables.DEMAP_SCALES[kind]
    x = syms[..., None] * ss
    d = torch.abs(x - pts * ps)                       # [..., S]
    neg = -d / npwr
    ninf = torch.full((), float("-inf"), device=syms.device)

    def lse(mask):
        z = torch.where(mask, neg[..., None, :], ninf)    # [..., m, S]
        zmax = torch.amax(z, dim=-1, keepdim=True)
        return torch.log(torch.sum(torch.exp(z - zmax), dim=-1)) + zmax[..., 0]
    llr = (lse(mask0) - lse(~mask0)) * sca
    return _clamp_halving(llr).to(torch.float32)
