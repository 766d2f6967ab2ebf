"""QC-LDPC posterior layout (the glue around the int8 decoder).

PyTorch port of the layout helpers of dvbs_tpu/ops/ldpc_qc.py. In the
POST layout [G+q, 360, B] info bit i sits at (i // 360, i % 360) and
parity bit a = r + q*c at (G + r, c), so both directions are a reshape
and a transpose. The float decoder `decode_qc` is not ported yet
(ROADMAP queue 1).
"""
from __future__ import annotations

import torch

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
