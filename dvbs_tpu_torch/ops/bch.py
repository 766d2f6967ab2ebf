"""BCH syndrome check as a GF(2) matrix product.

PyTorch port of dvbs_tpu/ops/bch.py: S = bits @ M (tables.
bch_syndrome_matrix) is exact in float32 (sums stay below 2^24); a frame
is clean iff every syndrome bit is even.
"""
from __future__ import annotations

import torch


def syndrome_nonzero(code_bits: torch.Tensor, M: torch.Tensor
                     ) -> torch.Tensor:
    """code_bits [F, nbch] {0,1}, M [nbch, 2t*m] -> [F] bool, True when
    a syndrome is non-zero."""
    s = code_bits.to(torch.float32) @ M.to(torch.float32)
    return (torch.remainder(s, 2.0) > 0.5).any(dim=1)
