"""PLS header (MODCOD) detection: soft correlation against all 128 codes.

PyTorch port of dvbs_tpu/ops/plhdr.py. Re(pls . conj(M)^T) is computed
as two real float32 products (Re*Re + Im*Im).
"""
from __future__ import annotations

import torch


def detect_pls(headers: torch.Tensor, pls_syms: torch.Tensor):
    """headers [..., 90] phase-corrected header symbols, pls_syms
    [128, 64] complex64 (tables.pls_sym_matrix). Returns (pls_index
    [...] int32, confidence [...] float32)."""
    pls = headers[..., 26:90]
    corr = pls.real @ pls_syms.real.T + pls.imag @ pls_syms.imag.T
    idx = torch.argmax(corr, dim=-1, keepdim=True)
    conf = torch.gather(corr, -1, idx)[..., 0] / 64.0
    return idx[..., 0].to(torch.int32), conf
