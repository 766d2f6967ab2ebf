"""DVB-S2 bit deinterleaver for the device path.

Torch twin of dvbs_tpu/spec/interleaver.deinterleave_device (which
imports jax.numpy inside the function): per-symbol LLRs [..., P, m] ->
codeword order [..., nldpc] as column slices and one concatenation.
QPSK has no interleaving and is a reshape.
"""
from __future__ import annotations

import torch

from ..spec.interleaver import column_offsets
from ..spec.modcod import MOD_BITS, QPSK


def deinterleave(llrs_sym: torch.Tensor, kind: str, framesize: str,
                 rate: str) -> torch.Tensor:
    """codeword[offs[k-1] + j] = llrs_sym[..., j, m-k]."""
    m = MOD_BITS[kind]
    if kind == QPSK:
        return llrs_sym.reshape(*llrs_sym.shape[:-2], -1)
    offs = column_offsets(kind, framesize, rate)
    order = sorted(range(m), key=lambda k0: offs[k0])
    return torch.cat([llrs_sym[..., m - 1 - k0] for k0 in order], dim=-1)
