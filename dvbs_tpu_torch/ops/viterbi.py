"""Batched Viterbi decoder for the DVB-S K=7 rate-1/2 code, plain PyTorch.

Port of dvbs_tpu/ops/viterbi.py (the XLA lax.scan decoder), with its
exact semantics: unknown start state (all path metrics zero), radix-2^k
add-compare-select with branch metrics r @ sign in float32, first-index
argmax, per-step `pm - max(pm)` normalization, traceback from the
first-index argmax end state, and T zero-padded (erasures) to a multiple
of k. The lock search (models/dvbs.DVBSReceiver._try_lock) runs it.

It is not kernel C's plain version (ops/viterbi_kernel.py): that one
follows the Pallas kernel, which has no normalization, another
tie-break and a traceback from state 0, so the two agree on segment
cores and may differ in the wings.

Soft convention: float LLRs, positive = bit 0, 0 = erasure.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import backend, tables

N_STATES = tables.N_STATES


def decode_segments(llrs: torch.Tensor, k: int = 4) -> torch.Tensor:
    """llrs [B, T, 2] float (positive = bit 0) -> bits [B, T] uint8."""
    sign_np, bits_hi_np = tables.trellis_k(k)
    R = 1 << k
    LO = N_STATES >> k
    dev = llrs.device
    sign = torch.from_numpy(np.ascontiguousarray(
        sign_np.reshape(N_STATES * R, 2 * k).T)).to(dev)   # [2k, 64R]
    bits_hi = torch.from_numpy(bits_hi_np).to(dev, torch.uint8)  # [R, k]
    B, T, _ = llrs.shape
    Tk = -(-T // k) * k
    x = llrs.to(torch.float32)
    if Tk != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tk - T))
    nsteps = Tk // k
    r_sup = x.reshape(B, nsteps, 2 * k)
    pm = torch.zeros((B, N_STATES), dtype=torch.float32, device=dev)
    decs = []
    for t in range(nsteps):
        bm = (r_sup[:, t] @ sign).reshape(B, R, LO, R)   # [B, hi, lo, j]
        cand = pm.reshape(B, 1, LO, R) + bm
        newpm, dec = cand.max(dim=3)                      # first index
        newpm = newpm.reshape(B, N_STATES)
        pm = newpm - newpm.max(dim=1, keepdim=True).values
        decs.append(dec.reshape(B, N_STATES))
    s = torch.argmax(pm, dim=1)                           # [B], first index
    out = torch.empty((B, nsteps, k), dtype=torch.uint8, device=dev)
    for t in range(nsteps - 1, -1, -1):
        # the k inputs of step t are the hi digits of the state entered
        out[:, t] = bits_hi[s // LO]
        s = (s % LO) * R + decs[t].gather(1, s[:, None])[:, 0]
    return out.reshape(B, Tk)[:, :T]


def segment_stream(llrs: np.ndarray, core: int = 2048, wing: int = 96):
    """Cut [n, 2] stream into overlapping segments [B, core+2*wing, 2];
    returns (segments, n_core_bits). Stream edges are zero-padded
    (erasures)."""
    n = len(llrs)
    B = max(1, -(-n // core))
    padded = np.zeros((B * core + 2 * wing, 2), llrs.dtype)
    padded[wing:wing + n] = llrs[:B * core]
    segs = np.stack([padded[i * core:i * core + core + 2 * wing]
                     for i in range(B)])
    return segs, n


def decode_stream(llrs: np.ndarray, core: int = 2048, wing: int = 96,
                  device=None) -> np.ndarray:
    """Host convenience path: [n, 2] float -> [n] uint8 decoded bits,
    the segments decoded on `device` (None: the card)."""
    device = backend.resolve_device(device)
    segs, n = segment_stream(llrs, core, wing)
    bits = decode_segments(torch.from_numpy(segs.astype(np.float32))
                           .to(device)).cpu().numpy()
    return bits[:, wing:wing + core].reshape(-1)[:n]
