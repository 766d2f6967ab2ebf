"""Radix-8 Viterbi ACS + traceback (kernel C): CUDA kernel and plain version.

Port of the Pallas TPU kernel of dvbs_tpu/ops/viterbi_pallas.py
(decode_segments_pallas), which decodes the DVB-S K=7 rate-1/2 code on
many overlapped segments at once. Its TPU layout (digit-swapped path
metrics, MXU expansion matrices, lane batching, DMA staging) is not
ported; its decoded bits are. Both versions here follow these rules:

- T is padded with zero LLRs to Tk = 3*ceil(T/3), and the LLRs are
  rounded to bf16 (round to nearest even), kept as float32;
- step t reads r = llrs[3t:3t+3] flattened, earliest (X, Y) first;
- forward from pm = 0 with no normalization: for next state
  ns = hi*8 + lo and fused input j, the predecessor is lo*8 + j and the
  candidate pm[lo*8 + j] + bm, where bm = sum_q sign[ns, j, q] * r[q]
  is summed q = 0..5 in order (sign = tables.trellis_k(3)[0]);
- the maximum over j is a tournament with strict `>`: (j, j+4), then
  (j, j+2) over the survivors, then (j, j+1); a tie keeps the lower
  operand. dec[t, ns] = the winning j;
- traceback from state 0 at t = nsteps: emit bits[3t+i] = bit 3+i of
  the state, then step back to (s & 7)*8 + dec[t, s]; bits beyond T are
  dropped.

Every sum is taken in the same order on both sides (multiplying by +-1
is exact), so the kernel and the plain version agree bit for bit, wings
included. On segment cores both equal ops/viterbi.decode_segments.
"""
from __future__ import annotations

import torch

from .. import backend, tables
from .frontend import bf16_round

K = 3                                   # trellis steps per ACS step
R = 1 << K
N_STATES = tables.N_STATES
# shared memory a CTA may use on Hopper (227 KB); the kernel keeps the
# decisions (nsteps*64 B), the bf16-rounded LLRs (6*nsteps floats), the
# bits (3*nsteps B) and two path-metric rows (512 B) there
SMEM_LIMIT = 232448


def smem_bytes(T: int) -> int:
    """Shared memory the CUDA kernel needs for segments of T pairs."""
    nsteps = -(-T // K)
    return 2 * N_STATES * 4 + 6 * nsteps * 4 + nsteps * N_STATES \
        + K * nsteps


def decode_segments(llrs: torch.Tensor) -> torch.Tensor:
    """llrs [B, T, 2] float32 (positive = bit 0, 0 = erasure) -> bits
    [B, T] uint8. The CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if backend.use_kernel(llrs):
        return decode_cuda(llrs)
    return decode_plain(llrs)


def decode_plain(llrs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the rules of the module docstring, batched
    over segments, one Python step per 3 trellis steps."""
    sign_np, Bm_np = tables.viterbi_tables_k3()
    dev = llrs.device
    B, T, _ = llrs.shape
    Tk = -(-T // K) * K
    nsteps = Tk // K
    x = bf16_round(llrs.to(torch.float32))
    if Tk != T:
        x = torch.nn.functional.pad(x, (0, 0, 0, Tk - T))
    r = x.reshape(B, nsteps, 2 * K)
    sign = torch.from_numpy(sign_np).to(dev)                # [64, 8, 6]
    # branch metric of every (ns, j), summed q = 0..5 in order
    bm = r[:, :, None, None, 0] * sign[:, :, 0]
    for q in range(1, 2 * K):
        bm = bm + r[:, :, None, None, q] * sign[:, :, q]    # [B, n, 64, 8]
    bm = bm.reshape(B, nsteps, R, R, R)                     # [.., hi, lo, j]
    pm = torch.zeros((B, N_STATES), dtype=torch.float32, device=dev)
    decs = torch.empty((nsteps, B, N_STATES), dtype=torch.int64, device=dev)
    for t in range(nsteps):
        c = pm.reshape(B, 1, R, R) + bm[:, t]               # [B, hi, lo, j]
        idx = None
        for half in (4, 2, 1):
            a, b = c[..., :half], c[..., half:2 * half]
            w = b > a
            c = torch.where(w, b, a)
            if idx is None:
                idx = torch.where(w, half, 0)
            else:
                idx = torch.where(w, idx[..., half:2 * half] + half,
                                  idx[..., :half])
        pm = c.reshape(B, N_STATES)
        decs[t] = idx.reshape(B, N_STATES)
    Bm = torch.from_numpy(Bm_np[:K].T.copy()).to(dev, torch.uint8)  # [64, 3]
    out = torch.empty((B, nsteps, K), dtype=torch.uint8, device=dev)
    s = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(nsteps - 1, -1, -1):
        out[:, t] = Bm[s]
        s = (s & 7) * R + decs[t].gather(1, s[:, None])[:, 0]
    return out.reshape(B, Tk)[:, :T]


def decode_cuda(llrs: torch.Tensor) -> torch.Tensor:
    """Launch csrc/viterbi_acs.cu (kernel C's port): one CTA per
    segment."""
    from ..kernels import build
    B, T = llrs.shape[0], llrs.shape[1]
    backend.check(llrs, "llrs", torch.float32, (B, T, 2), llrs.device)
    need = smem_bytes(T)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"viterbi_acs: segments of T={T} pairs need {need} bytes of "
            f"shared memory per CTA, more than the {SMEM_LIMIT} a Hopper "
            f"CTA may use; cut the segments shorter")
    bits = torch.empty((B, T), dtype=torch.uint8, device=llrs.device)
    build.launch("viterbi_acs", llrs.data_ptr(), B, T, bits.data_ptr())
    backend.LAUNCHES["viterbi_acs"] += 1
    return bits
