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

What bounds the CUDA kernel on an H100 is instruction issue and, close
behind, the SM's shared-memory pipe, not bytes. So it forms each step's
branch sums once (`branch_sum_table`: a step has 64 distinct sums, one
per sign pattern of its 6 LLRs, and the pattern with every sign flipped
has exactly the negated sum, so 32 are formed, one a lane, a step ahead
of their use), decodes a segment per warp (a lane holds two states, ns
and ns ^ 40, that share their eight predecessors and, the branch into
ns ^ 40 from input j being the complement of the branch into ns from
j ^ 4, their eight table reads; path metrics pass through a
warp-private strip of shared memory, one `__syncwarp` a step and no
CTA-wide barrier), packs the decisions a nibble a state, and keeps four
segments a CTA so that one segment's serial traceback runs beside the
others' forward passes (one a CTA only where four do not fit its shared
memory, T beyond about 3,000 pairs).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import backend, tables
from . import viterbi
from .frontend import bf16_round

K = 3                                   # trellis steps per ACS step
R = 1 << K
N_STATES = tables.N_STATES
# shared memory a CTA may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# a warp's share (csrc/viterbi_acs.cu): two strips of 64 path metrics
# with a 4-float gap, two tables of 32 branch sums, and per step 6 LLRs
# as float32 and 32 bytes of decisions (a nibble a state); the traced
# states reuse the LLRs' room. Rounded up to 16 bytes.
WARP_FIXED = (2 * 68 + 2 * 32) * 4
STEP_BYTES = 6 * 4 + 32
CTA_SEGMENTS = 4        # the kernel's CTA, where four segments fit it


def smem_bytes(T: int, segments: int = 1) -> int:
    """Shared memory a CTA of the CUDA kernel needs for `segments`
    segments (a warp each) of T pairs."""
    nsteps = -(-T // K)
    return segments * ((WARP_FIXED + STEP_BYTES * nsteps + 15) & ~15)


def pattern_table() -> np.ndarray:
    """[64, 8] int: the 6-bit sign pattern of branch (ns, j), bit q set
    where tables.trellis_k(3)'s sign[ns, j, q] is -1. The CUDA kernel
    derives the same from G1 and G2 (branch_pattern)."""
    sign = tables.trellis_k(K)[0]
    return ((sign < 0) << np.arange(2 * K)).sum(axis=2)


def branch_sum_table(r: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's shared branch sums, in PyTorch: r [..., 6]
    float32 -> [..., 32], entry p the sum over q = 0..5 in order of
    (-r[q] if bit q of p else r[q]), each add rounded alone (bit 5 of p
    is clear: r[5] enters with +). The patterns 32..63 are not formed:
    pattern p ^ 63 has every sign flipped and exactly the negated sum,
    see branch_metrics_shared."""
    p = torch.arange(32, device=r.device)
    sg = [1.0 - 2.0 * ((p >> q) & 1).to(torch.float32) for q in range(5)]
    acc = r[..., None, 0] * sg[0]
    for q in range(1, 5):
        acc = acc + r[..., None, q] * sg[q]
    return acc + r[..., None, 5]


def branch_metrics_shared(r: torch.Tensor) -> torch.Tensor:
    """Every branch metric [..., 64, 8] of steps r [..., 6] the way the
    CUDA kernel reads them: branch (ns, j) with pattern p takes
    table[p] when bit 5 of p is clear, else -table[p ^ 63]."""
    pat = torch.from_numpy(pattern_table()).to(r.device)
    tab = branch_sum_table(r)
    flip = (pat & 32) != 0
    idx = torch.where(flip, pat ^ 63, pat).reshape(-1)
    bm = tab[..., idx].reshape(*r.shape[:-1], N_STATES, R)
    return torch.where(flip, -bm, bm)


def decode_segments(llrs: torch.Tensor) -> torch.Tensor:
    """llrs [B, T, 2] float32 (positive = bit 0, 0 = erasure) -> bits
    [B, T] uint8. The CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if backend.use_kernel(llrs):
        return decode_cuda(llrs)
    return decode_plain(llrs)


def select_decoder(impl: str = "auto"):
    """The segment decoder named by `impl` (viterbi_pallas.select_decoder's
    names): "auto" and "pallas" this module's decode_segments (kernel C
    on a CUDA tensor, its plain version on a CPU tensor), "xla" the
    decoder of ops/viterbi.py. Both give the same segment cores."""
    if impl in ("auto", "pallas"):
        return decode_segments
    if impl != "xla":
        raise ValueError(f"unknown viterbi impl {impl!r}")
    return viterbi.decode_segments


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
    """Launch csrc/viterbi_acs.cu (kernel C's port): a warp per segment,
    CTA_SEGMENTS segments per CTA (one where four do not fit)."""
    from ..kernels import build
    B, T = llrs.shape[0], llrs.shape[1]
    backend.check(llrs, "llrs", torch.float32, (B, T, 2), llrs.device)
    if smem_bytes(T) > SMEM_LIMIT:
        raise ValueError(
            f"viterbi_acs: a segment of T={T} pairs needs {smem_bytes(T)} "
            f"bytes of shared memory, more than the {SMEM_LIMIT} a Hopper "
            f"CTA may use; cut the segments shorter")
    if llrs.data_ptr() % 8:                 # the kernel loads (X, Y) pairs
        llrs = llrs.clone()
    bits = torch.empty((B, T), dtype=torch.uint8, device=llrs.device)
    if B:
        build.launch("viterbi_acs", llrs.data_ptr(), B, T, bits.data_ptr())
        backend.LAUNCHES["viterbi_acs"] += 1
    return bits
