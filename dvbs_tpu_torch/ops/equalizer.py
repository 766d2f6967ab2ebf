"""Decision-directed LMS equalizer (block feed-forward formulation).

PyTorch port of dvbs_tpu/ops/equalizer.py, batched over a leading
carrier axis. `DVBS2Receiver(equalize=True)` inserts it after timing
recovery, before PL sync (models/dvbs2.SymbolProgram), as the reference
demodulator's disabled equalizer::LMS would sit.

The block is split into chunks; each chunk solves a small regularized
least-squares fit of the taps to the QPSK slicer's decisions (a block
LMS / Wiener step), carried across chunks by averaging with the
previous taps. Plain torch: the windows are one `unfold` of the padded
stream and the [C, n_taps, n_taps] complex normal equations go to
`torch.linalg.solve_ex`, which leaves the result on the device (no
host sync for an error check). No Pallas kernel is behind the JAX
version either.
"""
from __future__ import annotations

import math

import torch


def _qpsk_slice(z: torch.Tensor) -> torch.Tensor:
    """Nearest unit-energy QPSK point of each complex64 symbol."""
    s = 1.0 / math.sqrt(2.0)
    return torch.view_as_complex(torch.where(torch.view_as_real(z) > 0,
                                             s, -s))


def lms_equalize(z: torch.Tensor, n_taps: int = 17, n_chunks: int = 8,
                 ridge: float = 1e-2) -> torch.Tensor:
    """Equalize symbol streams with a block decision-directed LS filter.

    z: [C, n] (or [n]) complex symbols, timing- and carrier-recovered.
    Returns the equalized symbols, complex64, of z's shape. The last
    chunk takes the remainder of n.
    """
    single = z.dim() == 1
    z = z.to(torch.complex64)
    if single:
        z = z[None]
    C, n = z.shape
    chunk = n // n_chunks
    half = n_taps // 2
    zp = torch.nn.functional.pad(torch.view_as_real(z),
                                 (0, 0, half, half))
    zp = torch.view_as_complex(zp)                 # [C, n + 2 * half]
    eye = torch.eye(n_taps, dtype=torch.complex64, device=z.device)
    taps = torch.zeros(C, n_taps, dtype=torch.complex64, device=z.device)
    taps[:, half] = 1.0
    out = []
    for c in range(n_chunks):
        lo = c * chunk
        m = chunk if c < n_chunks - 1 else n - lo
        # A[:, i, j] = zp[:, lo + i + j]: the window around each symbol
        A = zp[:, lo:lo + m + n_taps - 1].unfold(-1, n_taps, 1)
        d = _qpsk_slice(torch.einsum("cmt,ct->cm", A, taps))
        Ah = A.conj().transpose(-1, -2)                # [C, n_taps, m]
        G = Ah @ A / m + ridge * eye
        r = (Ah @ d[..., None])[..., 0] / m
        new_taps = torch.linalg.solve_ex(G, r)[0]
        taps = torch.lerp(taps, new_taps, 0.5)         # smooth adaptation
        out.append(torch.einsum("cmt,ct->cm", A, taps))
    eq = torch.cat(out, dim=-1)
    return eq[0] if single else eq
