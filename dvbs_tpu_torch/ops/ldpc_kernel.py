"""Int8 layered LDPC decoder: CUDA kernel and plain version.

Port of dvbs_tpu/ops/ldpc_pallas.py (kernel A) with its natural layer
schedule and in-kernel online syndrome. `decode` takes int8 LLRs
[B, N] and returns (hard [B, N] uint8, n_bad [B] int32, trials [B]
int32):

- each sweep walks the q layers in order; per layer, pass 1 reads every
  entry from the pre-layer posterior (running two-min, sign parity, and
  the parity of the posterior signs that makes the online syndrome),
  pass 2 applies the entries one after the other as saturating int8
  read-modify-writes;
- `trials` is the first sweep whose online count is 0 (n_iters if none),
  `n_bad` the last sweep's count;
- with early_exit, sweeps stop once every frame of the call has had a
  clean sweep; frames that converged earlier are swept on with the rest.

On a CUDA tensor csrc/ldpc_layered.cu runs one launch per sweep; on a
CPU tensor `decode_plain` runs the same arithmetic vectorised over
frames and rows with Python loops over layers and entries.
"""
from __future__ import annotations

import torch

from .. import backend, tables
from .ldpc_qc import LANES, llr_to_post, post_to_hard

BIG = 16384          # "no edge" magnitude of masked and padding entries
MSG_CLIP = 31        # message magnitude cap
CALL_FRAMES = 128    # frames per decode call (the early exit gates per call)


def quantize_llrs(llr: torch.Tensor) -> torch.Tensor:
    """Float LLRs [B, N] -> int8 at rms 8 per frame."""
    rms = torch.sqrt(torch.mean(llr.to(torch.float32) ** 2, dim=1,
                                keepdim=True)) + 1e-20
    return torch.clamp(torch.round(llr * (8.0 / rms)), -127, 127
                       ).to(torch.int8)


def decode(llr_i8: torch.Tensor, table: str, n_iters: int = 16,
           beta: int = 1, early_exit: bool = True, kt: dict | None = None):
    """One decode call over B frames (see the module docstring). kt: the
    table's schedule (tables.kernel_tables); pass a dict whose g/s/f
    tables already lie on the device to save the upload."""
    kt = kt or tables.kernel_tables(table)
    if backend.use_kernel(llr_i8):
        return decode_cuda(llr_i8, kt, n_iters, beta, early_exit)
    return decode_plain(llr_i8, kt, n_iters, beta, early_exit)


def decode_calls(llr_i8: torch.Tensor, table: str, n_iters: int,
                 kt: dict | None = None):
    """Any frame count through CALL_FRAMES-frame decode calls."""
    outs = [decode(llr_i8[lo:lo + CALL_FRAMES], table, n_iters=n_iters,
                   kt=kt)
            for lo in range(0, llr_i8.shape[0], CALL_FRAMES)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def decode_plain(llr_i8: torch.Tensor, kt: dict, n_iters: int,
                 beta: int = 1, early_exit: bool = True):
    """Plain PyTorch version of the sweep loop (int32 arithmetic)."""
    G, q, Dmax = kt["G"], kt["q"], kt["Dmax"]
    g_tab, s_tab, f_tab = (kt[k].tolist() for k in ("g_tab", "s_tab", "f_tab"))
    B = llr_i8.shape[0]
    dev = llr_i8.device
    post = llr_to_post(llr_i8.to(torch.int32), G, q).permute(2, 0, 1)
    post = post.contiguous()                         # [B, G+q, 360]
    msgs = torch.zeros((q, Dmax, B, LANES), dtype=torch.int32, device=dev)
    row0 = torch.arange(LANES, device=dev) == 0
    big = torch.full((), BIG, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    trials = torch.full((B,), n_iters, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_bad = torch.ones(B, dtype=torch.int32, device=dev)
    for it in range(n_iters):
        bad = torch.zeros(B, dtype=torch.int32, device=dev)
        for r in range(q):
            off = []
            m1 = m2 = am = par = pxor = None
            negs = []
            for e in range(Dmax):
                g, s, fl = g_tab[r][e], s_tab[r][e], f_tab[r][e]
                rolled = torch.roll(post[:, g], s, dims=1)
                v = rolled - msgs[r, e]
                negs.append(v < 0)
                o = row0 if fl & tables.F_MASK0 else None
                if not fl & tables.F_VALID:
                    o = torch.ones_like(row0)
                off.append(o)
                a = torch.abs(v)
                neg = (v < 0).to(torch.int32)
                pneg = (rolled < 0).to(torch.int32)
                if o is not None:
                    a = torch.where(o, big, a)
                    neg = torch.where(o, zero, neg)
                    pneg = torch.where(o, zero, pneg)
                if e == 0:
                    m1, m2 = a, big.expand_as(a)
                    am = torch.zeros_like(a)
                    par, pxor = neg, pneg
                    continue
                isnew = a < m1
                m2 = torch.where(isnew, m1, torch.minimum(m2, a))
                m1 = torch.where(isnew, a, m1)
                am = torch.where(isnew, torch.full_like(am, e), am)
                par = par ^ neg
                pxor = pxor ^ pneg
            bad = bad + pxor.sum(dim=1, dtype=torch.int32)
            for e in range(Dmax):
                g, s = g_tab[r][e], s_tab[r][e]
                excl = torch.where(am == e, m2, m1)
                mag = torch.clamp(excl - beta, 0, MSG_CLIP)
                news = torch.where((par ^ negs[e].to(torch.int32)) > 0,
                                   -mag, mag)
                if off[e] is not None:
                    news = torch.where(off[e], zero, news)
                old = msgs[r, e]
                news = torch.where((old != 0) & ((old ^ news) < 0), zero, news)
                delta = news - old          # before the store: old is a view
                msgs[r, e] = news
                post[:, g] = torch.clamp(
                    post[:, g] + torch.roll(delta, -s, dims=1), -127, 127)
        now_ok = bad == 0
        trials = torch.where(~done & now_ok, torch.full_like(trials, it + 1),
                             trials)
        done = done | now_ok
        n_bad = bad
        if early_exit and bool(done.all()):
            break
    hard = post_to_hard(post.permute(1, 2, 0), G, q)
    return hard, n_bad, trials


def decode_cuda(llr_i8: torch.Tensor, kt: dict, n_iters: int,
                beta: int = 1, early_exit: bool = True):
    """Launch csrc/ldpc_layered.cu (kernel A's port) once per sweep. The
    launches are enqueued back to back; the early exit is decided on the
    device, so the host never waits between sweeps."""
    from ..kernels import build
    G, q, Dmax = kt["G"], kt["q"], kt["Dmax"]
    B, N = llr_i8.shape
    dev = llr_i8.device
    NG = G + q
    backend.check(llr_i8, "llr_i8", torch.int8, (B, N), dev)
    tabs = []
    for k in ("g_tab", "s_tab", "f_tab"):
        t = kt[k]
        t = t if torch.is_tensor(t) else torch.from_numpy(t)
        t = t.to(device=dev, dtype=torch.int32).contiguous()
        backend.check(t, k, torch.int32, (q, Dmax), dev)
        tabs.append(t)
    post = llr_to_post(llr_i8, G, q).permute(2, 0, 1).contiguous()
    backend.check(post, "post", torch.int8, (B, NG, LANES), dev)
    msgs = torch.zeros((B, q, Dmax, LANES), dtype=torch.int8, device=dev)
    trials = torch.full((B,), n_iters, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.int32, device=dev)
    n_bad = torch.ones(B, dtype=torch.int32, device=dev)
    open_after = torch.zeros(n_iters, dtype=torch.int32, device=dev)
    for it in range(n_iters):
        build.launch("ldpc_layered_sweep", post.data_ptr(), msgs.data_ptr(),
                     tabs[0].data_ptr(), tabs[1].data_ptr(),
                     tabs[2].data_ptr(), B, NG, q, Dmax, beta, it,
                     int(early_exit), trials.data_ptr(), done.data_ptr(),
                     n_bad.data_ptr(), open_after.data_ptr())
        backend.LAUNCHES["ldpc_layered"] += 1
    hard = post_to_hard(post.permute(1, 2, 0), G, q)
    return hard, n_bad, trials
