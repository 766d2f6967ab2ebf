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

On a CUDA tensor csrc/ldpc_layered.cu runs, one block a frame, one
thread a circulant row, one launch a call; on a CPU tensor
`decode_plain` runs the same arithmetic vectorised over frames and rows
with Python loops over layers and entries.

What bounds the kernel on an H100 is the integer instructions a thread
issues per edge (the card has half as many INT32 as FP32 lanes, and a
block of 12 warps has an SM to itself, so a sweep costs the same at 3
frames as at 128), and before that the chain of dependent steps and
barriers of a layer; the bytes take microseconds. So one launch runs a
whole call (LLRs in codeword order in, hard bits out, the posterior in
shared memory throughout, the blocks agreeing on the early exit through
one counter: a cooperative launch); the kernel is compiled per entry
count Dmax and unrolls both passes (every load of a layer in flight at
once, each message read once); messages lie four to a 32-bit word
([B, q, ceil(Dmax/4), 360] int32, this module's scratch) and the next
layer's words are loaded ahead; the schedule sits in shared memory
(`tables.pack_schedule`, one word an entry); and it synchronises only
where two rows can meet at one address: before a layer that carries
`tables.F_BAR`, and around an entry that carries `tables.F_SYNC`. It
forms no arg-min (an entry takes the second minimum where its magnitude
equals the first), which gives the same values. `decode_plain` stays
sequential and ignores both flags; the two agree bit for bit.
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
    table's schedule (tables.kernel_tables); give it a "sched" entry,
    tables.pack_schedule of its tables as an int32 tensor on the device,
    to save the kernel's wrapper the upload."""
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
    """Launch csrc/ldpc_layered.cu (kernel A's port): one launch runs the
    call's sweeps, LLRs in codeword order in, hard bits out. With
    early_exit the blocks agree after every sweep on whether a frame is
    still open, which needs every block resident (a cooperative launch):
    an H100 holds at least a block on each of its 132 SMs, so the
    CALL_FRAMES of a call always fit; the launch itself refuses more
    frames than the card can hold at once (a RuntimeError), and
    decode_calls cuts a batch into calls."""
    from ..kernels import build
    G, q, Dmax = kt["G"], kt["q"], kt["Dmax"]
    B, N = llr_i8.shape
    dev = llr_i8.device
    backend.check(llr_i8, "llr_i8", torch.int8, (B, N), dev)
    if N != (G + q) * LANES:
        raise ValueError(f"llr_i8: {N} bits a frame, the table has "
                         f"{(G + q) * LANES}")
    if llr_i8.data_ptr() % 8:               # the kernel loads 8 bytes at once
        llr_i8 = llr_i8.clone()
    sched = kt.get("sched")
    if sched is None:
        sched = torch.from_numpy(tables.pack_schedule(
            kt["g_tab"], kt["s_tab"], kt["f_tab"])).to(dev)
    backend.check(sched, "sched", torch.int32, (q, Dmax), dev)
    hard = torch.empty((B, N), dtype=torch.uint8, device=dev)
    # the kernel writes every element of trials and n_bad
    trials = torch.empty(B, dtype=torch.int32, device=dev)
    n_bad = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return hard, n_bad, trials
    # scratch: four int8 messages of a row to a word, entry e in byte
    # e % 4; sweep 0 reads none of it
    msgs = torch.empty((B, q, -(-Dmax // 4), LANES), dtype=torch.int32,
                       device=dev)
    sweep_sync = torch.zeros(max(n_iters, 1), dtype=torch.int32, device=dev)
    build.launch("ldpc_layered_decode", llr_i8.data_ptr(), hard.data_ptr(),
                 msgs.data_ptr(), sched.data_ptr(), B, G, q, Dmax, beta,
                 n_iters, int(early_exit), trials.data_ptr(),
                 n_bad.data_ptr(), sweep_sync.data_ptr())
    backend.LAUNCHES["ldpc_layered"] += 1
    return hard, n_bad, trials
