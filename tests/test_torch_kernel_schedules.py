"""What the CUDA kernels A and C are built on, checked on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here numpy models of their schedules are held against the plain
versions, which tests/test_torch_ldpc.py and tests/test_torch_viterbi.py
hold against dvbs_tpu's Pallas kernels:

- kernel A (csrc/ldpc_layered.cu): tables.F_SYNC marks exactly the valid
  entries whose group an earlier entry of the layer has; the packed
  schedule word unpacks to g, s and the flags; every table's Dmax has a
  compiled specialisation; updates applied in any order between two
  barriers give the sequential result; and a model of the whole kernel
  (messages four to a word, posteriors of pass 1 reused in pass 2, a
  re-read only at F_SYNC, entries between barriers in reversed order)
  equals decode_plain in hard bits, n_bad and trials on every table;
- kernel C (csrc/viterbi_acs.cu): the pattern table the kernel derives
  from G1 and G2 equals tables.trellis_k(3)'s signs; the 32 shared branch
  sums with the sign applied at the read equal the per-state ordered
  float32 sums; and a model of the warp's decode (two states a lane,
  nibble-packed decisions, traceback by lane and nibble) equals
  decode_plain on every bit.

Tolerance: none. Integer arithmetic on the LDPC side. On the Viterbi
side every value is equal and every bit pattern but the sign of a zero
sum (x + -x rounds to +0, its negation is -0), which no comparison and
no later sum can tell apart.

The models below are written after the .cu bodies by hand: nothing but
test_every_dmax_has_a_specialisation reads the CUDA sources. Whoever
changes a kernel's schedule (the barriers, the message words, the lane's
states, the decisions' packing) changes its model here with it, and
tests/test_torch_cuda.py holds the kernel itself on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dvbs_tpu_torch import tables
from dvbs_tpu_torch.ops import ldpc_kernel
from dvbs_tpu_torch.ops import viterbi_kernel as vk
from dvbs_tpu_torch.ops.frontend import bf16_round
from dvbs_tpu_torch.ops.ldpc_qc import LANES
from dvbs_tpu_torch.spec import dvbs_fec

torch.set_num_threads(2)

ALL_TABLES = [f"B{i}" for i in range(1, 12)] + [f"C{i}" for i in range(1, 11)]
CSRC = Path(ldpc_kernel.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ALL_TABLES)
def test_sync_flag_and_packed_schedule(table):
    kt = tables.kernel_tables(table)
    g, s, f = kt["g_tab"], kt["s_tab"], kt["f_tab"]
    want = np.zeros_like(f)
    for r in range(kt["q"]):
        seen = set()
        for e in range(kt["Dmax"]):
            if f[r, e] & tables.F_VALID:
                want[r, e] = tables.F_SYNC if g[r, e] in seen else 0
                seen.add(g[r, e])
    np.testing.assert_array_equal(f & tables.F_SYNC, want)
    assert not (f & ~(tables.F_VALID | tables.F_MASK0 | tables.F_SYNC
                      | tables.F_BAR)).any()
    assert not (f[:, 1:] & tables.F_BAR).any() and not f[0, 0] & tables.F_BAR
    # padding entries carry no flag at all
    assert not f[(f & tables.F_VALID) == 0].any()
    word = tables.pack_schedule(g, s, f)
    assert word.dtype == np.int32 and word.shape == (kt["q"], kt["Dmax"])
    for got, ref in zip(tables.unpack_schedule(word), (g, s, f)):
        np.testing.assert_array_equal(got, ref)
    # the same on tensors (the receiver packs on its device)
    tw = tables.pack_schedule(*(torch.from_numpy(a) for a in (g, s, f)))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), word)
    # the kernel's own form: the low half is an address base below 2^16
    assert (g * LANES + LANES - s).max() < 1 << 16


def test_every_dmax_has_a_specialisation():
    src = (CSRC / "ldpc_layered.cu").read_text()
    compiled = {int(m) for m in re.findall(r"case (\d+): return launch_decode",
                                           src)}
    needed = {tables.kernel_tables(t)["Dmax"] for t in ALL_TABLES}
    assert needed == compiled
    assert max(needed) <= 32                # one bit an entry in the masks


def _barrier_walk(kt, f):
    """The kernel's order of events under the flags f, with its barriers
    alone: before a layer with F_BAR, after pass 1 of a layer that has
    F_SYNC entries, before each F_SYNC entry of pass 2. Returns (the
    first (layer, entry) at which a posterior address that one row
    updates is read or updated by another row with no barrier between,
    or None; the barriers met)."""
    g, s = kt["g_tab"], kt["s_tab"]
    rows = np.arange(LANES)
    n = (kt["G"] + kt["q"]) * LANES
    # per address: the epoch and row of its last update, and of its
    # reads (r_many: read by more than one row in that epoch)
    w_epoch, w_row = np.full(n, -1), np.full(n, -1)
    r_epoch, r_row = np.full(n, -1), np.full(n, -1)
    r_many = np.zeros(n, bool)
    epoch = 0
    for r in range(kt["q"]):
        valid = [e for e in range(kt["Dmax"]) if f[r, e] & tables.F_VALID]
        epoch += bool(f[r, 0] & tables.F_BAR)
        for write in (False, True):              # pass 1 reads, pass 2 updates
            if write:
                epoch += bool((f[r] & tables.F_SYNC).any())
            for e in valid:
                epoch += bool(write and f[r, e] & tables.F_SYNC)
                addr = g[r, e] * LANES + (rows - s[r, e]) % LANES
                clash = (w_epoch[addr] == epoch) & (w_row[addr] != rows)
                read_now = r_epoch[addr] == epoch
                others = read_now & (r_many[addr] | (r_row[addr] != rows))
                if write:
                    clash |= others
                    w_epoch[addr], w_row[addr] = epoch, rows
                else:
                    r_many[addr] = others
                    r_epoch[addr], r_row[addr] = epoch, rows
                if clash.any():
                    return (r, e), epoch
    return None, epoch


@pytest.mark.parametrize("table", ALL_TABLES)
def test_barriers_separate_rows_that_meet(table):
    kt = tables.kernel_tables(table)
    f = kt["f_tab"]
    clash, n_bars = _barrier_walk(kt, f)
    assert clash is None
    # fewer than the two a layer that the flags replace
    assert n_bars < 2 * kt["q"] + int(((f & tables.F_SYNC) > 0).sum())


@pytest.mark.parametrize("flag", ["F_BAR", "F_SYNC"])
def test_barrier_walk_sees_a_missing_flag(flag):
    """The walk does find rows meeting on B4 once a kind of flag is
    cleared."""
    kt = tables.kernel_tables("B4")
    clash, _ = _barrier_walk(kt, kt["f_tab"] & ~getattr(tables, flag))
    assert clash is not None


def _segments(f_row):
    """Entry indices of a layer cut before every F_SYNC entry: what lies
    between two barriers of pass 2."""
    segs, cur = [], []
    for e, fl in enumerate(f_row):
        if fl & tables.F_SYNC and cur:
            segs.append(cur)
            cur = []
        cur.append(e)
    return segs + [cur]


@pytest.mark.parametrize("table,mult", [("B4", 2), ("B7", 3), ("C5", 3),
                                        ("B9", 4)])
def test_updates_commute_between_barriers(table, mult):
    """Pass 2 alone: saturating updates with random deltas on a
    posterior near saturation. Sequential entry order against the
    entries between two barriers in reversed order."""
    kt = tables.kernel_tables(table)
    g, s, f = kt["g_tab"], kt["s_tab"], kt["f_tab"]
    most = max(np.bincount(g[r][(f[r] & tables.F_VALID) > 0]).max()
               for r in range(kt["q"]))
    assert most == mult
    rng = np.random.default_rng(5)
    NG = kt["G"] + kt["q"]
    rows = np.arange(LANES)
    post0 = rng.integers(-127, 128, (NG, LANES)).astype(np.int32)
    seq, rev = post0.copy(), post0.copy()
    for r in range(kt["q"]):
        delta = rng.integers(-62, 63, (kt["Dmax"], LANES))
        for e in range(kt["Dmax"]):
            if f[r, e] & tables.F_VALID:
                idx = (rows - s[r, e]) % LANES
                seq[g[r, e], idx] = np.clip(seq[g[r, e], idx] + delta[e],
                                            -127, 127)
        for seg in _segments(f[r]):
            for e in reversed(seg):
                if f[r, e] & tables.F_VALID:
                    idx = (rows - s[r, e]) % LANES
                    rev[g[r, e], idx] = np.clip(rev[g[r, e], idx] + delta[e],
                                                -127, 127)
    np.testing.assert_array_equal(rev, seq)
    assert (np.abs(seq) == 127).any() and (seq != post0).any()


def _kernel_a_model(llr_i8, kt, n_iters, beta=1):
    """csrc/ldpc_layered.cu in numpy, all frames and rows at once."""
    G, q, D = kt["G"], kt["q"], kt["Dmax"]
    W = -(-D // 4)
    word = tables.pack_schedule(kt["g_tab"], kt["s_tab"], kt["f_tab"])
    B = llr_i8.shape[0]
    # the frame's LLRs into the posterior's layout, by the kernel's own
    # index arithmetic: info bit n at n, parity bit a at (G + a % q, a // q)
    K, a = G * LANES, np.arange(q * LANES)
    where = np.concatenate([np.arange(K), K + (a % q) * LANES + a // q])
    post = np.zeros((B, K + q * LANES), np.int64)
    post[:, where] = llr_i8
    ref = ldpc_kernel.llr_to_post(torch.from_numpy(llr_i8), G, q)
    assert (post == ref.permute(2, 0, 1).reshape(B, -1).numpy()).all()
    msgs = np.zeros((B, q, W, LANES), np.uint32)
    rows = np.arange(LANES)
    trials = np.full(B, n_iters, np.int32)
    done = np.zeros(B, bool)
    for it in range(n_iters):
        bad = np.zeros(B, np.int64)
        for r in range(q):
            cur = msgs[:, r]
            old = [(cur[:, e // 4] >> (8 * (e % 4)) & 0xFF).astype(np.int8)
                   .astype(np.int64) for e in range(D)]
            gs, ss, fl = tables.unpack_schedule(word[r])
            addr, v, rolled, off = [], [], [], []
            for e in range(D):
                a = gs[e] * LANES + LANES - ss[e] + \
                    np.where(rows < ss[e], rows, rows - LANES)
                addr.append(a)
                rolled.append(post[:, a])
                v.append(rolled[e] - old[e])
                o = np.zeros(LANES, bool) if fl[e] & tables.F_VALID \
                    else np.ones(LANES, bool)
                if fl[e] & tables.F_MASK0:
                    o = o | (rows == 0)
                off.append(o)
            mag = np.stack([np.where(off[e], ldpc_kernel.BIG, np.abs(v[e]))
                            for e in range(D)])
            neg = np.stack([np.where(off[e], False, v[e] < 0)
                            for e in range(D)])
            # the two minima by min and max alone, the parities as the
            # sign of a running xor, as the kernel forms them
            m1 = m2 = np.full_like(mag[0], ldpc_kernel.BIG)
            vx = px = np.zeros_like(mag[0])
            for e in range(D):
                m2 = np.minimum(m2, np.maximum(m1, mag[e]))
                m1 = np.minimum(m1, mag[e])
                vx = vx ^ np.where(off[e], 0, v[e])
                px = px ^ np.where(off[e], 0, rolled[e])
            assert ((vx < 0) == (neg.sum(axis=0) & 1)).all()
            bad += (px < 0).sum(axis=1)
            news = []
            for e in range(D):
                excl = np.where(mag[e] == m1, m2, m1)    # no arg-min
                m = np.clip(excl - beta, 0, ldpc_kernel.MSG_CLIP)
                n = np.where((v[e] ^ vx) < 0, -m, m)
                n = np.where(off[e], 0, n)
                n = np.where((old[e] != 0) & ((old[e] ^ n) < 0), 0, n)
                news.append(n)
            out = np.zeros((B, W, LANES), np.uint32)
            for e in range(D):
                out[:, e // 4] |= (news[e] & 0xFF).astype(np.uint32) \
                    << np.uint32(8 * (e % 4))
            for seg in _segments(fl):
                for e in reversed(seg):
                    if not fl[e] & tables.F_VALID:
                        continue
                    if fl[e] & tables.F_SYNC:
                        p = post[:, addr[e]] + (news[e] - old[e])
                    else:
                        p = v[e] + news[e]
                    post[:, addr[e]] = np.clip(p, -127, 127)
            msgs[:, r] = out
        ok = bad == 0
        trials = np.where(~done & ok, it + 1, trials).astype(np.int32)
        done |= ok
        n_bad = bad.astype(np.int32)
    hard = (post[:, where] < 0).astype(np.uint8)
    post_t = torch.from_numpy(post.reshape(B, G + q, LANES).astype(np.int8))
    assert (hard == ldpc_kernel.post_to_hard(post_t.permute(1, 2, 0), G, q)
            .numpy()).all()
    return hard, n_bad, trials


@pytest.mark.parametrize("table", ALL_TABLES)
def test_kernel_a_model_matches_plain(table):
    """Two sweeps on random int8 LLRs large enough to saturate: every
    Dmax, every F_SYNC entry and every padding entry takes part."""
    kt = tables.kernel_tables(table)
    rng = np.random.default_rng(ALL_TABLES.index(table))
    llr = rng.integers(-40, 41, (2, kt["N"])).astype(np.int8)
    ref = ldpc_kernel.decode_plain(torch.from_numpy(llr), kt, 2,
                                   early_exit=False)
    got = _kernel_a_model(llr, kt, 2)
    for name, a, b in zip(("hard", "n_bad", "trials"), got, ref):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------

def _branch_pattern(ns, j):
    """branch_pattern of csrc/viterbi_acs.cu, line for line."""
    s = ((ns & 7) << 3) | j
    pat = 0
    for i in range(3):
        b = (ns >> (3 + i)) & 1
        v = (b << 6) | s
        pat |= (bin(v & dvbs_fec.G1).count("1") & 1) << (2 * i)
        pat |= (bin(v & dvbs_fec.G2).count("1") & 1) << (2 * i + 1)
        s = (b << 5) | (s >> 1)
    return pat


def test_pattern_table_equals_trellis_signs():
    sign = tables.trellis_k(3)[0]
    pat = vk.pattern_table()
    assert pat.shape == (64, 8) and pat.min() >= 0 and pat.max() < 64
    np.testing.assert_array_equal(
        1.0 - 2.0 * ((pat[..., None] >> np.arange(6)) & 1), sign)
    np.testing.assert_array_equal(
        pat, [[_branch_pattern(ns, j) for j in range(8)] for ns in range(64)])
    # lane l's states l and l ^ 40 share lo, hence their 8 predecessors,
    # and the second's branches are the first's complemented, halves
    # swapped, hence its branch metrics the first's negated
    ns, j = np.arange(32)[:, None], np.arange(8)[None, :]
    assert sorted((ns ^ 40).ravel()) == list(range(32, 64))
    assert ((ns ^ 40) & 7 == ns & 7).all()
    np.testing.assert_array_equal(pat[ns ^ 40, j], pat[ns, j ^ 4] ^ 63)


@pytest.mark.parametrize("kind", ["noisy", "erasures", "small_integers"])
def test_shared_branch_sums_equal_ordered_sums(kind):
    rng = np.random.default_rng(11)
    r = rng.normal(0, 3.0, (4000, 6))
    if kind == "erasures":
        r[:, 1::2] = np.where(rng.random((4000, 3)) < 0.4, 0.0, r[:, 1::2])
    if kind == "small_integers":            # exact cancellations
        r = rng.integers(-3, 4, (4000, 6)).astype(np.float64)
    r = bf16_round(torch.from_numpy(r.astype(np.float32)))
    sign = torch.from_numpy(tables.trellis_k(3)[0])
    ref = r[:, None, None, 0] * sign[:, :, 0]
    for q in range(1, 6):
        ref = ref + r[:, None, None, q] * sign[:, :, q]
    got = vk.branch_metrics_shared(r)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, ref)            # every value (-0 == +0)
    differ = got.view(torch.int32) != ref.view(torch.int32)
    assert bool((ref[differ] == 0).all())   # bit patterns but a zero's sign
    # the ordered sum of the negated terms (the pattern with every sign
    # flipped, formed directly) is the negated sum
    tab = vk.branch_sum_table(r)
    assert torch.equal(vk.branch_sum_table(-r), -tab)


def _kernel_c_model(llrs):
    """csrc/viterbi_acs.cu in PyTorch: shared branch sums, lane l with
    the states l and l ^ 40 (the second's branch metrics the first's,
    negated, halves swapped), a decision byte a lane, traceback by lane
    and nibble."""
    B, T, _ = llrs.shape
    n = -(-T // 3)
    x = bf16_round(llrs)
    x = torch.nn.functional.pad(x, (0, 0, 0, 3 * n - T)).reshape(B, n, 6)
    bm = vk.branch_metrics_shared(x)                    # [B, n, 64, 8]
    first, second = torch.arange(32), torch.arange(32) ^ 40
    swap = torch.arange(8) ^ 4
    bm[:, :, second] = -bm[:, :, first][..., swap]
    pred = (torch.arange(64)[:, None] & 7) * 8 + torch.arange(8)
    pm = torch.zeros(B, 64)
    dec = torch.zeros((n, B, 32), dtype=torch.int64)
    for t in range(n):
        c = pm[:, pred] + bm[:, t]                      # [B, 64, 8]
        idx = torch.arange(8).expand_as(c)
        for half in (4, 2, 1):
            w = c[..., half:2 * half] > c[..., :half]
            c = torch.where(w, c[..., half:2 * half], c[..., :half])
            idx = torch.where(w, idx[..., half:2 * half], idx[..., :half])
        pm, d = c[..., 0], idx[..., 0]
        dec[t] = d[:, first] | (d[:, second] << 4)
    s = torch.zeros(B, dtype=torch.int64)
    trace = torch.zeros((n, B), dtype=torch.int64)
    for t in range(n - 1, -1, -1):
        trace[t] = s
        lane = (s & 31) ^ ((s >> 5) << 3)
        byte = dec[t].gather(1, lane[:, None])[:, 0]
        s = (s & 7) * 8 + ((byte >> ((s >> 5) << 2)) & 7)
    i = torch.arange(T)
    return ((trace[i // 3] >> (3 + i % 3)[:, None]) & 1).T.to(torch.uint8)


@pytest.mark.parametrize("B,T", [(9, 151), (3, 704), (2, 1), (2, 2), (2, 3),
                                 (2, 4), (2, 5)])
def test_kernel_c_model_matches_plain(B, T):
    rng = np.random.default_rng(100 + T)
    x = rng.normal(0, 1.5, (B, T, 2)) + \
        2.0 * (1 - 2 * rng.integers(0, 2, (B, T, 2)))
    x[:, ::3, 1] = 0.0
    x[-1] = 0.0                                         # one all-erasure
    x = torch.from_numpy(x.astype(np.float32))
    assert torch.equal(_kernel_c_model(x), vk.decode_plain(x))
