"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one; they run on
the machine with the card, which has no JAX, so this file (unlike the
other test_torch_* files) imports nothing of JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances and why:
- kernel A (int8 layered LDPC): bit-exact hard, n_bad, trials (integer
  arithmetic);
- kernel B (resampler): its shifts and band coordinates bit-exact with
  shifts_and_band's; the output within 1e-5 max abs (float32; the
  kernel fuses the multiply-adds of the tap polynomial and the tap sum
  that the plain version rounds one by one);
- kernel C (Viterbi): bit-exact on every output bit (both sum the same
  bf16-rounded terms in the same order and break ties alike);
- the soft demapper (demap.against_plain): each LLR within 1e-5 x sca x
  (1 + ss |x| + ps max|p|) / npwr of the plain version's, the largest
  |z| its log-sum-exps meet times the LLR scale (float32, the same
  formula; the sums and the library's reductions run in another order,
  and torch's complex abs is a hypot where the kernel takes the square
  root of a fused square sum). Where the plain version's LLR before the
  clamp lies within that tolerance of 127 x 2^j, the count of halvings
  may differ by one: there one halving more or fewer is accepted, for
  at most 1% of a case's LLRs;
- the small DVB-S2 banks (QPSK without pilots, 8PSK with pilots) on the
  card against the same bank on the CPU: decoded bytes, flags and PLS
  exact, quality within 1e-3 (float32 sums in another order);
- the small DVB-S bank step on the card against the same step on the
  CPU: decoded bits and re-encode BER exact (a 12 dB signal decodes to
  the bits sent on both), hints within 1e-3;
- the resampler's probe stages: max abs error 0 (copies, adds, and a
  polynomial rounded one operation at a time as the plain version);
- the single-carrier receiver and stream (pilotless 8PSK, the
  decision-directed track) on the card, no device named, against the
  same on the CPU: frame verdicts, trials and bytes exact;
- the single-carrier DVB-S stream (rate 3/4, found by the lock search)
  and the first-block DVB-S bank on the card against the same on the
  CPU: TS bytes, decoded bits and re-encode BER exact (12 dB);
- DVBS2Receiver(equalize=True) on the card against the CPU: frame
  verdicts and bytes exact, the equalized symbols within 1e-4 max abs
  (cuBLAS and cuSOLVER against the CPU's BLAS and LAPACK);
- the sharded builds at world size 1 over NCCL against the unsharded
  programs on the card: every output exact (the same kernels on the
  same inputs);
- the bank step replayed as CUDA graphs (graphs.py) against its eager
  `enqueue` on the same blocks: every output and the launch counts
  exact (the same kernels on the same inputs, in the same order);
- the bank stream on the card, fed two blocks a call with a long sleep
  queued behind each look-ahead step, against the same stream on the
  CPU: TS bytes exact (a 6 dB QPSK 1/2 signal decodes to the packets
  sent on both).
"""
import warnings

import numpy as np
import pytest
import torch

from dvbs_tpu_torch import backend, graphs, profiling, tables
from dvbs_tpu_torch.kernels import probe_resample as pr
from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
from dvbs_tpu_torch.models.driver import DVBS2Stream
from dvbs_tpu_torch.models.dvbs import DVBSStream
from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver
from dvbs_tpu_torch.ops import demap, ldpc_kernel
from dvbs_tpu_torch.ops import resample_kernel as rk
from dvbs_tpu_torch.ops import viterbi_kernel as vk
from dvbs_tpu_torch.ops.frontend import pack_cs4
from dvbs_tpu_torch.parallel import dvbs_bank, mesh
from dvbs_tpu_torch.spec import ldpc_spec, modcod
from dvbs_tpu_torch.tx import channel, dvbs2_mod, dvbs_mod

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _resample_case(name):
    rng = np.random.default_rng({"drift": 0, "ragged": 1, "large": 2,
                                 "odd_rows": 3}[name])
    S = {"drift": 8192, "ragged": 4096 + 128, "large": 8192,
         "odd_rows": 8192}[name]
    # odd_rows: rows of an odd length, so that every other row's windows
    # start at 8-byte but not 16-byte aligned addresses
    n2 = 2 * S + (63 if name == "odd_rows" else 64)
    y = (rng.normal(size=(3, n2)) + 1j * rng.normal(size=(3, n2))
         ).astype(np.complex64)
    k = np.arange(S)
    if name == "large":
        t = np.stack([2.0 * k - 1.4 + 4e-5 * k, 2.0 * k + 3.2 - 3e-5 * k,
                      2.0 * k + 0.5])
    else:
        t = np.stack([2.0 * k + 0.3 + 0.17 * c + (1 + 0.2 * c) * 1e-5 * k
                      for c in range(3)])
    return y, t.astype(np.float32)


@pytest.mark.parametrize("name", ["drift", "ragged", "large", "odd_rows"])
def test_resample_kernel_matches_plain(dev, name):
    y, t = _resample_case(name)
    coef, fmid, fhalf = tables.farrow_coeffs()
    y, t = torch.from_numpy(y).to(dev), torch.from_numpy(t).to(dev)
    coef = torch.from_numpy(coef).to(dev)
    u, rb, bias = rk.shifts_and_band(t, (fmid, fhalf))
    ku, krb = torch.empty_like(u), torch.empty_like(rb)
    got = rk.resample_cuda(y, t, coef, (fmid, fhalf), band_out=(ku, krb))
    ref = rk.resample_plain(y, u, rb, bias, coef, t.shape[1])
    torch.cuda.synchronize()
    assert torch.equal(krb, rb)
    assert torch.equal(ku.view(torch.int32), u.view(torch.int32))
    assert torch.equal(rk.resample(y, t, coef, (fmid, fhalf)), got)
    assert float(torch.abs(got - ref).max()) <= 1e-5


@pytest.fixture(scope="module")
def c4_llrs():
    code = ldpc_spec.get_code("C4")
    rng = np.random.default_rng(0)
    cw = code.encode(rng.integers(0, 2, (128, code.K)).astype(np.uint8))
    sigma = np.sqrt(10 ** (-3.0 / 10))
    y = 1.0 - 2.0 * cw.astype(np.float32) + \
        rng.normal(0, sigma, cw.shape).astype(np.float32)
    return ldpc_kernel.quantize_llrs(torch.from_numpy(2.0 * y / sigma ** 2))


@pytest.mark.parametrize("n_iters,early_exit", [(1, False), (3, False),
                                                (12, True)])
def test_ldpc_kernel_matches_plain(dev, c4_llrs, n_iters, early_exit):
    kt = tables.kernel_tables("C4")
    x = c4_llrs.to(dev)
    got = ldpc_kernel.decode_cuda(x, kt, n_iters, early_exit=early_exit)
    ref = ldpc_kernel.decode_plain(x, kt, n_iters, early_exit=early_exit)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_ldpc_kernel_b4_one_sweep(dev):
    kt = tables.kernel_tables("B4")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-25, 26, (128, kt["N"]))
                         .astype(np.int8)).to(dev)
    got = ldpc_kernel.decode_cuda(x, kt, 1, early_exit=False)
    ref = ldpc_kernel.decode_plain(x, kt, 1, early_exit=False)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("table,rate,ebno", [("B7", 3 / 4, 3.0),
                                             ("B6", 2 / 3, 2.6)])
def test_ldpc_kernel_pilots_tables(dev, table, rate, ebno):
    """The pilots banks' tables (8PSK and 32APSK 3/4: B7, Dmax 14;
    16APSK 2/3: B6, Dmax 10) at [128, 64800]: one sweep on random int8,
    and 12 sweeps with early exit on codewords near the threshold."""
    kt = tables.kernel_tables(table)
    code = ldpc_spec.get_code(table)
    rng = np.random.default_rng(7)
    rand = rng.integers(-25, 26, (128, kt["N"])).astype(np.int8)
    cw = code.encode(rng.integers(0, 2, (128, code.K)).astype(np.uint8))
    sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebno / 10)))
    y = 1.0 - 2.0 * cw.astype(np.float32) + \
        rng.normal(0, sigma, cw.shape).astype(np.float32)
    noisy = ldpc_kernel.quantize_llrs(torch.from_numpy(2.0 * y / sigma ** 2))
    for x, n_iters, ee in ((torch.from_numpy(rand), 1, False),
                           (noisy, 12, True)):
        x = x.to(dev)
        got = ldpc_kernel.decode_cuda(x, kt, n_iters, early_exit=ee)
        ref = ldpc_kernel.decode_plain(x, kt, n_iters, early_exit=ee)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert int(got[2].max()) > 1 and bool((got[1] == 0).all())
    assert (got[0].cpu().numpy() == cw).all()


ALL_TABLES = [f"B{i}" for i in range(1, 12)] + [f"C{i}" for i in range(1, 11)]


@pytest.mark.parametrize("table", ALL_TABLES)
def test_ldpc_kernel_every_table(dev, table):
    """Every Dmax specialisation, barrier flag and padding entry: three
    frames of random int8 LLRs, two fixed sweeps (the second meets
    messages), and three sweeps through the early exit's agreement."""
    kt = tables.kernel_tables(table)
    rng = np.random.default_rng(30 + ALL_TABLES.index(table))
    x = torch.from_numpy(rng.integers(-40, 41, (3, kt["N"]))
                         .astype(np.int8)).to(dev)
    for n_iters, ee in ((2, False), (3, True)):
        got = ldpc_kernel.decode_cuda(x, kt, n_iters, early_exit=ee)
        ref = ldpc_kernel.decode_plain(x, kt, n_iters, early_exit=ee)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_dispatch_counts_launches_and_checks_inputs(dev, c4_llrs):
    backend.reset_launches()
    ldpc_kernel.decode(c4_llrs[:4].to(dev), "C4", n_iters=3,
                       early_exit=False)
    assert backend.LAUNCHES["ldpc_layered"] == 1      # one launch a call
    with pytest.raises(TypeError):
        ldpc_kernel.decode_cuda(c4_llrs[:4].to(dev, torch.int16),
                                tables.kernel_tables("C4"), 1)


def test_small_bank_on_card_matches_cpu(dev):
    cfg = modcod.get_config(4, short=True)
    block = mesh.bank_block_symbols(2, mc=4, short=True, frames_total=4)
    sigs = []
    for seed, cfo in ((7, 0.004 * np.pi), (8, -0.009 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(120, seed=seed)
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=6.0, cfo=cfo,
                           delay_samples=0.3, seed=seed)
        sigs.append(pack_cs4(y[:2 * block]))
    x = torch.from_numpy(np.stack(sigs))
    outs = []
    for d in (torch.device("cpu"), dev):
        step, _ = mesh.build_carrier_bank(2, mc=4, short=True,
                                          block_symbols=block, fec="int8",
                                          ingest="cs4", device=d)
        backend.reset_launches()
        outs.append({k: v.cpu().numpy() for k, v in step(x.to(d)).items()})
        if d.type == "cuda":
            assert backend.LAUNCHES["ldpc_layered"] > 0
            assert backend.LAUNCHES["resample_farrow"] > 0
            assert backend.LAUNCHES["soft_demap"] == 1
    cpu, gpu = outs
    assert cpu["ldpc_ok"].all()
    for k in ("kbch_bytes", "ldpc_ok", "bch_bad", "pls"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    assert np.abs(gpu["quality"] - cpu["quality"]).max() <= 1e-3


def test_small_pilots_bank_on_card_matches_cpu(dev):
    """8PSK 2/3 short frames with pilots, two carriers at 10 dB: the
    pilot-anchor track and the 8PSK demap on the card."""
    cfg = modcod.get_config(13, short=True, pilots=True)
    block = mesh.bank_block_symbols(2, mc=13, short=True, pilots=True,
                                    frames_total=4)
    sigs = []
    for seed, cfo in ((21, 0.006 * np.pi), (34, -0.011 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(60, seed=seed)
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=10.0, cfo=cfo,
                           delay_samples=0.3, sco_ppm=10.0, seed=seed + 1)
        sigs.append(pack_cs4(y[:2 * block]))
    x = torch.from_numpy(np.stack(sigs))
    outs = []
    for d in (torch.device("cpu"), dev):
        step, _ = mesh.build_carrier_bank(2, mc=13, short=True, pilots=True,
                                          block_symbols=block, fec="int8",
                                          ingest="cs4", device=d)
        outs.append({k: v.cpu().numpy() for k, v in step(x.to(d)).items()})
    cpu, gpu = outs
    assert cpu["ldpc_ok"].all()
    for k in ("kbch_bytes", "ldpc_ok", "bch_bad", "pls"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    assert np.abs(gpu["quality"] - cpu["quality"]).max() <= 1e-3


def _bank_stream_ts(d, sigs, block, sleep_cycles=0):
    """A 2-carrier QPSK 1/2 bank stream on device `d` fed two blocks a
    call, then flushed: (TS bytes per carrier, the stream, for each
    finalize that ran after a look-ahead step and the sleep of
    `sleep_cycles` queued behind it, whether the stream was still busy
    when the finalize returned, and for each finalize then, whether the
    block's host copies were pinned)."""
    st = DVBS2BankStream(2, mc=4, short=True, block_symbols=block,
                         fec="int8", ingest="cs4", device=d)
    busy, armed, pinned = [], [], []
    if sleep_cycles:
        step, finalize = st.step_fn, st._finalize

        def step_fn(x):
            out = step(x)
            if st._pending is not None:         # a look-ahead step
                torch.cuda._sleep(sleep_cycles)
                armed.append(True)
            return out

        def spy(dev_out, outs):
            host, _ = dev_out["host"]
            pinned.append(all(t.is_pinned() for t in host.values()))
            res = finalize(dev_out, outs)
            if armed:
                busy.append(not torch.cuda.current_stream(d).query())
                armed.clear()
            return res
        st.step_fn, st._finalize = step_fn, spy
    outs = [bytearray(), bytearray()]
    n, chunk = len(sigs[0]), 4 * block
    for lo in range(0, n, chunk):
        for c, o in zip(st.feed([s[lo:lo + chunk] for s in sigs]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    return [bytes(o) for o in outs], st, busy, pinned


def test_bank_finalize_waits_on_its_own_step_only(dev):
    """The early fetch: a block's finalize waits on the event after its
    own step's copies, not on the look-ahead step queued after them. A
    sleep of ~0.25 s queued behind every look-ahead step is still
    running when the pending block's finalize returns (the signal is
    clean, so no escalation or BCH repair fetches behind it); the
    copies land in pinned memory; the TS bytes equal the CPU's."""
    cfg = modcod.get_config(4, short=True)
    block = mesh.bank_block_symbols(2, mc=4, short=True, frames_total=4)
    sigs = []
    for seed, cfo in ((7, 0.004 * np.pi), (8, -0.009 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(200, seed=seed)
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=6.0, cfo=cfo,
                           delay_samples=0.3, sco_ppm=10.0, seed=seed)
        sigs.append(pack_cs4(y))
    n = min(len(s) for s in sigs)
    sigs = [s[:n] for s in sigs]
    want, _, _, _ = _bank_stream_ts(torch.device("cpu"), sigs, block)
    got, st, busy, pinned = _bank_stream_ts(dev, sigs, block,
                                            sleep_cycles=500_000_000)
    assert st.stats.escalations == 0 and st.stats.bch_repaired == 0
    assert len(busy) >= 3 and all(busy), busy
    assert pinned and all(pinned)
    assert st.stats.fetches == st._dispatched
    assert st.stats.fetch_ready <= st.stats.blocks
    assert (st.frames_ok == st.frames_seen).all()
    assert got == want and all(len(t) > 0 for t in got)


# ---------------------------------------------------------------------------
# the soft demapper
# ---------------------------------------------------------------------------

DEMAP_MODCODS = (4, 13, 18, 24)         # QPSK, 8PSK, 16APSK, 32APSK
DEMAP_CASES = ("noisy", "on_point", "far", "zero", "clamp", "ragged",
               "strided")


def _demap_case(mc: int, name: str):
    """(syms complex64, npwr) of case `name` for MODCOD mc: noisy points
    [8, 4096]; each point where its scaled distance is 0; far outside the
    outer ring (|x| 10 to 1000, where a subset's exps underflow); zero;
    npwr 1/32, so that the halving clamp acts; 7 x 256 + 37 symbols; and
    [64, 1000], of which the test takes a non-contiguous view."""
    cfg = modcod.get_config(mc)
    pts = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)[0]
    ss, ps, _ = tables.DEMAP_SCALES[cfg.constellation]
    rng = np.random.default_rng(100 + mc)

    def noisy(*shape):
        return pts[rng.integers(0, len(pts), shape)] + 0.15 * (
            rng.normal(size=shape) + 1j * rng.normal(size=shape))
    npwr = 1.0
    if name in ("noisy", "clamp"):
        x = noisy(8, 4096)
        npwr = 1 / 32 if name == "clamp" else 1.0
    elif name == "on_point":
        x = np.tile(pts * (ps / ss), 40)
    elif name == "far":
        x = noisy(4096) * 10.0 ** rng.uniform(1, 3, 4096)
    elif name == "zero":
        x = np.zeros(1000)
    elif name == "ragged":
        x = noisy(7 * 256 + 37)
    else:
        x = noisy(64, 1000)
    return torch.from_numpy(x.astype(np.complex64)), npwr


@pytest.mark.parametrize("case", DEMAP_CASES)
@pytest.mark.parametrize("mc", DEMAP_MODCODS)
def test_soft_demap_kernel_matches_plain(dev, mc, case):
    cfg = modcod.get_config(mc)
    kind = cfg.constellation
    p, m0 = tables.demap_tables(kind, cfg.g1, cfg.g2)
    pts, mask0 = torch.from_numpy(p).to(dev), torch.from_numpy(m0).to(dev)
    x, npwr = _demap_case(mc, case)
    x = x.to(dev)
    if case == "strided":
        x = x[:, ::2].T
        assert not x.is_contiguous()
    backend.reset_launches()
    got = demap.soft_demap(x, kind, pts, mask0, npwr)
    assert backend.LAUNCHES["soft_demap"] == 1
    assert (x.numel(), len(p)) in backend.SHAPES["soft_demap"]
    torch.cuda.synchronize()
    share, _, at_step = demap.against_plain(got, x, kind, pts, mask0, npwr)
    assert share <= 1 and 100 * at_step <= got.numel(), (share, at_step)
    if case == "clamp":
        raw = demap.llrs_unclamped(x, kind, pts, mask0, npwr)
        assert bool((raw.abs() > 127).any())
        assert float(got.abs().max()) <= 127


def test_soft_demap_kernel_refuses(dev):
    cfg = modcod.get_config(24)
    p, m0 = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)
    pts = torch.from_numpy(p).to(dev)
    x = torch.zeros(10, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        demap.soft_demap(x, cfg.constellation, pts,
                         torch.from_numpy(m0[::-1].copy()).to(dev))
    with pytest.raises(TypeError):
        demap.soft_demap(x.to(torch.complex128), cfg.constellation, pts,
                         torch.from_numpy(m0).to(dev))


def test_bank_step_llrs_with_kernel_match_plain(dev, monkeypatch):
    """A 2-carrier 32APSK 3/4 pilots bank (4 normal frames) at 14.5 dB:
    the step's one demapper launch, its LLRs against the plain version
    on the same payload, and the step's LLRs and decoded bytes against
    the same step with the plain demapper."""
    mc = 24
    cfg = modcod.get_config(mc, pilots=True)
    block = mesh.bank_block_symbols(2, mc=mc, pilots=True, frames_total=4)
    sigs = []
    for seed, cfo in ((41, 0.005 * np.pi), (42, -0.008 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(200, seed=seed)
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=14.5, cfo=cfo,
                           delay_samples=0.3, sco_ppm=10.0, seed=seed + 1)
        sigs.append(pack_cs4(y[:2 * block]))
    x = torch.from_numpy(np.stack(sigs)).to(dev)
    step, _, _ = mesh.build_carrier_bank(
        2, mc=mc, pilots=True, block_symbols=block, fec="int8",
        ingest="cs4", stream_outputs=True, device=dev)
    seen, real = [], demap.soft_demap

    def spy(*a, **k):
        seen.append((a, real(*a, **k)))
        return seen[-1][1]
    monkeypatch.setattr(demap, "soft_demap", spy)
    backend.reset_launches()
    got = {k: v.cpu() for k, v in step(x).items()}
    assert backend.LAUNCHES["soft_demap"] == 1
    (syms, kind, pts, mask0), llr = seen[0]
    assert (syms.numel(), 32) in backend.SHAPES["soft_demap"]
    share, _, at_step = demap.against_plain(llr, syms, kind, pts, mask0)
    assert share <= 1 and at_step == 0, (share, at_step)
    monkeypatch.setattr(demap, "soft_demap", demap.soft_demap_plain)
    ref = {k: v.cpu() for k, v in step(x).items()}
    assert backend.LAUNCHES["soft_demap"] == 1
    ss, ps, sca = tables.DEMAP_SCALES[kind]
    tol = 1e-5 * sca * (1 + ss * float(syms.abs().max()) +
                        ps * float(pts.abs().max()))
    assert float((got["llrs"] - ref["llrs"]).abs().max()) <= tol
    assert bool(ref["ldpc_ok"].all())
    for k in ("kbch_bytes", "ldpc_ok", "bch_bad", "pls"):
        assert torch.equal(got[k], ref[k]), k


# ---------------------------------------------------------------------------
# the bank step as CUDA graphs (graphs.py)
# ---------------------------------------------------------------------------

# 2-carrier banks of 4 frames a step: MODCOD, short, pilots, fec, Es/N0 dB
GRAPH_BANKS = {"32apsk34p": (24, False, True, "int8", 14.5),
               "qpsk12": (4, False, False, "int8", 6.0),
               "qpsk12_xla": (4, True, False, "xla", 6.0)}


def _bank_blocks(mc, short, pilots, snr, blocks=4):
    """`blocks` cs4 blocks of a 2-carrier bank, each a quarter block on
    from the last, and the bank's block symbols."""
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    block = mesh.bank_block_symbols(2, mc=mc, short=short, pilots=pilots,
                                    frames_total=4)
    n = 2 * block
    need = n + (blocks - 1) * (n // 4)
    per_frame = (cfg.kbch - 80) // 8 // 188
    n_pkts = (need // (2 * cfg.plframe_len) + 3) * per_frame
    sigs = []
    for seed, cfo in ((51, 0.005 * np.pi), (52, -0.008 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=snr, cfo=cfo,
                           delay_samples=0.3, sco_ppm=10.0, seed=seed + 1)
        assert len(y) >= need
        sigs.append(pack_cs4(y[:need]))
    sig = np.stack(sigs)
    return [sig[:, k * (n // 4):k * (n // 4) + n] for k in range(blocks)], \
        block


@pytest.mark.parametrize("case", list(GRAPH_BANKS))
def test_replayed_bank_step_equals_enqueue(dev, case):
    """Consecutive blocks through the bank (the first call eager, the
    second captured, then replays): every output equal to the eager
    `enqueue` on the same block bit for bit, the same launch counts a
    step, and each block's outputs unchanged by the replays after it; a
    new input shape captures again."""
    mc, short, pilots, fec, snr = GRAPH_BANKS[case]
    blocks, block = _bank_blocks(mc, short, pilots, snr)
    xs = [torch.from_numpy(np.ascontiguousarray(b)).to(dev) for b in blocks]
    step, _, _ = mesh.build_carrier_bank(
        2, mc=mc, short=short, pilots=pilots, block_symbols=block, fec=fec,
        ingest="cs4", stream_outputs=True, device=dev)
    ref, ref_launches = [], []
    with torch.no_grad():
        for x in xs:
            backend.reset_launches()
            ref.append(step.enqueue(x))
            ref_launches.append(dict(backend.LAUNCHES))
        got, kept = [], []
        for x, launches in zip(xs, ref_launches):
            backend.reset_launches()
            got.append(step(x))
            assert backend.LAUNCHES == launches
            kept.append({k: v.cpu() for k, v in got[-1].items()})
    assert step.counts == dict(graph_captures=1, graph_replays=3,
                               eager_steps=1)
    assert step._graph.segments >= 8        # the layers' spans at least
    if fec == "int8":
        assert ref_launches[0]["ldpc_layered"] == 1
        assert ref_launches[0]["soft_demap"] == 1
    assert bool(ref[0]["ldpc_ok"].any())
    for g, k, r in zip(got, kept, ref):
        assert g.keys() == r.keys()
        for name in r:
            assert torch.equal(g[name], r[name]), (case, name)
            assert torch.equal(g[name].cpu(), k[name]), (case, name)

    one = xs[0][:1].contiguous()            # a new input shape
    with torch.no_grad():
        want = step.enqueue(one)
        step(one)                           # eager: a new key
        out = step(one)                     # captured again
    assert step.counts == dict(graph_captures=2, graph_replays=4,
                               eager_steps=2)
    for name in want:
        assert torch.equal(out[name], want[name]), (case, name)


def test_recorder_leaves_out_empty_graphs(dev):
    """Span edges with no launch between them: torch's capture_end warns
    with graphs.EMPTY for each graph that captured nothing, and the
    recorder leaves those out of the chain and holds back their warning;
    the chain still replays what it captured. Fails if torch's warning
    no longer starts with graphs.EMPTY."""
    def fn(x):
        with profiling.span("outer"):
            with profiling.span("inner"):
                x.add_(1.0)
        return {"x": x}

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = graphs.StepGraph(fn, torch.zeros(4, device=dev))
    assert not [w for w in caught if graphs.EMPTY in str(w.message)]
    # a graph before, between and after the four edges; only the one
    # inside "inner" captured anything
    assert len(step.graphs) == 5 and step.segments == 1
    out = step(torch.full((4,), 2.0, device=dev))
    assert torch.equal(out["x"], torch.full((4,), 3.0, device=dev))


VITERBI_SHAPES = {"noisy": (256, 704), "ragged": (130, 151),
                  "ragged_cta": (4097, 704), "long": (8, 2240),
                  "receiver": (112, 2240),
                  "one_a_cta": (3, 4000),
                  **{f"T{t}": (130, t) for t in range(1, 6)}}


def _viterbi_case(name):
    """noisy and ragged as before; ragged_cta leaves the last CTA one
    segment of four, long is the single-carrier DVB-S receiver's segment
    (core 2048 + 2 x 96) and receiver its block at rate 7/8 and 2^17
    symbols (112 segments), one_a_cta is longer than four segments a CTA
    can be, T1..T5 end inside the first ACS steps."""
    rng = np.random.default_rng({"noisy": 3, "ragged": 4, "erased": 0}
                                .get(name, 5))
    if name == "erased":
        return np.zeros((1, 704, 2), np.float32)
    B, T = VITERBI_SHAPES[name]
    x = rng.normal(0, 1.5, (B, T, 2))
    if name == "noisy":
        x += 2.0 * (1 - 2 * rng.integers(0, 2, (B, T, 2)))
    x[:, ::3, 1] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["noisy", "ragged", "erased", "ragged_cta",
                                  "long", "receiver", "one_a_cta", "T1", "T2",
                                  "T3", "T4", "T5"])
def test_viterbi_kernel_matches_plain(dev, name):
    x = torch.from_numpy(_viterbi_case(name)).to(dev)
    backend.reset_launches()
    got = vk.decode_segments(x)
    assert backend.LAUNCHES["viterbi_acs"] == 1
    ref = vk.decode_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    with pytest.raises(TypeError):
        vk.decode_cuda(x.to(torch.float16))


def test_viterbi_kernel_refuses_a_segment_too_long(dev):
    with pytest.raises(ValueError):
        vk.decode_cuda(torch.zeros((1, 1 << 15, 2), device=dev))


def test_dvbs_bank_step_on_card_matches_cpu(dev):
    C, n = 2, 1 << 15
    sigs = []
    for seed, cfo in ((61, 0.011), (62, -0.017)):
        ts = dvbs_mod.random_ts_groups(6, seed=seed)
        tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=12.0, cfo=cfo,
                           delay_samples=0.3, sco_ppm=10.0, seed=seed + 1)
        sigs.append(pack_cs4(y))
    # two blocks on the CPU stream give locked, carried hints
    st = dvbs_bank.DVBSBankStream(C, rate="1/2", block_samples=n,
                                  ingest="cs4")
    st.feed([s[:2 * n] for s in sigs])
    assert st.locked.all()
    lo = [2 * n - len(f) for f in st._fifos]
    x = torch.from_numpy(np.stack([s[a:a + n] for s, a in zip(sigs, lo)]))
    h = torch.from_numpy(st._hints.copy())
    outs = []
    for d in (torch.device("cpu"), dev):
        step, _, _ = dvbs_bank.build_dvbs_stream_bank(
            C, rate="1/2", block_samples=n, ingest="cs4", device=d)
        backend.reset_launches()
        outs.append({k: v.cpu().numpy() for k, v in
                     step(x.to(d), h.to(d)).items()})
        if d.type == "cuda":
            assert backend.LAUNCHES["viterbi_acs"] == 1
            assert backend.LAUNCHES["resample_farrow"] == 1
    cpu, gpu = outs
    assert cpu["ber"].max() < 0.05
    np.testing.assert_array_equal(gpu["bits"], cpu["bits"])
    np.testing.assert_array_equal(gpu["ber"], cpu["ber"])
    assert np.abs(gpu["hints"] - cpu["hints"]).max() <= 1e-3


# ---------------------------------------------------------------------------
# the resampler's probe stages, kernel A at small batches, the receiver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", list(pr.STAGES))
def test_probe_stage_matches_plain(dev, stage):
    for kw in (dict(), dict(C=3, nck=5, TC=4, seed=2)):
        inp = pr.make_inputs(stage, dev, **kw)
        n0 = backend.LAUNCHES["resample_probe"]
        got = pr.run_stage(inp)
        assert backend.LAUNCHES["resample_probe"] == n0 + 1
        ref = pr.stage_plain(inp)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), float((got - ref).abs().max())


def test_probe_split_matches_kernel_b(dev):
    sp = pr.make_split_inputs(dev, C=3, S=70000, seed=4)
    nt = sp["rb"].shape[1]
    planes = pr.split_prep(sp["y2"], nt, sp["bias"])
    for p, r in zip(planes, pr.split_prep_plain(sp["y2"], nt, sp["bias"])):
        assert torch.equal(p, r)
    got = pr.split_kernel(planes, sp["u"], sp["rb"], sp["coef"], sp["S"])
    fused = rk.resample_cuda(sp["y2"], sp["t"], sp["coef"], sp["band"])
    ref = rk.resample_plain(sp["y2"], sp["u"], sp["rb"], sp["bias"],
                            sp["coef"], sp["S"])
    torch.cuda.synchronize()
    # the split rounds each operation as the plain version; kernel B
    # fuses its multiply-adds
    assert torch.equal(got, ref)
    assert float(torch.abs(got - fused).max()) <= 1e-5


@pytest.mark.parametrize("F", [1, 3, 8, 130])
def test_ldpc_kernel_any_frame_count(dev, c4_llrs, F):
    """The single-carrier receiver hands the kernel its F frames as they
    are; above 128 frames decode_calls cuts them into calls."""
    x = torch.cat([c4_llrs, c4_llrs])[:F].to(dev)
    got = ldpc_kernel.decode_calls(x, "C4", 12)
    ref = ldpc_kernel.decode_calls(x.cpu(), "C4", 12)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_ldpc_kernel_more_frames_than_a_call(dev, c4_llrs):
    """One call of 130 short frames with early exit: several blocks
    share an SM, so the cooperative launch holds them all; a call the
    card cannot hold at once is refused by the launch, not by a hang."""
    kt = tables.kernel_tables("C4")
    x = torch.cat([c4_llrs, c4_llrs])[:130].to(dev)
    got = ldpc_kernel.decode_cuda(x, kt, 12)
    ref = ldpc_kernel.decode_plain(x, kt, 12)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    kt = tables.kernel_tables("B4")
    with pytest.raises(RuntimeError):
        ldpc_kernel.decode_cuda(
            torch.zeros((400, kt["N"]), dtype=torch.int8, device=dev), kt, 2)
    torch.cuda.synchronize()


def test_receiver_and_stream_on_the_card(dev):
    """No device named: the card. Pilotless 8PSK 2/3 short frames."""
    assert backend.default_device().type == "cuda"
    cfg = modcod.get_config(13, short=True)
    pkts = dvbs2_mod.random_ts_packets(400, seed=1)
    tx = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=11.0,
                       cfo=0.006 * np.pi, delay_samples=0.4, sco_ppm=10.0,
                       seed=2)
    B = 1 << 15
    kw = dict(mc=13, short=True, block_symbols=B, fec="pallas")
    rx = DVBS2Receiver(**kw)
    assert rx.device.type == "cuda"
    backend.reset_launches()
    got = rx.process_symbols_block(y[:2 * B])
    assert backend.LAUNCHES["ldpc_layered"] == 1      # no escalation
    assert backend.LAUNCHES["resample_farrow"] == 1
    ref = DVBS2Receiver(device="cpu", **kw).process_symbols_block(y[:2 * B])
    assert ref.frame_ok.all()
    for name in ("frame_ok", "ldpc_trials", "bch_corrections", "detected_pls",
                 "starts", "bbframes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    outs = []
    for d in (None, "cpu"):
        st = DVBS2Stream(device=d, **kw)
        outs.append(b"".join(st.feed(y[lo:lo + B])
                             for lo in range(0, len(y), B)))
    assert outs[0] == outs[1] and len(outs[0]) > 188 * 100


def test_dvbs_stream_and_first_bank_on_the_card(dev):
    """No device named: the card. A rate-3/4 carrier through DVBSStream
    (the locked chain runs kernel C once a block; --viterbi xla never),
    and two carriers through build_dvbs_bank."""
    ts = dvbs_mod.random_ts_groups(18, seed=71)
    tx = dvbs_mod.DVBSModulator(rate="3/4").ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=12.0,
                       cfo=0.004 * np.pi, phase=0.4, delay_samples=0.3,
                       sco_ppm=10.0, seed=72)
    B = 1 << 15
    outs, launches = [], []
    for d, impl in ((None, "auto"), ("cpu", "auto"), (None, "xla")):
        st = DVBSStream(block_symbols=B, viterbi_impl=impl, device=d)
        backend.reset_launches()
        outs.append(b"".join(st.feed(y[lo:lo + 3 * B])
                             for lo in range(0, len(y), 3 * B)))
        launches.append(dict(backend.LAUNCHES))
        assert st.rx.locked and st.rx.rate == "3/4"
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) > 188 * 50
    assert launches[0]["viterbi_acs"] >= 3
    assert launches[0]["resample_farrow"] >= 4
    assert launches[2]["viterbi_acs"] == 0
    n = 1 << 17
    x = np.stack([pack_cs4(y[:n]), pack_cs4(y[n:2 * n])])
    got = []
    for d in (None, "cpu"):
        step, _ = dvbs_bank.build_dvbs_bank(2, rate="3/4", block_samples=n,
                                            device=d)
        got.append({k: v.cpu().numpy() for k, v in
                    step(torch.from_numpy(x).to(dev if d is None else d))
                    .items() if k != "n_pairs"})
    assert (got[1]["ber"] < 0.02).all()
    for k in ("bits", "ber"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)


def _echo_block(B=1 << 15):
    """QPSK 1/2 short frames through the 2-ray echo of the JAX package's
    tests/test_equalizer.py (9 dB, seed 6): one block."""
    cfg = modcod.get_config(4, short=True)
    pkts = dvbs2_mod.random_ts_packets(120, seed=5)
    tx = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    echo = np.zeros(3, np.complex64)
    echo[0], echo[2] = 1.0, 0.18 - 0.1j
    y = channel.impair(np.convolve(x, echo)[:len(x)], snr_db=9.0,
                       cfo=0.004 * np.pi, seed=6)
    return y[:2 * B]


def test_equalizer_receiver_on_the_card(dev, monkeypatch):
    from dvbs_tpu_torch.ops import equalizer
    blk = _echo_block()
    kw = dict(mc=4, short=True, block_symbols=1 << 15, equalize=True,
              fec="pallas")
    seen, orig = [], equalizer.lms_equalize
    monkeypatch.setattr(equalizer, "lms_equalize",
                        lambda z: seen.append((z, orig(z))) or seen[-1][1])
    backend.reset_launches()
    got = DVBS2Receiver(**kw).process_symbols_block(blk)
    assert backend.LAUNCHES["resample_farrow"] == 1
    ref = DVBS2Receiver(device="cpu", **kw).process_symbols_block(blk)
    assert ref.frame_ok.all() and seen[0][0].device.type == dev.type
    for name in ("frame_ok", "ldpc_trials", "starts", "bbframes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                      err_msg=name)
    z, eq = seen[0]
    assert float((eq.cpu() - orig(z.cpu())).abs().max()) <= 1e-4


@pytest.fixture
def nccl_one(dev, tmp_path):
    """A process group of one NCCL rank on the card."""
    from dvbs_tpu_torch.parallel import collectives
    yield collectives.init_mesh(1, 0, dev, str(tmp_path / "store"))
    collectives.close_mesh()


def test_sharded_builds_at_world_one_on_the_card(nccl_one):
    """build_multi_carrier, build_carrier_bank_sharded and
    build_time_sharded at world size 1, no device named, equal to the
    unsharded programs on the card."""
    from dvbs_tpu_torch import entry
    from dvbs_tpu_torch.models.dvbs2 import run_fec
    from dvbs_tpu_torch.parallel import timeshard
    dev = nccl_one
    samples = entry.multi_carrier_signals(2, 2 * entry.BLOCK)
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=entry.BLOCK)
    step, _, mesh_ = mesh.build_multi_carrier(1, carriers_per_device=2)
    assert mesh_.device == dev and rx.device.type == dev.type
    backend.reset_launches()
    with torch.no_grad():
        out = step(samples)
        ref = rx.program(torch.from_numpy(samples).to(dev))
        fd = run_fec(rx.program, ref["llrs"].reshape(-1, 16200), 32, "xla")
    assert backend.LAUNCHES["resample_farrow"] == 2
    assert out["ldpc_ok"].all() and int(out["locked"][0]) == 4
    assert torch.equal(out["hard"].reshape(-1, 16200), fd["hard"])
    assert torch.equal(out["pls"], ref["pls"])

    x = np.stack([pack_cs4(samples[c, 0] + 1j * samples[c, 1])
                  for c in range(2)])
    bs = entry.BLOCK
    sharded, _, escalate = mesh.build_carrier_bank_sharded(
        1, carriers_per_device=2, mc=4, short=True, block_symbols=bs,
        ingest="cs4")
    bank, _, bank_esc = mesh.build_carrier_bank(
        2, mc=4, short=True, block_symbols=bs, fec="xla", ingest="cs4",
        stream_outputs=True)
    with torch.no_grad():
        a, b = sharded(x), bank(torch.from_numpy(x).to(dev))
        ea, eb = escalate(a["llrs"]), bank_esc(b["llrs"])
    for got, want in ((a, b), (ea, eb)):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k

    step, example, _, A = timeshard.build_time_sharded(1)
    shard = samples[:1, :, :A]
    with torch.no_grad():
        out = step(shard)
        window = torch.from_numpy(np.concatenate([shard[0]] * 3, axis=-1)
                                  [:, :2 * bs])[None].to(dev)
        ref = {k: v[0] for k, v in rx.program(window).items()}
        ref.pop("scatter")
        ref.update(run_fec(rx.program, ref.pop("llrs"), 32, "xla"))
    assert out.keys() == ref.keys()
    for k in ref:
        assert torch.equal(out[k][0], ref[k]), k
