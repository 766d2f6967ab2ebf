"""The single-carrier DVB-S2 slice of the port against dvbs_tpu, on the CPU.

Small size: short frames, block_symbols 2^15 (or 24576 for F = 3), 3-4
blocks. The same numpy inputs go through dvbs_tpu (its Pallas LDPC
kernel in interpret mode where `fec="pallas"`) and through
dvbs_tpu_torch with device="cpu" (the kernels' plain versions).
Tolerances, each with its reason:

- dd_phase_track: phase within 1e-3 rad (float32 sums in another order;
  decisions must agree for that to hold).
- robust estimators: 1e-5 relative to the estimate's scale.
- locate_frames_chain: starts equal, quality within 1e-5.
- decode_qc: hard bits, n_bad and trials equal (bf16 messages round
  alike; float32 sums in the same order).
- DVBS2Receiver per block: on the same float16-valued samples the
  symbol programs' int8 LLRs differ by at most 1 in at most 0.5% of the
  places (float32 rounding ahead of a round-to-int); hard bits, trials,
  BCH flags, frame_ok and BBFRAME bytes: exact.
- DVBS2Stream.feed, cli.main: TS bytes equal.
- probe stages: the plain versions against the TPU probes' arithmetic
  redone in numpy block by block: exact, `full` within 1e-5 relative
  (numpy rounds the polynomial's constants in float64).
"""
import functools
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu import cli as jcli  # noqa: E402
from dvbs_tpu.models.driver import DVBS2Stream as JaxStream  # noqa: E402
from dvbs_tpu.models.dvbs2 import DVBS2Receiver as JaxReceiver  # noqa: E402
from dvbs_tpu.ops import ldpc_pallas as jlp  # noqa: E402
from dvbs_tpu.ops import ldpc_qc as jqc  # noqa: E402
from dvbs_tpu.ops import plphase as jph  # noqa: E402
from dvbs_tpu.ops import plsync as jps  # noqa: E402
from dvbs_tpu.spec import ldpc_spec, modcod  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch import cli, profiling, tables  # noqa: E402
from dvbs_tpu_torch.io import source  # noqa: E402
from dvbs_tpu_torch.kernels import probe_resample as pr  # noqa: E402
from dvbs_tpu_torch.models.driver import DVBS2Stream  # noqa: E402
from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver  # noqa: E402
from dvbs_tpu_torch.ops import ldpc_kernel, ldpc_qc, plphase, plsync  # noqa: E402,E501

torch.set_num_threads(2)

BLOCK = 1 << 15


def _signal(mc, pilots, n_pkts, snr_db, seed, dummies=None, short=True):
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
    frames = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg)
    tx = frames.reshape(-1) if dummies is None else \
        dvbs2_mod.interleave_dummies(frames, every=dummies[0],
                                     n_dummies=dummies[1])
    y = channel.impair(channel.shape(tx, sps=2), snr_db=snr_db,
                       cfo=0.006 * np.pi, delay_samples=0.4, sco_ppm=10.0,
                       seed=seed + 1)
    return cfg, y, pkts.reshape(-1, 188)


def _contiguous(got: bytes, sent: np.ndarray) -> int:
    g = np.frombuffer(got, np.uint8).reshape(-1, 188)
    k0 = sent.tobytes().find(g[0].tobytes()) // 188
    assert np.array_equal(g, sent[k0:k0 + len(g)])
    return len(g)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,P", [("8psk", 5400), ("16apsk", 4050),
                                    ("32apsk", 3240)])
def test_dd_phase_track(kind, P):
    """Noisy symbols with a phase offset, a residual carrier and a slow
    phase wander: the port's track equals dvbs_tpu's within 1e-3 rad,
    in both passes' form (freq_refine on and off), and follows the
    truth."""
    cfg = modcod.get_config({"8psk": 13, "16apsk": 18, "32apsk": 24}[kind],
                            short=True)
    pts, _ = tables.demap_tables(kind, cfg.g1, cfg.g2)
    rng = np.random.default_rng(len(kind))
    F = 3
    sym = pts[rng.integers(0, len(pts), (F, P))]
    n = np.arange(P)
    theta0 = np.array([0.3, -1.1, 2.0], np.float32)
    freq = np.array([4e-4, -6e-4, 1e-4])
    truth = theta0[:, None] + freq[:, None] * n + \
        0.1 * np.sin(2 * np.pi * n / 2500.0)[None, :]
    noise = 0.05 * (rng.normal(size=(F, P)) + 1j * rng.normal(size=(F, P)))
    payload = ((sym + noise) * np.exp(1j * truth)).astype(np.complex64)
    for refine in (True, False):
        want = np.asarray(jph.dd_phase_track(
            jnp.asarray(payload), jnp.asarray(theta0), kind, cfg.g1, cfg.g2,
            freq_refine=refine))
        got = plphase.dd_phase_track(
            torch.from_numpy(payload), torch.from_numpy(theta0),
            torch.from_numpy(pts), freq_refine=refine).numpy()
        assert got.shape == want.shape == (F, P)
        assert np.abs(got - want).max() <= 1e-3, (kind, refine)
    assert np.abs(got - truth).max() < 0.25
    # leading batch dimensions: [C, F, P] tracks each row as [F, P] does
    got3 = plphase.dd_phase_track(
        torch.from_numpy(payload)[None], torch.from_numpy(theta0)[None],
        torch.from_numpy(pts), freq_refine=False)
    assert torch.equal(got3[0], torch.from_numpy(got))


def test_dd_median_is_the_mean_of_the_middle_two():
    """An even number of group steps: jnp.median averages the two middle
    values, and so must the port (torch.median would take the lower)."""
    pts, _ = tables.demap_tables("8psk", None, None)
    rng = np.random.default_rng(5)
    P = 60 * 5                                # 5 groups: 4 steps
    sym = pts[rng.integers(0, 8, (1, P))]
    ph = np.concatenate([np.full(60, v) for v in (0.0, 0.02, 0.1, 0.13, 0.3)])
    payload = (sym * np.exp(1j * ph)[None]).astype(np.complex64)
    z = np.zeros(1, np.float32)
    want = np.asarray(jph.dd_phase_track(jnp.asarray(payload),
                                         jnp.asarray(z), "8psk"))
    got = plphase.dd_phase_track(torch.from_numpy(payload),
                                 torch.from_numpy(z),
                                 torch.from_numpy(pts)).numpy()
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("pilots", [False, True])
def test_robust_frequency_estimators(pilots):
    """Frames whose header is a dummy's (PLS 0) are gated by their
    coherence; a block with no coherent frame estimates 0. Port equals
    dvbs_tpu within 1e-5."""
    cfg = modcod.get_config(13, short=True, pilots=pilots)
    L = cfg.plframe_len
    pk = dvbs2_mod.random_ts_packets(120, seed=3)
    frames = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pk, cfg), cfg)[:5].copy()
    dummy = dvbs2_mod.dummy_plframe()
    frames[1, :len(dummy)] = dummy            # a dummy in slot 1
    frames[3, :len(dummy)] = dummy
    rng = np.random.default_rng(4)
    f0 = 2.5e-3
    rot = np.exp(1j * (f0 * np.arange(L) + 0.7))
    x = (frames * rot + 0.08 * (rng.normal(size=frames.shape) + 1j *
                                rng.normal(size=frames.shape))
         ).astype(np.complex64)
    hdr = torch.from_numpy(tables.header_syms(cfg.pls_code))
    pil = None
    if pilots:
        pil = ([int(p) for p in tables.pilot_starts(cfg)],
               torch.from_numpy(tables.pilot_descramble_phasors(cfg)))
    for xs in (x, x[[1, 3]]):                 # mixed; dummies only
        xt = torch.from_numpy(xs)
        for robust in (True, False):
            want = float(jph.coarse_fed_common(jnp.asarray(xs), cfg,
                                               robust=robust))
            got = float(plphase.coarse_fed_common(xt, hdr, pil,
                                                  robust=robust))
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want) / f0)
            want = float(jph.lr_freq_common(jnp.asarray(xs), cfg,
                                            robust=robust))
            got = float(plphase.lr_freq_common(xt, hdr, pil, robust=robust))
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want) / f0)
    assert abs(float(plphase.lr_freq_common(plphase.apply_freq(
        torch.from_numpy(x), torch.full((5,), f0)), hdr, pil, robust=True))
        ) < 6e-4
    # no coherent frame at all (noise): the gated estimates are 0
    only = torch.from_numpy((rng.normal(size=(2, L)) + 1j * rng.normal(
        size=(2, L))).astype(np.complex64))
    assert float(plphase.coarse_fed_common(only, hdr, pil, robust=True)) == 0
    assert float(plphase.lr_freq_common(only, hdr, pil, robust=True)) == 0
    # carriers are gated apart: [C, F, L]
    both = torch.stack([torch.from_numpy(x), torch.from_numpy(x)])
    got2 = plphase.lr_freq_common(both, hdr, pil, robust=True)
    assert got2.shape == (2,) and float(got2[0]) == float(got2[1])


def test_locate_frames_chain():
    """Peaks on a grid with dummies between data frames, one weak peak
    (best-candidate fallback) and equal neighbours (first-index ties):
    starts equal dvbs_tpu's, quality within 1e-5."""
    L, F, D = 5490, 6, plsync.DUMMY_LEN
    rng = np.random.default_rng(6)
    rows, wants = [], []
    for c in range(2):
        n = 8 * L
        score = (0.25 * rng.random(n)).astype(np.float32)
        pos = [300 + 17 * c]
        for pitch in (L, D, L + 2, L + D, D - 1, L, L):
            pos.append(pos[-1] + pitch)
        for k, p in enumerate(pos):
            score[p] = 0.5 if k == 3 else 0.9        # k == 3: below 0.6
        score[pos[2] + 1] = score[pos[2]]             # a tie: first wins
        rows.append(score)
        s, q = jps.locate_frames_chain(jnp.asarray(score), L, F, margin=256)
        wants.append((np.asarray(s), np.asarray(q)))
        assert list(wants[-1][0][:3]) == pos[:3]
    gs, gq = plsync.locate_frames_chain(torch.from_numpy(np.stack(rows)), L,
                                        F, margin=256)
    assert gs.dtype == torch.int32 and gs.shape == (2, F)
    for c in range(2):
        np.testing.assert_array_equal(gs[c].numpy(), wants[c][0])
        assert np.abs(gq[c].numpy() - wants[c][1]).max() <= 1e-5


@pytest.mark.parametrize("table,rate,ebno,n_iters", [
    ("C4", 4 / 9, 4.1, 10), ("C7", 11 / 15, 3.7, 12)])
def test_decode_qc(table, rate, ebno, n_iters):
    """Noisy codewords near the decoder's threshold, so that trials
    spread, and one frame of noise that stays open: everything equal."""
    code = ldpc_spec.get_code(table)
    rng = np.random.default_rng(7)
    B = 5
    cw = code.encode(rng.integers(0, 2, (B, code.K)).astype(np.uint8))
    sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebno / 10)))
    y = 1.0 - 2.0 * cw + rng.normal(0, sigma, cw.shape)
    y[4] = rng.normal(0, 1.0, code.N)                  # never converges
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    want = [np.asarray(v) for v in jqc.decode_qc(
        jnp.asarray(llr), table, n_iters=n_iters)]
    got = [v.numpy() for v in ldpc_qc.decode_qc(
        torch.from_numpy(llr), table, n_iters=n_iters)]
    for name, g, w in zip(("hard", "n_bad", "trials"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    ok = got[1] == 0
    assert ok[:4].sum() >= 2 and (got[0][ok] == cw[ok]).all()
    assert got[2].min() < n_iters and got[2][4] == n_iters and not ok[4]
    no_track = ldpc_qc.decode_qc(torch.from_numpy(llr), table,
                                 n_iters=n_iters, track_trials=False)
    assert torch.equal(no_track[0], torch.from_numpy(got[0]))
    assert (no_track[2] == n_iters).all()


def test_kernel_a_at_three_frames_equals_the_padded_call():
    """dvbs_tpu pads F = 3 frames cyclically to its kernel's 128 lanes;
    the port decodes the 3 frames as they are. hard, n_bad and trials of
    the 3 frames are the same, early exit included."""
    table, rate, ebno = "C4", 4 / 9, 2.6
    code = ldpc_spec.get_code(table)
    rng = np.random.default_rng(8)
    cw = code.encode(rng.integers(0, 2, (3, code.K)).astype(np.uint8))
    sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebno / 10)))
    y = 1.0 - 2.0 * cw + rng.normal(0, sigma, cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    q = jlp.quantize_llrs(jnp.asarray(llr))
    qt = ldpc_kernel.quantize_llrs(torch.from_numpy(llr))
    np.testing.assert_array_equal(np.asarray(q), qt.numpy())
    padded = jnp.tile(q, (-(-jlp.B // 3), 1))[:jlp.B]
    want = [np.asarray(v)[:3] for v in jlp.decode_qc_pallas(
        padded, table, n_iters=10, interpret=True)]
    got = [v.numpy() for v in ldpc_kernel.decode_calls(qt, table, 10)]
    for name, g, w in zip(("hard", "n_bad", "trials"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[1] == 0).all() and len(set(got[2].tolist())) >= 1


# ---------------------------------------------------------------------------
# the block receiver
# ---------------------------------------------------------------------------

RX_CASES = [
    # mc, pilots, snr, block, fec, dummy_aware
    (4, False, 7.0, BLOCK, "xla", False),         # QPSK 1/2, F = 2
    (13, False, 11.0, 24576, "pallas", False),    # 8PSK 2/3 pilotless, F = 3
    (18, False, 14.0, BLOCK, "xla", False),       # 16APSK 2/3 pilotless
    (24, False, 18.0, BLOCK, "xla", True),        # 32APSK 3/4, chained grid
    (13, True, 10.0, BLOCK, "xla", True),         # pilots + robust
]


@pytest.mark.parametrize("mc,pilots,snr,block,fec,dummy_aware", RX_CASES)
def test_receiver_block(mc, pilots, snr, block, fec, dummy_aware):
    cfg, y, _ = _signal(mc, pilots, 400, snr, seed=11)
    blk = y[:2 * block]
    kw = dict(mc=mc, short=True, pilots=pilots, block_symbols=block, fec=fec,
              dummy_aware=dummy_aware)
    jrx = JaxReceiver(interpret_pallas=True, **kw)
    rx = DVBS2Receiver(device="cpu", **kw)
    assert (rx.n_frames, rx.pass1_iters) == (jrx.n_frames, jrx.pass1_iters)
    if fec == "pallas":
        assert rx.n_frames == 3
    # the symbol program on the same float16-valued samples
    scale = np.sqrt(np.mean(np.abs(blk) ** 2))
    ri = np.stack([(blk / scale).real, (blk / scale).imag]).astype(np.float16)
    jout = {k: np.asarray(v) for k, v in jrx._sym_fn(jnp.asarray(ri)).items()}
    with torch.no_grad():
        out = {k: v[0].numpy() for k, v in rx.program(
            torch.from_numpy(ri.astype(np.float32))[None]).items()}
    np.testing.assert_array_equal(out["starts"], jout["starts"])
    np.testing.assert_array_equal(out["pls"], jout["pls"])
    assert (jout["pls"] == cfg.pls_code).all()
    assert np.abs(out["quality"] - jout["quality"]).max() <= 1e-3
    assert np.abs(out["freq"] - jout["freq"]).max() <= 1e-5
    assert np.abs(out["scatter"] - jout["scatter"]).max() <= 5e-3
    qj = np.asarray(jlp.quantize_llrs(jnp.asarray(jout["llrs"]))).astype(int)
    qt = ldpc_kernel.quantize_llrs(torch.from_numpy(out["llrs"])).numpy()
    d = np.abs(qj - qt)
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3, (d.max(), (d > 0).mean())
    # the whole block through both receivers
    want, got = jrx.process_symbols_block(blk), rx.process_symbols_block(blk)
    assert want.frame_ok.all()
    for name in ("frame_ok", "ldpc_trials", "bch_corrections", "detected_pls",
                 "starts", "bbframes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.n_symbols == want.n_symbols
    assert got.last_frame_end == want.last_frame_end
    assert abs(got.coarse_cfo - want.coarse_cfo) <= 1e-5
    # dvbs_tpu carries the samples as float16, the port as float32
    assert np.abs(got.sync_quality - want.sync_quality).max() <= 2e-3
    assert np.abs(got.detected_pls_conf - want.detected_pls_conf).max() <= 2e-3
    assert got.constellation.shape == want.constellation.shape == (2048,)


def test_receiver_escalates_and_repairs():
    """A block at the decoder's cliff, accepted by a low sync threshold:
    pass 1 (10 sweeps) leaves a frame open, the full budget reruns the
    block and its results are merged in for that frame alone (10 + 24
    trials), and the BCH-inconsistent frame is rejected on the host.
    Same verdicts and bytes as dvbs_tpu, and the same trials for the
    escalated frame; dvbs_tpu carries the samples as float16 and the
    port as float32, so at the cliff the other frame's sweep count may
    move by one."""
    cfg, y, _ = _signal(4, False, 200, -0.5, seed=13)
    blk = y[:2 * BLOCK]
    kw = dict(mc=4, short=True, block_symbols=BLOCK, fec="xla",
              max_ldpc_trials=24, sof_threshold=0.2)
    want = JaxReceiver(**kw).process_symbols_block(blk)
    rx = DVBS2Receiver(device="cpu", **kw)
    got = rx.process_symbols_block(blk)
    assert rx._two_pass and want.ldpc_trials.max() == 34    # it escalated
    assert want.ldpc_trials.min() <= 10 and want.frame_ok.any()
    for name in ("frame_ok", "bch_corrections", "bbframes"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    esc = want.ldpc_trials == 34
    np.testing.assert_array_equal(got.ldpc_trials[esc], want.ldpc_trials[esc])
    assert np.abs(got.ldpc_trials - want.ldpc_trials).max() <= 1


def test_receiver_arguments():
    with pytest.raises(ValueError):
        DVBS2Receiver(fec="int8", device="cpu")
    eq = DVBS2Receiver(equalize=True, device="cpu")
    assert eq.program.equalize and not DVBS2Receiver(
        device="cpu").program.equalize
    with pytest.raises(ValueError):
        DVBS2Receiver(short=False, block_symbols=1 << 15, device="cpu")
    rx = DVBS2Receiver(mc=4, short=True, max_ldpc_trials=8, device="cpu")
    assert rx.pass1_iters == 8 and not rx._two_pass


# ---------------------------------------------------------------------------
# the stream and the CLI
# ---------------------------------------------------------------------------

def _feed_all(st, y, chunk=BLOCK):
    out = bytearray()
    for lo in range(0, len(y), chunk):
        out.extend(st.feed(y[lo:lo + chunk]))
    return bytes(out)


STREAM_CASES = {
    "8psk_pilotless": dict(mc=13, pilots=False, snr=11.0, n_pkts=520,
                           kw=dict()),
    "qpsk_dummies": dict(mc=4, pilots=False, snr=7.0, n_pkts=200,
                         dummies=(3, 1), kw=dict(dummy_aware=True)),
    "auto_modcod": dict(mc=13, pilots=True, snr=10.0, n_pkts=420,
                        kw=dict(auto_modcod=True), start=(4, False)),
}


def _seed_vote(st, name, cfg):
    """auto_modcod: 44 earlier frames already voted for the signal's
    PLS code, so the stream's own detections tip the 45-of-50 vote in
    its first blocks (a cold vote takes ~25 blocks at this size)."""
    if name == "auto_modcod":
        st._vote.extend([cfg.pls_code] * 44)


STATE_CUT = 3 * BLOCK + 1234      # samples fed before the checkpoint


@functools.lru_cache(maxsize=None)
def _stream_case(name):
    """(name, case, cfg, samples, packets sent, dvbs_tpu's TS bytes and
    stream). The stream is fed in two parts, and its state and output at
    STATE_CUT are kept on it (`mid_state`, `head`) for the round trip."""
    case = STREAM_CASES[name]
    cfg, y, sent = _signal(case["mc"], case["pilots"], case["n_pkts"],
                           case["snr"], seed=21,
                           dummies=case.get("dummies"))
    mc0, pil0 = case.get("start", (case["mc"], case["pilots"]))
    st = JaxStream(mc=mc0, short=True, pilots=pil0, block_symbols=BLOCK,
                   **case["kw"])
    _seed_vote(st, name, cfg)
    st.head = _feed_all(st, y[:STATE_CUT])
    st.mid_state = st.get_state()
    ts = st.head + _feed_all(st, y[STATE_CUT:])
    assert st.cfg.pls_code == cfg.pls_code
    return name, case, cfg, y, sent, ts, st


@pytest.fixture(params=sorted(STREAM_CASES))
def stream_case(request):
    return _stream_case(request.param)


def test_stream_same_ts(stream_case):
    name, case, cfg, y, sent, want, jst = stream_case
    mc0, pil0 = case.get("start", (case["mc"], case["pilots"]))
    switched = []
    st = DVBS2Stream(mc=mc0, short=True, pilots=pil0, block_symbols=BLOCK,
                     device="cpu", **case["kw"])
    st.on_modcod_switch = switched.append
    _seed_vote(st, name, cfg)
    got = _feed_all(st, y)
    assert got == want
    assert st.cfg.pls_code == cfg.pls_code
    assert st.stats.blocks >= 3 and st.stats.blocks == jst.stats.blocks
    assert st.stats.frames_ok > 0
    assert st.metrics.frames_ok == jst.metrics.frames_ok
    assert st.metrics.frames_seen == jst.metrics.frames_seen
    if name == "auto_modcod":
        assert [c.pls_code for c in switched] == [cfg.pls_code]
        g = np.frombuffer(got, np.uint8).reshape(-1, 188)
        assert len(g) > 50
    else:
        # one contiguous run: nothing lost at a block seam or a dummy
        assert _contiguous(got, sent) >= 0.6 * len(sent)
        assert st.metrics.detected_modcod == case["mc"]
    assert "stage dispatch" in st.stats.report()


def test_stream_state_round_trip():
    """get_state mid-stream, set_state into a new stream (of another
    MODCOD: the state names its own), and the joined TS is the
    uninterrupted one; dvbs_tpu's checkpoint resumes in the port too."""
    name, case, cfg, y, sent, want, jst = _stream_case("8psk_pilotless")
    kw = dict(short=True, block_symbols=BLOCK, device="cpu", **case["kw"])
    cut = STATE_CUT
    st = DVBS2Stream(mc=case["mc"], pilots=case["pilots"], **kw)
    head = _feed_all(st, y[:cut])
    blob = st.get_state()
    assert blob["pls_code"] == cfg.pls_code
    st2 = DVBS2Stream(mc=4, pilots=False, **kw)
    st2.set_state(blob)
    assert head + _feed_all(st2, y[cut:]) == want
    st3 = DVBS2Stream(mc=case["mc"], pilots=case["pilots"], **kw)
    st3.set_state(jst.mid_state)
    assert jst.head + _feed_all(st3, y[cut:]) == want


def test_stream_set_params():
    """set_params rebuilds the receiver, keeps the buffered samples and
    drops the vote."""
    st = DVBS2Stream(mc=4, short=True, block_symbols=BLOCK, device="cpu")
    st._vote.extend([5] * 10)
    st.feed(np.zeros(1000, np.complex64))
    st.set_params(mc=13, pilots=True)
    assert (st.cfg.modcod, st.cfg.pilots, st.cfg.framesize) == \
        (13, True, "short")
    assert st.rx.cfg.pls_code == st.cfg.pls_code
    assert len(st._fifo) == 1000 and len(st._vote) == 0


def test_cli_same_output(tmp_path):
    """`--mode s2` on one cf32 file: the port's CLI writes the bytes
    dvbs_tpu's CLI writes, with a state file saved mid-way and resumed,
    and through --config."""
    name, case, cfg, y, sent, want, _ = _stream_case("8psk_pilotless")
    iq = str(tmp_path / "cap.cf32")
    source.write_iq_file(iq, y)
    args = ["--iq", iq, "--mode", "s2", "--modcod", "13", "--framesize",
            "short", "--block-symbols", str(BLOCK)]
    assert jcli.main(args + ["--out", str(tmp_path / "j.ts")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "t.ts"),
                            "--device", "cpu"]) == 0
    ts = (tmp_path / "t.ts").read_bytes()
    assert ts == (tmp_path / "j.ts").read_bytes() and len(ts) > 0
    assert _contiguous(ts, sent) >= 0.6 * len(sent)
    # two runs joined by a state file: the first half, then the rest
    half = (len(y) // 2) // (4 * BLOCK) * (4 * BLOCK)
    source.write_iq_file(str(tmp_path / "a.cf32"), y[:half])
    source.write_iq_file(str(tmp_path / "b.cf32"), y[half:])
    state = str(tmp_path / "rx.state")
    common = ["--mode", "s2", "--modcod", "13", "--framesize", "short",
              "--block-symbols", str(BLOCK), "--fec", "pallas",
              "--state-file", state, "--device", "cpu"]
    assert cli.main(["--iq", str(tmp_path / "a.cf32"), "--out",
                     str(tmp_path / "a.ts")] + common) == 0
    assert os.path.exists(state)
    assert cli.main(["--iq", str(tmp_path / "b.cf32"), "--out",
                     str(tmp_path / "b.ts")] + common) == 0
    joined = (tmp_path / "a.ts").read_bytes() + (tmp_path / "b.ts").read_bytes()
    assert _contiguous(joined, sent) >= 0.6 * len(sent)
    # the MODCOD from a config file
    cfgfile = tmp_path / "rx.json"
    cfgfile.write_text('{"dvbs2_constellation": "8psk", "dvbs2_coderate": '
                       '"2/3", "dvbs2_framesize": "short"}')
    assert cli.main(["--iq", iq, "--config", str(cfgfile), "--block-symbols",
                     str(BLOCK), "--out", str(tmp_path / "c.ts"),
                     "--device", "cpu"]) == 0
    assert (tmp_path / "c.ts").read_bytes() == ts


def test_cli_routes(tmp_path, capsys):
    """Single-carrier --mode s runs the auto-locking DVBSStream (on noise:
    no output); --carrier needs the rates; two carriers of one
    capture run the fused DVB-S2 bank, the fused DVB-S bank with --rate
    and one DVBSStream per carrier without it."""
    iq = str(tmp_path / "z.cf32")
    rng = np.random.default_rng(3)
    wide = (rng.normal(size=60000) + 1j * rng.normal(size=60000)).astype(
        np.complex64)
    source.write_iq_file(iq, wide[:8192])
    assert cli.main(["--iq", iq, "--mode", "s", "--block-symbols", "2048",
                     "--device", "cpu"]) == 0
    assert "out=0B vit_sig=" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--iq", iq, "--carrier", "1e5:1e5", "--device", "cpu"])
    source.write_iq_file(iq, wide)
    rates = ["--samplerate", "4e6", "--symbolrate", "1e6", "--offset=-1e6",
             "--carrier", "1e6:1e6", "--device", "cpu"]
    assert cli.main(["--iq", iq, "--mode", "s2", "--modcod", "4",
                     "--framesize", "short", "--block-symbols", "16384",
                     "--fec", "pallas", "--out", str(tmp_path / "o.ts")]
                    + rates) == 0
    assert "bank ok=" in capsys.readouterr().err
    assert cli.main(["--iq", iq, "--mode", "s", "--rate", "1/2",
                     "--block-symbols", "8192"] + rates) == 0
    assert "dvbs bank lock=" in capsys.readouterr().err
    assert cli.main(["--iq", iq, "--mode", "s", "--block-symbols", "8192"]
                    + rates) == 0
    assert "  [c1] out+=0B" in capsys.readouterr().err


def test_device_trace(tmp_path):
    """device_trace writes a Chrome trace with the program's layer
    ranges in it."""
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=BLOCK, device="cpu")
    path = tmp_path / "trace.json"
    with profiling.device_trace(str(path)) as prof:
        rx.process_symbols_block(np.ones(2 * BLOCK, np.complex64))
    text = path.read_text()
    for name in ("frontend", "timing", "plsync", "phase", "demap", "ldpc"):
        assert f'"{name}"' in text
    assert len(prof.key_averages()) > 0


# ---------------------------------------------------------------------------
# the probes' plain versions against the TPU probes' arithmetic in numpy
# ---------------------------------------------------------------------------

def _rows_of(a, TC, WE, TS=256):
    """bisect_resample_kernel.rows_of: [TC, WE] windows by concatenating
    rows m, m+1, ... of the chunk a [TC+4, TS]."""
    chunks, covered, m = [], 0, 0
    while covered < WE:
        cc = min(TS, WE - covered)
        chunks.append(a[m:m + TC, 0:cc])
        covered += cc
        m += 1
    return np.concatenate(chunks, axis=1)


def _tpu_probe_numpy(inp):
    """What the TPU probe of inp["stage"] computes, block by block as its
    kernel does (masked barrel and all), in numpy."""
    g = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in inp.items()}
    stage, C, ntp, TC = g["stage"], g["C"], g["ntp"], g["TC"]
    TS, extra, sb = 256, 4, g["shift_bits"]
    a, b, u, rb = g["a"], g.get("b"), g.get("u"), g.get("rb")
    out = np.zeros((C, ntp, TS), np.float32)
    for c in range(C):
        for k in range(ntp // TC):
            sl = slice(k * TC, (k + 1) * TC)
            if stage == "v0":
                out[c, sl] = a[c, sl] * np.float32(2.0)
                continue
            if stage in ("v5", "v6", "v7", "v8"):
                blk = a[c, k]
            else:
                blk = a[c, k * TC:k * TC + TC + extra]
                blk2 = None if b is None else b[c, k * TC:k * TC + TC + extra]
            if stage in ("v1", "v3", "v4", "v5"):
                out[c, sl] = blk[:TC] * np.float32(2.0)
            elif stage in ("v2", "dma"):
                out[c, sl] = blk[:TC] + blk2[:TC]
            elif stage == "v6":
                out[c, sl] = _rows_of(blk, TC, TS + 260)[:, :TS] * \
                    np.float32(2.0)
            elif stage == "v7":
                out[c, sl] = blk[:TC] + rb[c, sl, None].astype(np.float32)
            elif stage == "v8":
                r = _rows_of(blk, TC, TS + 260)
                hv = rb[c, sl, None] >> 1
                w = TS + 260
                for bit in reversed(range(8)):
                    step = 1 << bit
                    w -= step
                    r = np.where(((hv >> bit) & 1) != 0, r[:, step:step + w],
                                 r[:, :w])
                out[c, sl] = r[:, :TS]
            else:
                bias = 1 << (sb - 1)
                WE = TS + bias + 6
                re_, ro_ = _rows_of(blk, TC, WE), _rows_of(blk2, TC, WE)
                if stage == "rows":
                    out[c, sl] = re_[:, :TS] + ro_[:, :TS]
                    continue
                rbv = rb[c, sl, None]
                hv, odd = rbv >> 1, (rbv & 1) != 0
                if stage == "rb":
                    out[c, sl] = re_[:, :TS] + ro_[:, :TS] + \
                        hv.astype(np.float32)
                    continue
                w = WE
                for bit in reversed(range(sb - 1)):
                    step = 1 << bit
                    w -= step
                    sel = ((hv >> bit) & 1) != 0
                    re_ = np.where(sel, re_[:, step:step + w], re_[:, :w])
                    ro_ = np.where(sel, ro_[:, step:step + w], ro_[:, :w])
                if stage == "barrel":
                    out[c, sl] = re_[:, :TS] + ro_[:, :TS]
                    continue
                e_pre = np.where(odd, ro_[:, :w - 1], re_[:, :w - 1])
                o_pre = np.where(odd, re_[:, 1:w], ro_[:, :w - 1])
                if stage == "swap":
                    out[c, sl] = e_pre[:, :TS] + o_pre[:, :TS]
                    continue
                uu = u[c, sl]
                acc = np.zeros((TC, TS), np.float32)
                for ci in range(10):
                    tap = np.full((TC, TS), 0.1, np.float32)
                    for dg in range(1, 10):
                        tap = tap * uu + np.float32(0.01 * dg)
                    p = e_pre if ci % 2 == 0 else o_pre
                    acc = acc + tap * p[:, ci // 2:ci // 2 + TS]
                out[c, sl] = acc
    return out


@pytest.mark.parametrize("stage", list(pr.STAGES))
def test_probe_stage_plain(stage):
    inp = pr.make_inputs(stage, "cpu")
    assert (inp["ntp"], inp["TC"], inp["shift_bits"]) == (32, 8, 9)
    got = pr.run_stage(inp).numpy()
    want = _tpu_probe_numpy(inp)
    assert got.shape == want.shape and got.dtype == np.float32
    if stage == "full":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)
    # another geometry: 3 carriers, 2 chunks of 4 tiles
    inp = pr.make_inputs(stage, "cpu", C=3, nck=2, TC=4, seed=1)
    np.testing.assert_allclose(pr.run_stage(inp).numpy(),
                               _tpu_probe_numpy(inp), rtol=1e-5, atol=1e-5)


def test_probe_split_plain():
    """split: the prep pass makes split_resample_pallas.py's parity
    planes, and the kernel pass on them equals kernel B's plain version
    exactly, for shifts of both parities across the whole range."""
    from dvbs_tpu_torch.ops import resample_kernel as rk
    sp = pr.make_split_inputs("cpu", C=2, S=3000)
    nt, bias = sp["rb"].shape[1], sp["bias"]
    rng = np.random.default_rng(9)
    sp["rb"] = torch.from_numpy(rng.integers(0, 2 * bias, (2, nt))
                                .astype(np.int32))
    planes = pr.split_prep(sp["y2"], nt, bias)
    y = sp["y2"].numpy()
    ypp = np.pad(y, ((0, 0), (bias + 4, 2 * pr.plane_width(nt, bias))))
    Wp = pr.plane_width(nt, bias)
    for p, want in zip(planes, (ypp[:, 0::2].real, ypp[:, 1::2].real,
                                ypp[:, 0::2].imag, ypp[:, 1::2].imag)):
        np.testing.assert_array_equal(p.numpy(), want[:, :Wp])
    got = pr.split_kernel(planes, sp["u"], sp["rb"], sp["coef"], sp["S"])
    ref = rk.resample_plain(sp["y2"], sp["u"], sp["rb"], bias, sp["coef"],
                            sp["S"])
    assert torch.equal(got, ref)
