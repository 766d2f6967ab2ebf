"""The port's DVB-S streaming bank against dvbs_tpu's, on the CPU.

Two carriers of DVB-S (K=7 convolutional code, rates 1/2 and 3/4), 16k
symbols per block, as tests/test_dvbs_bank_stream.py. Both packages get
the same numpy inputs, made from a seed. dvbs_tpu on the CPU decodes
with its XLA Viterbi decoder (select_decoder("auto")) and the port with
kernel C's plain version; the two agree on segment cores, which is all
the bank emits, so bank outputs are compared on cores, TS bytes and
hints, never on wing bits.

Tolerances and why (those of tests/test_torch_frontend.py where the
stage is the same):
- exact: stream_bank_geometry, emitted bits, the lock decision (rate,
  rotation, drop, BER), the host tail's bytes, and every TS byte the
  streams emit (decoded bits of clean signals);
- mix: max error <= FLOAT_TOL of the largest magnitude (float32 with
  sin/cos from two libraries); its argument freq*n + phase is rounded
  in float32 the same way on both sides;
- the residual frequency f4: <= 1e-5 rad/symbol (an FFT of 16k points in
  two libraries, parabolic refinement between bins);
- front-end soft values: RMS error <= BF16_RMS_TOL of the reference's
  RMS (bf16-rounded matmul inputs, as the matched filter's test);
- hints: cfo and NCO phase <= 1e-6, tau <= 1e-3 (as timing recovery's
  test), theta <= 1e-3 rad (f4's error times the 8k-symbol advance);
  re-encode BER exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.models.dvbs import DVBSReceiver as JaxReceiver  # noqa: E402
from dvbs_tpu.ops import frontend as jf  # noqa: E402
from dvbs_tpu.parallel import dvbs_bank as jb  # noqa: E402
from dvbs_tpu.spec import dvbs_fec, rs_spec, scrambling  # noqa: E402
from dvbs_tpu.tx import channel, dvbs_mod  # noqa: E402
from dvbs_tpu_torch.models.dvbs import DVBSReceiver  # noqa: E402
from dvbs_tpu_torch.ops import frontend as tf  # noqa: E402
from dvbs_tpu_torch.parallel import dvbs_bank as tb  # noqa: E402
from test_torch_frontend import BF16_RMS_TOL, FLOAT_TOL  # noqa: E402

torch.set_num_threads(2)

C = 2
BLOCK = 1 << 15            # samples per carrier per block (16k symbols)


def _carrier(seed, n_groups, rate="1/2", cfo=0.01, delay=0.3, snr=12.0,
             sco_ppm=12.0):
    ts = dvbs_mod.random_ts_groups(n_groups, seed=seed)
    tx = dvbs_mod.DVBSModulator(rate=rate).ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=snr, cfo=cfo,
                       delay_samples=delay, sco_ppm=sco_ppm, seed=seed + 1)
    return y, ts.reshape(-1, 188)


@pytest.fixture(scope="module")
def half():
    """Two rate-1/2 carriers, 14 blocks long."""
    y0, s0 = _carrier(11, 18, cfo=0.012, delay=0.2)
    y1, s1 = _carrier(12, 18, cfo=-0.02, delay=0.7)
    n = min(len(y0), len(y1)) // BLOCK * BLOCK
    return [y0[:n], y1[:n]], [s0, s1]


def _max_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _rms_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.sqrt(np.mean(np.abs(got - ref) ** 2) /
                   np.mean(np.abs(ref) ** 2))


def _ri(y):
    """complex [C, n] -> rms-normalized float32 re/im [C, 2, n]."""
    y = np.atleast_2d(y)
    rms = np.sqrt(np.mean(np.abs(y) ** 2, axis=1, keepdims=True))
    yn = y / rms
    return np.stack([yn.real, yn.imag], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# front-end pieces
# ---------------------------------------------------------------------------

def test_mix_with_phase():
    rng = np.random.default_rng(0)
    n = 1 << 19                      # the bank's block: n up to 524,287
    x = (rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
         ).astype(np.complex64)
    freq = np.asarray([0.0123, -0.0371], np.float32)
    phase = np.asarray([1.25, 5.9], np.float32)
    got = tf.mix(torch.from_numpy(x), torch.from_numpy(freq),
                 torch.from_numpy(phase)).numpy()
    ref = np.asarray(jax.vmap(jf.mix)(jnp.asarray(x), jnp.asarray(freq),
                                      jnp.asarray(phase)))
    assert _max_rel(got, ref) <= FLOAT_TOL


def test_qpsk_residual_freq():
    rng = np.random.default_rng(1)
    S = 1 << 14
    sym = ((2 * rng.integers(0, 2, (C, S)) - 1) +
           1j * (2 * rng.integers(0, 2, (C, S)) - 1)) / np.sqrt(2)
    f = np.asarray([0.0031, -0.0112])
    k = np.arange(S)
    z = (sym * np.exp(1j * (f[:, None] * k + 0.4)) +
         0.2 * (rng.normal(size=(C, S)) + 1j * rng.normal(size=(C, S)))
         ).astype(np.complex64)
    got = tf.qpsk_residual_freq(torch.from_numpy(z)).numpy()
    ref = np.asarray(jax.vmap(jf.qpsk_residual_freq)(jnp.asarray(z)))
    assert got.dtype == np.float32 and got.shape == (C,)
    assert np.max(np.abs(got - ref)) <= 1e-5
    assert np.max(np.abs(got - f)) <= 1e-4


@pytest.fixture(scope="module")
def front():
    geom = tb.stream_bank_geometry("1/2", BLOCK)
    return tb.DVBSFront(geom["u_soft"], torch.device("cpu")), geom


def test_front_first(half, front):
    ri = _ri(np.stack([y[:BLOCK] for y in half[0]]))
    got = tb._front_first(front[0], torch.from_numpy(ri)).numpy()
    ref = np.asarray(jax.vmap(jb._front_first)(jnp.asarray(ri)))
    assert got.shape == ref.shape == (C, BLOCK)
    assert _rms_rel(got, ref) <= BF16_RMS_TOL


def _check_hints(got, ref):
    assert np.max(np.abs(got[:, [0, 1, 4, 5]] - ref[:, [0, 1, 4, 5]])) <= 1e-6
    assert np.max(np.abs(got[:, 2] - ref[:, 2])) <= 1e-3
    assert np.max(np.abs(got[:, 3] - ref[:, 3])) <= 1e-3


@pytest.mark.parametrize("carried", [False, True], ids=["first", "carried"])
def test_front_hinted(half, front, carried):
    fr, geom = front
    lo = geom["u_soft"] if carried else 0
    ri = _ri(np.stack([y[lo:lo + BLOCK] for y in half[0]]))
    if carried:
        # a later block: carried CFO, NCO phase, tau, theta; carrier 1
        # locked with the 90-degree rotation
        hints = np.asarray([[0.0118, 2.31, 0.21, 0.7, 0.0, 0.0],
                            [-0.0197, 5.02, -0.33, -1.1, 0.0, 1.0]],
                           np.float32)
    else:
        hints = np.asarray([tb.FIRST_HINTS] * C, np.float32)
    soft, nh = fr(torch.from_numpy(ri), torch.from_numpy(hints))
    ref_soft, ref_nh = jax.vmap(
        lambda r, h: jb._front_hinted(r, h, geom["u_soft"]))(
            jnp.asarray(ri), jnp.asarray(hints))
    assert _rms_rel(soft.numpy(), ref_soft) <= BF16_RMS_TOL
    _check_hints(nh.numpy(), np.asarray(ref_nh))


@pytest.mark.parametrize("block", [1 << 15, 1 << 19])
def test_stream_bank_geometry(block):
    for rate in dvbs_fec.RATES:
        assert tb.stream_bank_geometry(rate, block) == \
            jb.stream_bank_geometry(rate, block)


# ---------------------------------------------------------------------------
# the bank step
# ---------------------------------------------------------------------------

def test_bank_step(half):
    """One step on the same cs4 samples and hints, taken from dvbs_tpu's
    stream after 3 blocks (locked, carried hints): emitted bits exact,
    BER exact, hints within their tolerances."""
    sigs = half[0]
    jst, _ = _run(jb.DVBSBankStream, sigs, "1/2", "cs4", BLOCK, hi=3 * BLOCK)
    assert jst.locked.all()
    # the next block starts at the FIFO heads
    lo = [3 * BLOCK - len(f) for f in jst._fifos]
    samples = np.stack([tf.pack_cs4(y[a:a + BLOCK]) for y, a in zip(sigs, lo)])
    hints = jst._hints.copy()
    assert not hints[:, 4].any()
    jstep, _, jgeom = jb.build_dvbs_stream_bank(C, rate="1/2",
                                                block_samples=BLOCK)
    ref = {k: np.asarray(v) for k, v in
           jstep(jnp.asarray(samples), jnp.asarray(hints)).items()}
    step, example, geom = tb.build_dvbs_stream_bank(
        C, rate="1/2", block_samples=BLOCK, device="cpu")
    assert samples.shape == example.shape and samples.dtype == example.dtype
    assert geom == jgeom
    out = {k: v.numpy() for k, v in
           step(torch.from_numpy(samples), torch.from_numpy(hints)).items()}
    assert out["bits"].dtype == np.uint8
    np.testing.assert_array_equal(out["bits"], ref["bits"])
    np.testing.assert_array_equal(out["ber"], ref["ber"])
    assert out["ber"].max() < 0.05
    _check_hints(out["hints"], ref["hints"])


def test_build_rejects_unknown_ingest():
    with pytest.raises(ValueError):
        tb.build_dvbs_stream_bank(C, block_samples=BLOCK, ingest="cs8",
                                  device="cpu")


# ---------------------------------------------------------------------------
# lock search and host tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", ["1/2", None], ids=["fixed", "search"])
def test_try_lock(front, rate):
    y, _ = _carrier(71, 4, rate="3/4" if rate is None else "1/2",
                    cfo=0.01, delay=0.4, snr=10.0)
    # the hypotheses come from one soft stream, handed to both packages
    soft = tb._front_first(front[0], torch.from_numpy(_ri(y[:BLOCK])))[0] \
        .numpy()
    want = JaxReceiver(rate=rate, block_symbols=BLOCK // 2)
    want._try_lock(soft)
    got = DVBSReceiver(rate=rate, block_symbols=BLOCK // 2, device="cpu")
    got._try_lock(soft)
    assert want.locked and got.locked
    assert (got.rate, got.rotation, got.drop, got.ber) == \
        (want.rate, want.rotation, want.drop, want.ber)
    if rate is None:
        assert got.rate == "3/4"


def _coded_bits(n_groups, seed):
    """TS groups -> the deframer's input bits (what the Viterbi decoder
    emits on a clean signal), and the packets."""
    ts = dvbs_mod.random_ts_groups(n_groups, seed=seed)
    groups = [rs_spec.encode(scrambling.dvbs_scramble_group(g)
                             .reshape(8, 188)).reshape(-1)
              for g in ts.reshape(-1, 8 * 188)]
    stream = dvbs_fec.ConvInterleaver().process(np.concatenate(groups))
    return np.unpackbits(stream), ts.reshape(-1, 188)


def test_host_tail_python():
    bits, sent = _coded_bits(6, 5)
    bits = bits.copy()
    rng = np.random.default_rng(2)
    bits[rng.integers(0, len(bits), 40)] ^= 1     # RS corrects these
    want = JaxReceiver(rate="1/2", native_tail=False)
    got = DVBSReceiver(rate="1/2", native_tail=False, device="cpu")
    out_w, out_g = [], []
    for lo in range(0, len(bits), 9001):          # cuts across frames
        out_w.append(want._host_tail(bits[lo:lo + 9001], None, 0))
        out_g.append(got._host_tail(bits[lo:lo + 9001], None, 0))
    for w, g in zip(out_w, out_g):
        np.testing.assert_array_equal(g.ts_packets, w.ts_packets)
        assert (g.frames, g.groups_ok, g.rs_avg_errors, g.deframer_errors) \
            == (w.frames, w.groups_ok, w.rs_avg_errors, w.deframer_errors)
    ts = np.concatenate([g.ts_packets for g in out_g])
    assert len(ts) >= 8
    k0 = sent.tobytes().find(ts[0].tobytes()) // 188
    np.testing.assert_array_equal(ts, sent[k0:k0 + len(ts)])
    st = got.get_state()
    assert set(st) == set(want.get_state())


# ---------------------------------------------------------------------------
# the stream: the same TS bytes as dvbs_tpu's
# ---------------------------------------------------------------------------

def _run(cls, sigs, rate, ingest, chunk, lo=0, hi=None, st=None):
    if st is None:
        kw = dict(device="cpu") if cls is tb.DVBSBankStream else {}
        st = cls(C, rate=rate, block_samples=BLOCK, ingest=ingest, **kw)
    hi = len(sigs[0]) if hi is None else hi
    outs = [bytearray() for _ in range(C)]
    while lo < hi:
        e = min(lo + chunk, hi)
        for c, o in zip(st.feed([s[lo:e] for s in sigs]), outs):
            o.extend(c)
        lo = e
    return st, [bytes(o) for o in outs]


def _contiguous(got: bytes, sent: np.ndarray) -> int:
    g = np.frombuffer(got, np.uint8).reshape(-1, 188)
    assert len(g) > 0
    i0 = sent.tobytes().find(g[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0
    np.testing.assert_array_equal(g, sent[i0 // 188:i0 // 188 + len(g)])
    return len(g)


@pytest.fixture(scope="module")
def jax_half_f16(half):
    """dvbs_tpu's stream over the rate-1/2 carriers, misaligned feeds."""
    return _run(jb.DVBSBankStream, half[0], "1/2", "f16",
                BLOCK * 2 // 3)[1]


@pytest.mark.parametrize("ingest", ["f16", "cs4"])
def test_stream_same_ts_rate12(half, jax_half_f16, ingest):
    sigs, sents = half
    if ingest == "cs4":
        # pre-packed 4-bit IQ, as the bench feeds it (uint8 FIFOs)
        sigs = [tf.pack_cs4(s) for s in sigs]
        ref = _run(jb.DVBSBankStream, sigs, "1/2", "cs4",
                   BLOCK * 2 // 3)[1]
    else:
        ref = jax_half_f16
    st, got = _run(tb.DVBSBankStream, sigs, "1/2", ingest, BLOCK * 2 // 3)
    assert st.locked.all() and (st.ber < 0.05).all()
    for c in range(C):
        assert got[c] == ref[c]
        assert _contiguous(got[c], sents[c]) >= 100
    assert got[0] != got[1]


def test_stream_same_ts_rate34_lock_drop():
    """Rate 3/4: a nonzero alignment drop shrinks the FIFO at lock time,
    so the stream re-checks for a full block before stacking."""
    y0, s0 = _carrier(71, 14, rate="3/4", cfo=0.01, delay=0.4, snr=14.0,
                      sco_ppm=0.0)
    y1, s1 = _carrier(72, 14, rate="3/4", cfo=-0.014, delay=0.4, snr=14.0,
                      sco_ppm=0.0)
    n = min(len(y0), len(y1)) // BLOCK * BLOCK
    sigs = [y0[:n], y1[:n]]
    _, ref = _run(jb.DVBSBankStream, sigs, "3/4", "f16", BLOCK)
    st, got = _run(tb.DVBSBankStream, sigs, "3/4", "f16", BLOCK)
    assert st.locked.all() and (st.ber < 0.05).all()
    assert got == ref
    assert _contiguous(got[0], s0) >= 60 and _contiguous(got[1], s1) >= 60


def test_dvbs_tpu_checkpoint_resumes_in_port(half, jax_half_f16):
    sigs = half[0]
    split = 3 * BLOCK + BLOCK // 3
    st, head = _run(jb.DVBSBankStream, sigs, "1/2", "f16", BLOCK * 2 // 3,
                    hi=split)
    port = tb.DVBSBankStream(C, rate="1/2", block_samples=BLOCK,
                             ingest="f16", device="cpu")
    port.set_state(st.get_state())
    _, tail = _run(None, sigs, "1/2", "f16", BLOCK * 2 // 3, lo=split,
                   st=port)
    for c in range(C):
        assert head[c] + tail[c] == jax_half_f16[c]
    with pytest.raises(ValueError):
        tb.DVBSBankStream(C, rate="3/4", block_samples=BLOCK,
                          device="cpu").set_state(
            st.get_state())


def test_feed_dtype_switch_raises(half):
    st = tb.DVBSBankStream(C, rate="1/2", block_samples=BLOCK,
                           ingest="cs4", device="cpu")
    st.feed([tf.pack_cs4(s[:1000]) for s in half[0]])
    with pytest.raises(TypeError):
        st.feed([s[1000:2000] for s in half[0]])


def test_cs4_checkpoint_resumes(half):
    """A stream fed pre-packed cs4 bytes keeps its uint8 FIFOs across
    get_state/set_state and resumes with the output of an uninterrupted
    run (dvbs_tpu casts the FIFOs to complex64 here: ROADMAP queue 3)."""
    sigs = [tf.pack_cs4(s[:6 * BLOCK]) for s in half[0]]
    _, whole = _run(tb.DVBSBankStream, sigs, "1/2", "cs4", BLOCK)
    split = 2 * BLOCK + BLOCK // 2
    st, head = _run(tb.DVBSBankStream, sigs, "1/2", "cs4", BLOCK, hi=split)
    blob = st.get_state()
    st2 = tb.DVBSBankStream(C, rate="1/2", block_samples=BLOCK, ingest="cs4",
                            device="cpu")
    st2.set_state(blob)
    assert all(f.dtype == np.uint8 for f in st2._fifos)
    _, tail = _run(None, sigs, "1/2", "cs4", BLOCK, lo=split, st=st2)
    assert len(whole[0]) > 0
    for c in range(C):
        assert head[c] + tail[c] == whole[c]
