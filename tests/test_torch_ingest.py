"""Arbitrary-rate ingest of the port (dvbs_tpu_torch.ops.resample) against
dvbs_tpu.ops.resample on the same numpy inputs, on the CPU.

Tolerances, each with its reason:

- polyphase_taps, pad_amounts, rate_fraction, default_taps_per_phase:
  exact (numpy on both sides).
- rational_resample, resample_window, StreamingResampler.feed: max abs
  error <= 1e-5 on unit-variance samples. Both sides add the same
  float32 tap products in the same order; XLA may contract a
  multiply-add, PyTorch does not.
- the port's chunked StreamingResampler against the port's one-shot
  rational_resample: bit-identical (the property dvbs_tpu's own test
  holds).
- Channelizer.feed: max abs error <= 2e-4 per carrier. The NCO's
  float32 phase reaches 2 pi + 255 w (about 300 rad at these offsets),
  where one float32 step is 3e-5 rad, and XLA may contract w * lo + phi
  into one rounding where PyTorch makes two.
- a tone's position: output k is the input at k M/L + 1/(2L) samples,
  plus half a sample where the tap count is odd (the read origin
  T//2 - 1 floors), within 2e-3. This pins the tap order, the phase
  lanes and the group delay without reference to dvbs_tpu.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.ops import resample as jr  # noqa: E402
from dvbs_tpu.spec import modcod  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch import cli  # noqa: E402
from dvbs_tpu_torch.io import source  # noqa: E402
from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver  # noqa: E402
from dvbs_tpu_torch.tx import signals  # noqa: E402
from dvbs_tpu_torch.ops import resample as tr  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
RATIOS = [(2, 5), (2, 3), (1, 2), (4, 5), (3, 7)]


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


@pytest.mark.parametrize("L,M", RATIOS)
def test_helpers_equal(L, M):
    T = tr.default_taps_per_phase(L, M)
    assert T == jr.default_taps_per_phase(L, M)
    assert tr.pad_amounts(L, M, T) == jr.pad_amounts(L, M, T)
    np.testing.assert_array_equal(tr.polyphase_taps(L, M, T),
                                  jr.polyphase_taps(L, M, T))
    for sr, sym in ((5e6, 1e6), (2.0001e6, 1e6), (8e6, 1.3e6)):
        assert tr.rate_fraction(sr, sym) == jr.rate_fraction(sr, sym)
    with pytest.raises(ValueError):
        tr.rate_fraction(1.9e6, 1e6)


@pytest.mark.parametrize("L,M", RATIOS)
def test_rational_resample(L, M):
    x = _noise(M * 700 + 13, seed=L + M)
    want = np.asarray(jr.rational_resample(jnp.asarray(x), L, M))
    got = tr.rational_resample(torch.from_numpy(x), L, M)
    assert got.dtype == torch.complex64
    got = got.numpy()
    assert got.shape == want.shape == ((len(x) * L) // M // L * L,)
    assert np.abs(got - want).max() <= TOL
    # a given tap count, and the window form with K named
    T = 12
    want = np.asarray(jr.rational_resample(jnp.asarray(x), L, M, T))
    got = tr.rational_resample(torch.from_numpy(x), L, M, T).numpy()
    assert np.abs(got - want).max() <= TOL
    lpad, rpad = tr.pad_amounts(L, M, T)
    K = 50
    xw = x[:lpad + K * M + rpad]
    want = np.asarray(jr.resample_window(jnp.asarray(xw), L, M, T, K))
    got = tr.resample_window(torch.from_numpy(xw), L, M, T, K).numpy()
    assert got.shape == want.shape == (K * L,)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("L,M", RATIOS)
def test_tone_lands_where_it_should(L, M):
    """Output k interpolates input position k*M/L + 1/(2L) (+ 1/2 for an
    odd tap count): a wrong tap order, phase lane or group delay moves
    the tone's phase."""
    f0 = 0.3 * 0.5 * L / M                     # 0.3 x the output Nyquist
    n = M * 1024
    x = np.exp(2j * np.pi * f0 * np.arange(n)).astype(np.complex64)
    y = tr.rational_resample(torch.from_numpy(x), L, M).numpy()
    k = np.arange(len(y))
    adv = 0.5 / L + 0.5 * (tr.default_taps_per_phase(L, M) % 2)
    ref = np.exp(2j * np.pi * f0 * (k * M / L + adv))
    sl = slice(200, len(y) - 200)
    assert np.abs(y[sl] - ref[sl]).max() <= 2e-3


def test_streaming_resampler():
    """Ragged feeds: the chunked output equals dvbs_tpu's chunked output
    within TOL and the port's own one-shot resample bit for bit, and a
    state saved mid-stream (the port's, or dvbs_tpu's) resumes it."""
    x = _noise(5 * 8192, seed=0)
    kw = dict(samplerate=5.0, symbolrate=1.0, chunk_hint=2048)
    jsr, sr = jr.StreamingResampler(**kw), \
        tr.StreamingResampler(device="cpu", **kw)
    assert (sr.L, sr.M, sr.chunk, sr.taps_per_phase) == \
        (jsr.L, jsr.M, jsr.chunk, jsr.taps_per_phase) and not sr.identity
    assert sr.residual_sco == jsr.residual_sco
    cuts = list(range(0, len(x), 3001)) + [len(x)]
    want, got = [], []
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        want.append(jsr.feed(x[lo:hi]))
        got.append(sr.feed(x[lo:hi]))
        assert got[-1].dtype == np.complex64
        assert got[-1].shape == want[-1].shape
        if i == 6:                              # checkpoint and resume
            st, jst = sr.get_state(), jsr.get_state()
            np.testing.assert_array_equal(st["buf"], jst["buf"])
            sr = tr.StreamingResampler(device="cpu", **kw)
            sr.set_state(jst)
    want, got = np.concatenate(want), np.concatenate(got)
    assert np.abs(got - want).max() <= TOL
    one = tr.rational_resample(torch.from_numpy(x), sr.L, sr.M).numpy()
    assert len(got) > 0.9 * len(one)
    np.testing.assert_array_equal(got, one[:len(got)])
    # samplerate = 2 x symbolrate: nothing to do
    ident = tr.StreamingResampler(2e6, 1e6, device="cpu")
    assert ident.identity
    np.testing.assert_array_equal(ident.feed(x[:100]), x[:100])


def _wideband():
    """tests/test_resample.py's capture: two short-frame QPSK 1/2
    carriers at +-1.5 MHz in 8 MHz, 1 Msym/s each, and light noise."""
    cfg = modcod.get_config(4, short=True)
    fs, offs = 8e6, (-1.5e6, +1.5e6)
    txs, sent = [], []
    for c, f in enumerate(offs):
        pkts = dvbs2_mod.random_ts_packets(160, seed=20 + c)
        sent.append(pkts.reshape(-1, 188))
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        x8 = channel.shape(tx, sps=8)
        txs.append(x8 * np.exp(2j * np.pi * (f / fs) * np.arange(len(x8))
                               ).astype(np.complex64))
    n = min(map(len, txs))
    wide = sum(t[:n] for t in txs) / np.sqrt(2) + 0.05 * _noise(n, seed=3)
    return fs, offs, wide.astype(np.complex64), sent


def test_channelizer():
    """Per carrier the port's 2 sps baseband equals dvbs_tpu's within
    2e-4 over ragged feeds (the NCO's phase carried across them), a
    saved state resumes it, and each baseband decodes in the port's
    receiver."""
    fs, offs, wide, _ = _wideband()
    carriers = [(f, 1e6) for f in offs]
    jch = jr.Channelizer(fs, carriers, chunk_hint=1 << 14)
    ch = tr.Channelizer(fs, carriers, chunk_hint=1 << 14, device="cpu")
    assert ch.feed(wide[:0])[0].shape == (0,)
    cuts = [0, 70001, 70001 + 4099, 200000, len(wide)]
    want, got = [[], []], [[], []]
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        for acc, outs in ((want, jch.feed(wide[lo:hi])),
                          (got, ch.feed(wide[lo:hi]))):
            for c in range(2):
                acc[c].append(outs[c])
        if i == 1:                              # checkpoint and resume
            st, jst = ch.get_state(), jch.get_state()
            assert st["n0"] == jst["n0"] == cuts[2]
            for a, b in zip(st["rs"], jst["rs"]):
                assert a["buf"].shape == b["buf"].shape
                assert np.abs(a["buf"] - b["buf"]).max() <= 2e-4
            ch = tr.Channelizer(fs, carriers, chunk_hint=1 << 14,
                                device="cpu")
            ch.set_state(st)
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=1 << 15, device="cpu")
    for c in range(2):
        w, g = np.concatenate(want[c]), np.concatenate(got[c])
        assert g.shape == w.shape and g.dtype == np.complex64
        assert len(g) >= 2 * (1 << 15)
        assert np.abs(g - w).max() <= 2e-4, c
        res = rx.process_symbols_block(g[:2 * (1 << 15)])
        assert res.frame_ok.sum() >= 1, f"carrier {c} failed to decode"


def test_2p5_sps_capture_decodes():
    """A 2.5 samples/symbol capture, resampled to 2 by the port, decodes
    in the port's receiver (tests/test_resample.py's end-to-end case)."""
    cfg = modcod.get_config(4, short=True)
    pkts = dvbs2_mod.random_ts_packets(160, seed=7)
    tx = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
    y5 = channel.impair(channel.shape(tx, sps=5), snr_db=8.0,
                        cfo=0.004 * np.pi, seed=8)
    y2 = tr.StreamingResampler(5.0, 1.0, device="cpu").feed(y5)
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=1 << 15, device="cpu")
    res = rx.process_symbols_block(y2[:2 * (1 << 15)])
    assert res.frame_ok.sum() >= len(res.frame_ok) - 1


def test_cli_two_carriers_of_one_capture(tmp_path):
    """The CLI's --samplerate/--symbolrate/--offset/--carrier route on
    the wideband capture: the channelizer feeds the fused DVB-S2 bank,
    and each carrier's TS is one byte-exact contiguous run of the
    packets that carrier was sent."""
    fs, offs, wide, sent = _wideband()
    iq = str(tmp_path / "wide.cf32")
    source.write_iq_file(iq, wide)
    out = str(tmp_path / "o.ts")
    assert cli.main([
        "--iq", iq, "--mode", "s2", "--modcod", "4", "--framesize", "short",
        "--block-symbols", "32768", "--fec", "xla", "--samplerate", str(fs),
        "--symbolrate", "1e6", f"--offset={offs[0]}", "--carrier",
        f"{offs[1]}:1e6", "--out", out, "--device", "cpu"]) == 0
    for c, name in enumerate((out, out + ".c1")):
        with open(name, "rb") as f:
            n = signals.contiguous_packets(f.read(), sent[c], f"carrier {c}")
        assert n >= 0.5 * len(sent[c]), (c, n)
