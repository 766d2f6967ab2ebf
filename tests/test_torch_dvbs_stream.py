"""The port's DVBSStream and CLI `--mode s` against dvbs_tpu's, on the CPU.

Twins of the stream half of tests/test_dvbs_e2e.py (pipelined feed,
checkpoint resume across the two packages in both directions, metric
semantics, native tail against the numpy tail) and of the CLI's DVB-S
routes: one carrier from a cf32 file with and without --rate, a
--state-file resume, --viterbi, and per-carrier auto-locking streams
behind the channelizer (--mode s --carrier without --rate). Signals,
block size and the shared dvbs_tpu receiver are those of
tests/test_torch_dvbs_single.py, whose docstring gives the tolerances.

Exact: every TS byte, the integer metrics; the rolling signal level
within 1 (a mean of re-encode BERs of float16 against float32 soft
values).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from dvbs_tpu import cli as jcli  # noqa: E402
from dvbs_tpu.models import dvbs as jd  # noqa: E402
from dvbs_tpu.tx import channel, dvbs_mod  # noqa: E402
from dvbs_tpu_torch import cli  # noqa: E402
from dvbs_tpu_torch.io import native, source  # noqa: E402
from dvbs_tpu_torch.models import dvbs as td  # noqa: E402
from dvbs_tpu_torch.ops import viterbi, viterbi_kernel  # noqa: E402
from test_torch_dvbs_single import (BS, N, _contiguous, half,  # noqa: E402,F401,E501
                                    jax_rx)

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

CHUNK = 3 * BS                  # odd-sized host chunks, as the reference's


def _feed(st, y, lo=0, hi=None):
    hi = len(y) if hi is None else hi
    return b"".join(st.feed(y[i:min(i + CHUNK, hi)])
                    for i in range(lo, hi, CHUNK))


def _jax_stream(jax_rx):
    st = jd.DVBSStream(block_symbols=BS)
    st.rx = jax_rx()
    return st


@pytest.fixture(scope="module")
def stream_ref(half, jax_rx):
    """dvbs_tpu's DVBSStream over the rate-1/2 signal: uninterrupted
    output and metrics, and its checkpoint halfway with the output so
    far."""
    y = half[0]
    ref = _jax_stream(jax_rx)
    whole = _feed(ref, y)
    cut = (len(y) // CHUNK // 2) * CHUNK
    a = _jax_stream(jax_rx)
    head = _feed(a, y, 0, cut)
    return dict(whole=whole, metrics=ref.metrics, cut=cut, head=head,
                blob=a.get_state())


@pytest.fixture(scope="module")
def stream_port(half):
    st = td.DVBSStream(block_symbols=BS, device="cpu")
    return st, _feed(st, half[0])


METRICS = ("frames_seen", "frames_ok", "deframer_errors", "viterbi_lock",
           "viterbi_rate")


def test_stream_same_ts(half, stream_ref, stream_port):
    st, out = stream_port
    assert out == stream_ref["whole"]
    assert _contiguous(out, half[1]) >= 100
    for k in METRICS:
        assert getattr(st.metrics, k) == getattr(stream_ref["metrics"], k), k


def test_checkpoint_dvbs_tpu_to_port(half, stream_ref):
    st = td.DVBSStream(block_symbols=BS, device="cpu")
    st.set_state(stream_ref["blob"])
    tail = _feed(st, half[0], stream_ref["cut"])
    assert stream_ref["head"] + tail == stream_ref["whole"]
    for k in METRICS:
        assert getattr(st.metrics, k) == getattr(stream_ref["metrics"], k), k


def test_checkpoint_port_to_dvbs_tpu(half, stream_ref, jax_rx):
    y, cut = half[0], stream_ref["cut"]
    st = td.DVBSStream(block_symbols=BS, device="cpu")
    head = _feed(st, y, 0, cut)
    blob = st.get_state()
    assert set(blob) == set(stream_ref["blob"])
    assert set(blob["rx"]) == set(stream_ref["blob"]["rx"])
    ref = _jax_stream(jax_rx)
    ref.set_state(blob)
    assert head + _feed(ref, y, cut) == stream_ref["whole"]
    assert ref.metrics.frames_seen == stream_ref["metrics"].frames_seen


def test_stream_metric_semantics(stream_port, stream_ref):
    """test_dvbs_e2e.test_dvbs_stream_metric_semantics on the port:
    frames_seen counts 1632-byte super-frames, frames_ok dispersal
    groups; the 30-block rolling signal level of a clean carrier."""
    st, out = stream_port
    m = st.metrics
    got = np.frombuffer(out, np.uint8).reshape(-1, 188)
    assert m.frames_seen > 8
    assert m.frames_seen * 8 >= len(got)
    assert 0 < m.frames_ok <= m.frames_seen
    assert m.frames_ok >= m.frames_seen - 4
    assert m.viterbi_sig_level > 95.0
    assert m.rs_avg_errors < 1.0
    assert m.viterbi_lock and m.viterbi_rate == "1/2"
    assert abs(m.viterbi_sig_level -
               stream_ref["metrics"].viterbi_sig_level) <= 1.0


def test_native_tail_equivalence(half, stream_port):
    """The native C++ tail and the numpy tail give the same bytes and
    metrics, and a native-tail checkpoint resumes in a numpy-tail
    stream (test_dvbs_e2e.test_dvbs_native_tail_equivalence)."""
    if not native.available():
        pytest.skip("native library not built")
    y = half[0]
    nat_st, out_n = stream_port
    assert nat_st.rx.native_tail
    pyt = td.DVBSStream(block_symbols=BS, native_tail=False, device="cpu")
    out_p = _feed(pyt, y)
    assert out_n == out_p and len(out_n) > 188 * 50
    for k in ("frames_seen", "frames_ok", "rs_avg_errors",
              "deframer_errors", "viterbi_sig_level"):
        assert getattr(nat_st.metrics, k) == getattr(pyt.metrics, k), k
    cut = (len(y) // CHUNK // 2) * CHUNK
    nat2 = td.DVBSStream(block_symbols=BS, native_tail=True, device="cpu")
    head = _feed(nat2, y, 0, cut)
    py2 = td.DVBSStream(block_symbols=BS, native_tail=False, device="cpu")
    py2.set_state(nat2.get_state())
    assert head + _feed(py2, y, cut) == out_p


def test_viterbi_impl_routing():
    """viterbi_impl names the segment decoder (viterbi_pallas.select_decoder's
    names): "auto" and "pallas" kernel C's wrapper, "xla" the decoder of
    ops/viterbi.py; every DVB-S entry point takes it, and an unknown name
    raises."""
    from dvbs_tpu_torch.parallel import dvbs_bank as tb
    assert viterbi_kernel.select_decoder("xla") is viterbi.decode_segments
    for name in ("auto", "pallas"):
        assert viterbi_kernel.select_decoder(name) is \
            viterbi_kernel.decode_segments
    rx = td.DVBSReceiver(viterbi_impl="xla", device="cpu")
    assert rx._decode_segments is viterbi.decode_segments
    step, _, _ = tb.build_dvbs_stream_bank(2, block_samples=1 << 14,
                                           viterbi_impl="xla", device="cpu")
    assert step.decode_segments is viterbi.decode_segments
    with pytest.raises(ValueError):
        viterbi_kernel.select_decoder("cuda")
    for make in (lambda: td.DVBSStream(viterbi_impl="cuda", device="cpu"),
                 lambda: tb.DVBSBankStream(2, block_samples=1 << 14,
                                           viterbi_impl="cuda",
                                           device="cpu"),
                 lambda: tb.build_dvbs_bank(2, viterbi_impl="cuda",
                                            device="cpu")):
        with pytest.raises(ValueError):
            make()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture(half, tmp_path_factory):
    """The rate-1/2 signal as a cf32 file, and dvbs_tpu's CLI output for
    it (`--mode s`, rate found by the lock search)."""
    tmp = tmp_path_factory.mktemp("dvbs_cli")
    iq = str(tmp / "cap.cf32")
    source.write_iq_file(iq, half[0])
    out = tmp / "j.ts"
    assert jcli.main(["--iq", iq, "--mode", "s", "--block-symbols", str(BS),
                      "--out", str(out)]) == 0
    return iq, out.read_bytes()


@pytest.mark.parametrize("rate", [[], ["--rate", "1/2"]],
                         ids=["auto", "fixed"])
def test_cli_mode_s(half, capture, tmp_path, rate):
    iq, want = capture
    out = tmp_path / "t.ts"
    assert cli.main(["--iq", iq, "--mode", "s", "--block-symbols", str(BS),
                     "--out", str(out), "--device", "cpu"] + rate) == 0
    got = out.read_bytes()
    assert got == want
    assert _contiguous(got, half[1]) >= 100


def test_cli_state_file_resume(half, capture, tmp_path):
    """Two runs joined by a --state-file give the uninterrupted run's
    bytes: the checkpoint holds the FIFO, hints, carry and tail."""
    y = half[0]
    cut = (len(y) // 2) // (4 * BS) * (4 * BS)   # a multiple of the read
    state = str(tmp_path / "rx.state")
    joined = b""
    for k, part in enumerate((y[:cut], y[cut:])):
        iq = str(tmp_path / f"{k}.cf32")
        source.write_iq_file(iq, part)
        out = tmp_path / f"{k}.ts"
        assert cli.main(["--iq", iq, "--mode", "s", "--block-symbols",
                         str(BS), "--state-file", state, "--out", str(out),
                         "--device", "cpu"]) == 0
        joined += out.read_bytes()
    assert len(joined) > 0 and joined == capture[1]


def test_cli_viterbi_xla(capture, tmp_path, monkeypatch):
    """--viterbi xla reaches the receiver: kernel C's wrapper is never
    called, and the bytes are the same."""
    calls = []
    orig = viterbi_kernel.decode_segments
    monkeypatch.setattr(viterbi_kernel, "decode_segments",
                        lambda llrs: calls.append(1) or orig(llrs))
    out = tmp_path / "x.ts"
    assert cli.main(["--iq", capture[0], "--mode", "s", "--block-symbols",
                     str(BS), "--viterbi", "xla", "--out", str(out),
                     "--device", "cpu"]) == 0
    assert not calls and out.read_bytes() == capture[1]


def test_cli_carriers_auto_rate(tmp_path):
    """--mode s --carrier without --rate: one auto-locking DVBSStream per
    carrier behind the channelizer, each finding its own rate."""
    def carrier(rate, n_groups, seed):
        ts = dvbs_mod.random_ts_groups(n_groups, seed=seed)
        x = channel.shape(dvbs_mod.DVBSModulator(rate=rate)
                          .ts_to_symbols(ts), sps=10)[::2]   # 5 sps
        return x, ts.reshape(-1, 188)
    a, sent_a = carrier("1/2", 8, 51)
    b, sent_b = carrier("3/4", 11, 52)
    n = min(len(a), len(b))
    t = np.arange(n)
    wide = (a[:n] * np.exp(2j * np.pi * (-1.1 / 5.0) * t) +
            b[:n] * np.exp(2j * np.pi * (+1.4 / 5.0) * t)).astype(np.complex64)
    wide = channel.impair(wide, snr_db=20.0, seed=53)
    iq = str(tmp_path / "wide.cf32")
    source.write_iq_file(iq, wide)
    out = tmp_path / "w.ts"
    assert cli.main(["--iq", iq, "--mode", "s", "--samplerate", "5.0",
                     "--symbolrate", "1.0", "--offset", "-1.1",
                     "--carrier", "1.4:1.0", "--block-symbols", str(BS),
                     "--out", str(out), "--device", "cpu"]) == 0
    assert _contiguous(out.read_bytes(), sent_a) >= 16
    assert _contiguous((tmp_path / "w.ts.c1").read_bytes(), sent_b) >= 16
