"""The port's carrier bank and bank stream against dvbs_tpu's, on the CPU.

Two carriers of short-frame DVB-S2 QPSK 1/2 at 6 dB, cs4 ingest:

- one bank step of dvbs_tpu_torch.parallel.mesh.build_carrier_bank
  (int8 FEC through kernel A's plain version) against dvbs_tpu's
  build_carrier_bank(fec="pallas", interpret_pallas=True), the port run
  from its own tables and from the tables dvbs_tpu builds;
- DVBS2BankStream over 3 blocks plus flush emits the same TS bytes as
  dvbs_tpu's DVBS2BankStream;
- a checkpoint taken by dvbs_tpu's stream resumes in the port's.

Tolerances and why:
- exact: kbch_bytes, ldpc_ok, bch_bad, starts, pls, TS bytes (decoded
  bits and integer decisions on a clean signal);
- trials within +-1: quantize_llrs may move an LLR by 1 LSB;
- quality, freq: max abs error <= 1e-3 (float32 sums in another order,
  bf16-rounded matmul inputs).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from dvbs_tpu.models.bank_stream import DVBS2BankStream as JaxBankStream  # noqa: E402,E501
from dvbs_tpu.parallel import mesh as jmesh  # noqa: E402
from dvbs_tpu.spec import modcod  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream  # noqa: E402
from dvbs_tpu_torch.ops.frontend import pack_cs4  # noqa: E402
from dvbs_tpu_torch.parallel import mesh  # noqa: E402
from test_torch_tables import jax_receiver_tables  # noqa: E402

torch.set_num_threads(2)

MC, SHORT, C = 4, True, 2
CFG = modcod.get_config(MC, short=SHORT)
BLOCK = mesh.bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
N = 2 * BLOCK


def _carrier(seed, cfo, delay):
    pkts = dvbs2_mod.random_ts_packets(150, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, CFG)
    tx = dvbs2_mod.bbframes_to_plframes(bb, CFG).reshape(-1)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=6.0, cfo=cfo,
                       delay_samples=delay, sco_ppm=10.0, seed=seed + 1)
    return pack_cs4(y), pkts.reshape(-1, 188)


@pytest.fixture(scope="module")
def signals():
    a, sa = _carrier(31, 0.006 * np.pi, 0.3)
    b, sb = _carrier(47, -0.011 * np.pi, 0.7)
    n = min(len(a), len(b))
    return [a[:n], b[:n]], [sa, sb]


@pytest.fixture(scope="module")
def jax_step_out(signals):
    step, _, _ = jmesh.build_carrier_bank(
        C, mc=MC, short=SHORT, block_symbols=BLOCK, fec="pallas",
        ingest="cs4", interpret_pallas=True, stream_outputs=True)
    out = step(np.stack([s[:N] for s in signals[0]]))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("tables_from", ["port", "dvbs_tpu"])
def test_bank_step_matches(signals, jax_step_out, tables_from):
    np_tables = None
    if tables_from == "dvbs_tpu":
        np_tables = jax_receiver_tables(CFG, BLOCK)
    step, example, _ = mesh.build_carrier_bank(
        C, mc=MC, short=SHORT, block_symbols=BLOCK, fec="int8",
        ingest="cs4", stream_outputs=True, np_tables=np_tables,
        device="cpu")
    samples = np.stack([s[:N] for s in signals[0]])
    assert samples.shape == example.shape and samples.dtype == example.dtype
    out = {k: v.numpy() for k, v in step(torch.from_numpy(samples)).items()}
    ref = jax_step_out
    assert ref["ldpc_ok"].all() and not ref["bch_bad"].any()
    for k in ("kbch_bytes", "ldpc_ok", "bch_bad", "starts", "pls"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert np.abs(out["trials"].astype(int) - ref["trials"]).max() <= 1
    for k in ("quality", "freq"):
        assert np.abs(out[k] - ref[k]).max() <= 1e-3, k


def test_fec_names():
    """"int8" and "pallas" name the int8 layered decoder, "xla" the float
    decode_qc, and "auto" picks as dvbs_tpu does: int8 at a frame total
    of 128, float otherwise; pilotless 8PSK builds (the decision-directed
    track); an unknown name raises."""
    kw = dict(mc=MC, short=SHORT, block_symbols=BLOCK, device="cpu")
    for name, want in (("auto", "xla"), ("int8", "pallas"),
                       ("pallas", "pallas"), ("xla", "xla")):
        step, _ = mesh.build_carrier_bank(C, fec=name, **kw)
        assert step.rx.fec == want
    full = mesh.bank_block_symbols(C, mc=MC, short=SHORT)   # 128 frames
    step, _ = mesh.build_carrier_bank(C, mc=MC, short=SHORT,
                                      block_symbols=full, device="cpu")
    assert C * step.rx.n_frames == 128 and step.rx.fec == "pallas"
    with pytest.raises(ValueError):
        mesh.build_carrier_bank(C, fec="f32", **kw)
    step, _ = mesh.build_carrier_bank(C, mc=13, short=True,
                                      block_symbols=BLOCK, device="cpu")
    assert not step.rx.cfg.pilots
    step, _ = mesh.build_carrier_bank(C, mc=13, short=True, pilots=True,
                                      block_symbols=BLOCK, device="cpu")
    assert step.rx.cfg.pilots and step.rx.cfg.constellation == modcod.PSK8


def test_fec_auto_at_another_total(signals, jax_stream_ts):
    """fec="auto" at a frame total other than 128 (here C * F = 4) takes
    the float decode_qc in both packages: equal trials and bytes of a
    bank step, and equal TS bytes of the stream."""
    samples = np.stack([s[:N] for s in signals[0]])
    jstep, _ = jmesh.build_carrier_bank(C, mc=MC, short=SHORT,
                                        block_symbols=BLOCK, fec="auto",
                                        ingest="cs4")
    ref = {k: np.asarray(v) for k, v in jstep(samples).items()}
    step, _ = mesh.build_carrier_bank(C, mc=MC, short=SHORT,
                                      block_symbols=BLOCK, fec="auto",
                                      ingest="cs4", device="cpu")
    assert step.rx.fec == "xla"
    out = {k: v.numpy() for k, v in step(torch.from_numpy(samples)).items()}
    for k in ("trials", "kbch_bytes", "ldpc_ok", "bch_bad"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                         ingest="cs4", device="cpu")
    outs = [bytearray(), bytearray()]
    _stream(st, signals[0], 0, _need(), outs)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert [bytes(o) for o in outs] == jax_stream_ts


def _stream(st, sigs, lo, hi, outs):
    chunk = N // 2
    while lo < hi:
        e = min(lo + chunk, hi)
        for c, o in zip(st.feed([s[lo:e] for s in sigs]), outs):
            o.extend(c)
        lo = e


def _need():
    F = (BLOCK - 2 * 256 - 90) // CFG.plframe_len - 1
    return N + 3 * 2 * F * CFG.plframe_len + 2 * CFG.plframe_len


@pytest.fixture(scope="module")
def jax_stream_ts(signals):
    sigs = signals[0]
    st = JaxBankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                       ingest="cs4")
    outs = [bytearray(), bytearray()]
    _stream(st, sigs, 0, _need(), outs)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert (st.frames_ok == st.frames_seen).all()
    return [bytes(o) for o in outs]


def _contiguous(got: bytes, sent: np.ndarray) -> int:
    g = np.frombuffer(got, np.uint8).reshape(-1, 188)
    k0 = sent.tobytes().find(g[0].tobytes()) // 188
    assert np.array_equal(g, sent[k0:k0 + len(g)])
    return len(g)


def test_bank_stream_same_ts(signals, jax_stream_ts):
    sigs, sents = signals
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                         fec="int8", ingest="cs4", device="cpu")
    outs = [bytearray(), bytearray()]
    _stream(st, sigs, 0, _need(), outs)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    assert (st.frames_seen >= 4 * st.F).all()
    assert (st.frames_ok == st.frames_seen).all()
    for c in range(C):
        assert bytes(outs[c]) == jax_stream_ts[c]
        assert _contiguous(bytes(outs[c]), sents[c]) >= 3 * st.F * 4


def test_dvbs_tpu_checkpoint_resumes_in_port(signals, jax_stream_ts):
    sigs = signals[0]
    split = N + N // 2
    st = JaxBankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                       ingest="cs4")
    outs = [bytearray(), bytearray()]
    _stream(st, sigs, 0, split, outs)
    blob = st.get_state()
    st2 = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                          fec="int8", ingest="cs4", device="cpu")
    st2.set_state(blob)
    _stream(st2, sigs, split, _need(), outs)
    for c, o in zip(st2.flush(), outs):
        o.extend(c)
    for c in range(C):
        assert bytes(outs[c]) == jax_stream_ts[c]
