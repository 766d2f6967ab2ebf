"""The port's pilots-on DVB-S2 receiver against dvbs_tpu's, on the CPU.

Both packages get the same numpy inputs, made from a seed:

- the pilot pieces of plphase (coarse_fed_common and lr_freq_common
  with their pilot segments, extract_payload, pilot_anchor_phases) on
  synthetic frames of QPSK, 8PSK, 16APSK and 32APSK, short and normal,
  and the known-ramp case of tests/test_bench_envelope.py;
- soft_demap and deinterleave at 8PSK, 16APSK and 32APSK;
- one bank step of two carriers of short frames with pilots, at
  MODCODs 4, 13, 18 and 24, against dvbs_tpu's
  build_carrier_bank(fec="pallas", interpret_pallas=True), the port
  run from its own tables and from the tables dvbs_tpu builds;
- DVBS2BankStream at 8PSK 2/3 with pilots over 3 blocks plus flush
  emits dvbs_tpu's TS bytes;
- what an auto-MODCOD switch does in the port's stream.

Tolerances and why:
- exact: extract_payload and deinterleave (index work), and the bank's
  kbch_bytes, ldpc_ok, bch_bad, starts, pls and the TS bytes (decoded
  bits and integer decisions on a clean signal);
- frequency estimates: max abs error <= 1e-5 rad/symbol, anchor phases
  <= 1e-4 rad (float32 sums in another order; the port's pilot
  phasors are multiplied by conj of the pilot in float64 once);
- LLRs: max abs error <= 1e-3 (exp/log in float32);
- trials within +-1 (quantize_llrs may move an LLR by 1 LSB); quality
  and freq within 1e-3;
- the known ramp: the track's error < 0.08 rad over the payload and
  after the last pilot (the limit of tests/test_bench_envelope.py).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.models.bank_stream import DVBS2BankStream as JaxBankStream  # noqa: E402,E501
from dvbs_tpu.ops import demap as jdemap  # noqa: E402
from dvbs_tpu.ops import plphase as jph  # noqa: E402
from dvbs_tpu.parallel import mesh as jmesh  # noqa: E402
from dvbs_tpu.spec import interleaver as jil  # noqa: E402
from dvbs_tpu.spec import modcod, scrambling  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch import tables  # noqa: E402
from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream  # noqa: E402
from dvbs_tpu_torch.ops import demap, interleaver, plphase  # noqa: E402
from dvbs_tpu_torch.ops.frontend import pack_cs4  # noqa: E402
from dvbs_tpu_torch.parallel import mesh  # noqa: E402
from test_torch_tables import jax_receiver_tables  # noqa: E402

torch.set_num_threads(2)

C = 2
FREQ_TOL, PHASE_TOL, LLR_TOL = 1e-5, 1e-4, 1e-3


def _pilots(cfg):
    return (tables.pilot_starts(cfg),
            torch.from_numpy(tables.pilot_descramble_phasors(cfg)))


def _frames(cfg, seed, F=2):
    """[C, F, L] complex64: PLHEADER, scrambled pilots and random points
    of the constellation, turned by phi + f*n (f up to 4e-4 rad/symbol,
    so the anchors wrap past +-pi), at ~17 dB."""
    rng = np.random.default_rng(seed)
    L = cfg.plframe_len
    pts = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)[0]
    fr = pts[rng.integers(0, len(pts), (C, F, L))]
    fr[..., :90] = tables.header_syms(cfg.pls_code)
    ph = scrambling.pl_scrambler_phasors()[:L - 90]
    for p in tables.pilot_starts(cfg):
        fr[..., p:p + 36] = tables.PILOT_SYMBOL * ph[p - 90:p - 90 + 36]
    phi = rng.uniform(-np.pi, np.pi, (C, F, 1))
    f = rng.uniform(-4e-4, 4e-4, (C, 1, 1))
    noise = rng.normal(size=(2, C, F, L)) * 0.1
    return (fr * np.exp(1j * (phi + f * np.arange(L))) + noise[0] +
            1j * noise[1]).astype(np.complex64)


def _max_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)))


@pytest.mark.parametrize("mc,short", [(mc, short) for short in (True, False)
                                      for mc in (4, 13, 18, 24)])
def test_pilot_pieces(mc, short):
    cfg = modcod.get_config(mc, short=short, pilots=True)
    frames = _frames(cfg, 10 * mc + short)
    ft = torch.from_numpy(frames)
    hdr = torch.from_numpy(tables.header_syms(cfg.pls_code))
    pilots = _pilots(cfg)
    fed = plphase.coarse_fed_common(ft, hdr, pilots).numpy()
    flr = plphase.lr_freq_common(ft, hdr, pilots).numpy()
    pay = plphase.extract_payload(ft, pilots[0], cfg.plframe_len).numpy()
    np.testing.assert_array_equal(
        pay, frames[..., tables.payload_indices(cfg)])
    th = np.stack([np.asarray(jph.header_phase(jnp.asarray(f), cfg))
                   for f in frames])
    track = plphase.pilot_anchor_phases(ft, torch.from_numpy(th),
                                        pilots).numpy()
    for c in range(C):
        fj = jnp.asarray(frames[c])
        assert _max_err(fed[c], jph.coarse_fed_common(fj, cfg)) <= FREQ_TOL
        assert _max_err(flr[c], jph.lr_freq_common(fj, cfg)) <= FREQ_TOL
        np.testing.assert_array_equal(pay[c], jph.extract_payload(fj, cfg))
        ref = jph.pilot_anchor_phases(fj, cfg, jnp.asarray(th[c]))
        assert _max_err(track[c], ref) <= PHASE_TOL


def test_pilot_anchor_single_pilot(monkeypatch):
    """The n_p == 1 branch: the tail goes on at the header-to-pilot
    slope. No configuration has one pilot block, so both packages get
    the first block of 16APSK 2/3 short alone."""
    cfg = modcod.get_config(18, short=True, pilots=True)
    ps = tables.pilot_starts(cfg)[:1]
    monkeypatch.setattr(jph, "pilot_starts", lambda c: ps)
    frames = _frames(cfg, 5)
    th = np.stack([np.asarray(jph.header_phase(jnp.asarray(f), cfg))
                   for f in frames])
    pd = torch.from_numpy(tables.pilot_descramble_phasors(cfg)[:1])
    track = plphase.pilot_anchor_phases(torch.from_numpy(frames),
                                        torch.from_numpy(th), (ps, pd))
    for c in range(C):
        ref = jph.pilot_anchor_phases(jnp.asarray(frames[c]), cfg,
                                      jnp.asarray(th[c]))
        assert _max_err(track[c], ref) <= PHASE_TOL


def test_pilot_anchor_tail_tracks_known_ramp():
    """tests/test_bench_envelope.py's known ramp through the port: a
    residual carrier of 5e-4 rad/symbol on 32APSK 3/4 normal frames is
    tracked over the whole payload and after the last pilot block,
    where a flat tail would be off by > 0.5 rad."""
    cfg = modcod.get_config(24, short=False, pilots=True)
    L = cfg.plframe_len
    F = 2
    rng = np.random.default_rng(0)
    f_res, phi0 = 5e-4, 0.3
    frame = np.exp(1j * 2 * np.pi * rng.random(L)).astype(np.complex64)
    frame[:90] = tables.header_syms(cfg.pls_code)
    ph = scrambling.pl_scrambler_phasors()[:L - 90]
    for p in tables.pilot_starts(cfg):
        frame[p:p + 36] = tables.PILOT_SYMBOL * ph[p - 90:p - 90 + 36]
    true_phase = phi0 + f_res * np.arange(L)
    frames = np.broadcast_to(frame * np.exp(1j * true_phase), (F, L))
    noisy = frames + (rng.normal(size=(F, L), scale=0.13) +
                      1j * rng.normal(size=(F, L), scale=0.13))
    ft = torch.from_numpy(noisy.astype(np.complex64))
    hdr = torch.from_numpy(tables.header_syms(cfg.pls_code))
    theta0 = plphase.header_phase(ft, hdr)
    track = plphase.pilot_anchor_phases(ft, theta0, _pilots(cfg)).numpy()
    err = track - true_phase[None, :]
    err = err - np.round(err.mean() / (2 * np.pi)) * 2 * np.pi
    assert np.abs(err[:, 90:]).max() < 0.08, np.abs(err[:, 90:]).max()
    last = int(tables.pilot_starts(cfg)[-1]) + 36
    assert np.abs(err[:, last:]).max() < 0.08, np.abs(err[:, last:]).max()


@pytest.mark.parametrize("mc,short", [(14, False), (14, True), (18, False),
                                      (18, True), (24, False), (24, True)])
def test_demap_and_deinterleave(mc, short):
    cfg = modcod.get_config(mc, short=short, pilots=True)
    pts, mask0 = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)
    rng = np.random.default_rng(100 + mc)
    shape = (2, cfg.payload_len)
    syms = (pts[rng.integers(0, len(pts), shape)] + 0.15 * (
        rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)
    ref = np.array(jdemap.soft_demap(jnp.asarray(syms), cfg.constellation,
                                     cfg.g1, cfg.g2))
    got = demap.soft_demap(torch.from_numpy(syms), cfg.constellation,
                           torch.from_numpy(pts), torch.from_numpy(mask0))
    assert _max_err(got.numpy(), ref) <= LLR_TOL
    dref = jil.deinterleave_device(jnp.asarray(ref), cfg.constellation,
                                   cfg.framesize, cfg.rate)
    dgot = interleaver.deinterleave(torch.from_numpy(ref), cfg.constellation,
                                    cfg.framesize, cfg.rate)
    assert dgot.shape == (2, cfg.nldpc)
    np.testing.assert_array_equal(dgot.numpy(), np.asarray(dref))


# ---------------------------------------------------------------------------
# the bank step and the stream, two carriers of short frames
# ---------------------------------------------------------------------------

def _block(mc):
    return mesh.bank_block_symbols(C, mc=mc, short=True, pilots=True,
                                   frames_total=4)


def _signals(cfg, snr_db, n_frames):
    """Two distinct impaired carriers, cs4-packed, and their packets."""
    per = cfg.kbch // 8 // 188 + 1
    sigs, sents = [], []
    for seed, cfo, delay in ((21, 0.006 * np.pi, 0.3),
                             (34, -0.011 * np.pi, 0.7)):
        pkts = dvbs2_mod.random_ts_packets(n_frames * per, seed=seed)
        tx = dvbs2_mod.bbframes_to_plframes(
            dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=snr_db, cfo=cfo,
                           delay_samples=delay, sco_ppm=10.0, seed=seed + 1)
        sigs.append(pack_cs4(y))
        sents.append(pkts.reshape(-1, 188))
    n = min(len(s) for s in sigs)
    return [s[:n] for s in sigs], sents


BANK_CASES = {4: 6.0, 13: 10.0, 18: 13.0, 24: 17.0}   # MODCOD: SNR dB


@pytest.fixture(scope="module", params=sorted(BANK_CASES))
def bank_case(request):
    """(mc, cs4 input [C, n], dvbs_tpu's step outputs)."""
    mc = request.param
    cfg = modcod.get_config(mc, short=True, pilots=True)
    block = _block(mc)
    sigs, _ = _signals(cfg, BANK_CASES[mc], 5)
    x = np.stack([s[:2 * block] for s in sigs])
    step, _, _ = jmesh.build_carrier_bank(
        C, mc=mc, short=True, pilots=True, block_symbols=block,
        fec="pallas", ingest="cs4", interpret_pallas=True,
        stream_outputs=True)
    return mc, x, {k: np.asarray(v) for k, v in step(x).items()}


@pytest.mark.parametrize("tables_from", ["port", "dvbs_tpu"])
def test_bank_step_matches(bank_case, tables_from):
    mc, x, ref = bank_case
    cfg = modcod.get_config(mc, short=True, pilots=True)
    block = _block(mc)
    np_tables = None
    if tables_from == "dvbs_tpu":
        np_tables = jax_receiver_tables(cfg, block)
    step, example, _ = mesh.build_carrier_bank(
        C, mc=mc, short=True, pilots=True, block_symbols=block, fec="int8",
        ingest="cs4", stream_outputs=True, np_tables=np_tables,
        device="cpu")
    assert x.shape == example.shape and x.dtype == example.dtype
    out = {k: v.numpy() for k, v in step(torch.from_numpy(x)).items()}
    assert ref["ldpc_ok"].all() and not ref["bch_bad"].any()
    assert (ref["pls"] == cfg.pls_code).all()
    for k in ("kbch_bytes", "ldpc_ok", "bch_bad", "starts", "pls"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert np.abs(out["trials"].astype(int) - ref["trials"]).max() <= 1
    for k in ("quality", "freq"):
        assert _max_err(out[k], ref[k]) <= 1e-3, k


MC_STREAM = 13                   # 8PSK 2/3, short frames, pilots
CFG_STREAM = modcod.get_config(MC_STREAM, short=True, pilots=True)


@pytest.fixture(scope="module")
def stream_signals():
    return _signals(CFG_STREAM, 10.0, 16)


def _feed(st, sigs, lo, hi, outs):
    chunk = _block(MC_STREAM)
    while lo < hi:
        e = min(lo + chunk, hi)
        for c, o in zip(st.feed([s[lo:e] for s in sigs]), outs):
            o.extend(c)
        lo = e
    for c, o in zip(st.flush(), outs):
        o.extend(c)


def test_bank_stream_same_ts(stream_signals):
    sigs, sents = stream_signals
    block = _block(MC_STREAM)
    L = CFG_STREAM.plframe_len
    kw = dict(mc=MC_STREAM, short=True, pilots=True, block_symbols=block,
              ingest="cs4")
    ref = JaxBankStream(C, **kw)
    st = DVBS2BankStream(C, fec="int8", device="cpu", **kw)
    need = 2 * block + 3 * 2 * st.F * L + 2 * L
    assert len(sigs[0]) >= need
    want, got = [bytearray(), bytearray()], [bytearray(), bytearray()]
    _feed(ref, sigs, 0, need, want)
    _feed(st, sigs, 0, need, got)
    assert (st.frames_seen >= 4 * st.F).all()
    assert (st.frames_ok == st.frames_seen).all()
    assert (ref.frames_ok == ref.frames_seen).all()
    for c in range(C):
        assert bytes(got[c]) == bytes(want[c])
        g = np.frombuffer(bytes(got[c]), np.uint8).reshape(-1, 188)
        k0 = sents[c].tobytes().find(g[0].tobytes()) // 188
        np.testing.assert_array_equal(g, sents[c][k0:k0 + len(g)])
        assert len(g) >= 3 * st.F * (CFG_STREAM.kbch // 8 // 188)


@pytest.mark.parametrize("to_pilots", [True, False])
def test_auto_modcod_switch(to_pilots):
    """Every carrier votes for 8PSK 3/4 short while the bank is set to
    8PSK 2/3 with pilots: inside feed the stream rebuilds its bank for
    the voted MODCOD, with pilots or without (the decision-directed
    track), and goes on to decode the 8PSK 3/4 signal it is fed: each
    carrier's TS is a byte-exact contiguous run of its own packets."""
    target = modcod.get_config(14, short=True, pilots=to_pilots)
    sigs, sents = _signals(target, 12.0, 16)
    block = _block(MC_STREAM)
    st = DVBS2BankStream(C, mc=MC_STREAM, short=True, pilots=True,
                         block_symbols=block, fec="int8", ingest="cs4",
                         device="cpu")
    for v in st._votes:
        v.extend([target.pls_code] * v.maxlen)
    got = [bytearray(), bytearray()]
    _feed(st, sigs, 0, len(sigs[0]), got)
    assert st.cfg.pls_code == target.pls_code
    assert st.step_fn.rx.cfg.pls_code == target.pls_code
    assert (st.frames_ok >= 8).all(), (st.frames_ok, st.frames_seen)
    for c in range(C):
        g = np.frombuffer(bytes(got[c]), np.uint8).reshape(-1, 188)
        k0 = sents[c].tobytes().find(g[0].tobytes()) // 188
        np.testing.assert_array_equal(g, sents[c][k0:k0 + len(g)])
        assert len(g) >= 8 * (target.kbch // 8 // 188)
