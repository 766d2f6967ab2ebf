"""The port's own copies of the numpy layers equal the originals.

dvbs_tpu_torch keeps its own spec/, tx/ and io/ (it imports nothing of
dvbs_tpu). One case per copied module runs the copy and the dvbs_tpu
original on the same seeded inputs on the CPU and holds every result
exactly equal: tables, constellation points, the MODCOD configs for
every MODCOD x frame size x pilots, scramblers, BCH / RS / LDPC / CC
encode and decode, the BBFRAME parser and the TS deframer on the same
byte streams, the modulators and the channel on the same seeds, the IQ
file formats and the sinks. The port's signal makers equal bench.py's.
Exact: np.array_equal and == throughout.
"""
import dataclasses
import importlib
import os
import socket

import numpy as np
import pytest

pytest.importorskip("jax")

MODULES = ("spec.bbheader", "spec.bch_spec", "spec.constellations",
           "spec.dvbs_fec", "spec.gf2m", "spec.interleaver",
           "spec.ldpc_spec", "spec.modcod", "spec.plheader", "spec.rs_spec",
           "spec.scrambling", "tx.channel", "tx.dvbs2_mod", "tx.dvbs_mod",
           "tx.gse_mod", "io.bbframe_parser", "io.config", "io.native",
           "io.sink", "io.source", "io.ts_deframer")


def _pair(name):
    return (importlib.import_module("dvbs_tpu." + name),
            importlib.import_module("dvbs_tpu_torch." + name))


def _same(a, b):
    """Exact equality of results of any nesting."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif dataclasses.is_dataclass(a):
        _same(dataclasses.astuple(a), dataclasses.astuple(b))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b


def _all_configs(m):
    for mc in range(1, 29):
        for short in (False, True):
            for pilots in (False, True):
                try:
                    yield m.get_config(mc, short=short, pilots=pilots)
                except (ValueError, KeyError):
                    yield None


def _ts_bbframes(tx, mcfg, seed, n=40):
    cfg = mcfg.get_config(4, short=True)
    pk = tx.random_ts_packets(n, seed=seed)
    return cfg, pk, tx.ts_to_bbframes(pk, cfg)


def check_bbheader(a, b):
    rng = np.random.default_rng(0)
    for k in range(20):
        raw = rng.integers(0, 256, 10).astype(np.uint8)
        ha, hb = a.BBHeader.parse(raw), b.BBHeader.parse(raw)
        _same(ha, hb)
        _same(ha.pack(), hb.pack())
        assert a.validate(ha, 7032) == b.validate(hb, 7032)
        assert a.bbheader_check(ha.pack()) == b.bbheader_check(hb.pack())
        assert a.bbheader_check(raw) == b.bbheader_check(raw)


def check_bch_spec(a, b):
    rng = np.random.default_rng(1)
    for fs, rate in (("short", "1/2"), ("normal", "3/4")):
        _same(a.parity_matrix(fs, rate), b.parity_matrix(fs, rate))
        kbch = a.parity_matrix(fs, rate).shape[0]
        msg = rng.integers(0, 2, (2, kbch)).astype(np.uint8)
        cw = a.encode(msg, fs, rate)
        _same(cw, b.encode(msg, fs, rate))
        bad = cw[0].copy()
        bad[rng.choice(len(bad), 5, replace=False)] ^= 1
        _same(a.syndromes(bad, fs, rate), b.syndromes(bad, fs, rate))
        _same(a.decode(bad, fs, rate), b.decode(bad, fs, rate))
        assert a.decode(bad, fs, rate)[1] == 5


def check_constellations(a, b):
    rng = np.random.default_rng(2)
    for kind in ("qpsk", "8psk", "16apsk", "32apsk"):
        for g in ((None, None), (2.57, 5.27)):
            _same(a.points(kind, *g), b.points(kind, *g))
        m = {"qpsk": 2, "8psk": 3, "16apsk": 4, "32apsk": 5}[kind]
        bits = rng.integers(0, 2, 60 * m).astype(np.uint8)
        _same(a.bits_to_symbols(bits, kind), b.bits_to_symbols(bits, kind))
        sym = a.bits_to_symbols(bits, kind)
        _same(a.symbols_to_bits(sym, kind), b.symbols_to_bits(sym, kind))
        _same(a.modulate(sym, kind), b.modulate(sym, kind))


def check_dvbs_fec(a, b):
    rng = np.random.default_rng(3)
    assert (a.G1, a.G2, a.K_CC, a.RATES) == (b.G1, b.G2, b.K_CC, b.RATES)
    _same(a.PUNCTURE, b.PUNCTURE) if not isinstance(a.PUNCTURE, dict) else \
        [_same(np.asarray(a.PUNCTURE[k]), np.asarray(b.PUNCTURE[k]))
         for k in a.PUNCTURE]
    bits = rng.integers(0, 2, 840).astype(np.uint8)
    xy = a.cc_encode(bits)
    _same(xy, b.cc_encode(bits))
    for rate in a.RATES:
        p = a.puncture(xy, rate)
        _same(p, b.puncture(xy, rate))
        soft = 1.0 - 2.0 * p.astype(np.float32)
        _same(a.depuncture(soft, rate, 1), b.depuncture(soft, rate, 1))
    data = rng.integers(0, 256, 204 * 30).astype(np.uint8)
    ia, ib = a.ConvInterleaver(), b.ConvInterleaver()
    da, db = a.ConvDeinterleaver(), b.ConvDeinterleaver()
    for lo in (0, 204 * 13):
        x = ia.process(data[lo:lo + 204 * 13])
        _same(x, ib.process(data[lo:lo + 204 * 13]))
        _same(da.process(x), db.process(x))


def check_gf2m(a, b):
    rng = np.random.default_rng(4)
    for name in ("gf65536", "gf16384", "gf256"):
        fa, fb = getattr(a, name)(), getattr(b, name)()
        n = (1 << fa.m) - 1
        x = rng.integers(1, n + 1, 50)
        y = rng.integers(1, n + 1, 50)
        for op in ("mul", "div"):
            _same(getattr(fa, op)(x, y), getattr(fb, op)(x, y))
        _same(fa.inv(x), fb.inv(x))
        _same(fa.pow(x, 5), fb.pow(x, 5))
        _same(fa.alpha_pow(np.arange(40)), fb.alpha_pow(np.arange(40)))
        _same(fa.poly_eval(x[:6], y), fb.poly_eval(x[:6], y))
        _same(fa.poly_mul(x[:5], y[:7]), fb.poly_mul(x[:5], y[:7]))
        _same(fa.minimal_polynomial(3), fb.minimal_polynomial(3))


def check_interleaver(a, b):
    assert not hasattr(b, "deinterleave_device")   # ops/interleaver.py is it
    rng = np.random.default_rng(5)
    for kind in ("8psk", "16apsk", "32apsk"):
        for fs, rate, n in (("normal", "3/5", 64800), ("short", "2/3", 16200)):
            _same(a.column_offsets(kind, fs, rate),
                  b.column_offsets(kind, fs, rate))
            _same(a.deinterleave_perm(kind, fs, rate),
                  b.deinterleave_perm(kind, fs, rate))
            _same(a.interleave_perm(kind, fs, rate),
                  b.interleave_perm(kind, fs, rate))
            cw = rng.integers(0, 2, n).astype(np.uint8)
            s = a.interleave_bits(cw, kind, fs, rate)
            _same(s, b.interleave_bits(cw, kind, fs, rate))
            _same(a.deinterleave_llrs(s, kind, fs, rate),
                  b.deinterleave_llrs(s, kind, fs, rate))


def check_ldpc_spec(a, b):
    with open(a._DATA, "rb") as fa, open(b._DATA, "rb") as fb:
        assert fa.read() == fb.read()              # the tables, byte for byte
    assert os.path.dirname(b._DATA).endswith(
        os.path.join("dvbs_tpu_torch", "spec", "data"))
    rng = np.random.default_rng(6)
    for table in ("B4", "B7", "B6", "C4", "C7"):
        ca, cb = a.get_code(table), b.get_code(table)
        assert (ca.N, ca.K, ca.R, ca.q) == (cb.N, cb.K, cb.R, cb.q)
        _same(ca.rows, cb.rows)
        _same(ca.info_addr, cb.info_addr)
        info = rng.integers(0, 2, (2, ca.K)).astype(np.uint8)
        cw = ca.encode(info)
        _same(cw, cb.encode(info))
        cw[0, 5] ^= 1
        _same(ca.check_syndrome(cw[0]), cb.check_syndrome(cw[0]))


def check_modcod(a, b):
    for name in ("RATES", "MOD_BITS", "BCH_PARAMS", "LDPC_TABLE"):
        assert getattr(a, name) == getattr(b, name)
    n = 0
    for ca, cb in zip(_all_configs(a), _all_configs(b)):
        assert (ca is None) == (cb is None)
        if ca is None:
            continue
        n += 1
        _same(ca, cb)
        for prop in ("mod_bits", "pls_code", "pilot_blocks", "plframe_len",
                     "payload_len"):
            assert getattr(ca, prop) == getattr(cb, prop)
        _same(a.from_pls_code(ca.pls_code), b.from_pls_code(cb.pls_code))
        assert a.get_modcod(ca.constellation, ca.rate) == \
            b.get_modcod(cb.constellation, cb.rate)
    assert n >= 100


def check_plheader(a, b):
    for fn in ("sof_bits", "sof_symbols", "pls_codewords", "pls_bit_matrix",
               "pls_symbols", "sof_diff_template", "pls_diff_template",
               "header_diff_templates"):
        _same(getattr(a, fn)(), getattr(b, fn)())
    for code in range(0, 128, 7):
        _same(a.plheader_symbols(code), b.plheader_symbols(code))


def check_rs_spec(a, b):
    rng = np.random.default_rng(7)
    _same(a.generator_poly(), b.generator_poly())
    msg = rng.integers(0, 256, (6, 188)).astype(np.uint8)
    cw = a.encode(msg)
    _same(cw, b.encode(msg))
    cw[1, [3, 50, 99]] ^= 0x5A
    cw[2, :20] ^= 0xFF                                  # uncorrectable
    for row in cw[:4]:
        _same(a.syndromes(row), b.syndromes(row))
        _same(a.decode(row), b.decode(row))
    assert a.decode(cw[1])[1] == 3 and a.decode(cw[2])[1] < 0


def check_scrambling(a, b):
    rng = np.random.default_rng(8)
    for code in (0, 3):
        _same(a.pl_scrambler_sequence(code), b.pl_scrambler_sequence(code))
        _same(a.pl_scrambler_phasors(code), b.pl_scrambler_phasors(code))
    sym = (rng.normal(size=500) + 1j * rng.normal(size=500)).astype(
        np.complex64)
    _same(a.pl_scramble(sym, 7), b.pl_scramble(sym, 7))
    _same(a.pl_descramble(sym, 7), b.pl_descramble(sym, 7))
    _same(a.bb_scrambler_bits(4000), b.bb_scrambler_bits(4000))
    _same(a.bb_scrambler_byte_mask(900), b.bb_scrambler_byte_mask(900))
    data = rng.integers(0, 256, (3, 900)).astype(np.uint8)
    _same(a.bb_scramble_bytes(data), b.bb_scramble_bytes(data))
    _same(a.dvbs_dispersal_mask(), b.dvbs_dispersal_mask())
    pk = rng.integers(0, 256, (8, 188)).astype(np.uint8)
    pk[:, 0] = 0x47
    pk = pk.reshape(-1)
    g = a.dvbs_scramble_group(pk)
    _same(g, b.dvbs_scramble_group(pk))
    _same(a.dvbs_descramble_group(g), b.dvbs_descramble_group(g))


def check_channel(a, b):
    rng = np.random.default_rng(9)
    _same(a.rrc_taps(65, 0.35, 2.0), b.rrc_taps(65, 0.35, 2.0))
    sym = (rng.normal(size=3000) + 1j * rng.normal(size=3000)).astype(
        np.complex64)
    x = a.shape(sym, sps=2)
    _same(x, b.shape(sym, sps=2))
    kw = dict(snr_db=7.0, cfo=0.01, delay_samples=0.3, sco_ppm=10.0, seed=3)
    _same(a.impair(x, **kw), b.impair(x, **kw))


def check_dvbs2_mod(a, b):
    ma, mb = _pair("spec.modcod")
    for mc, short, pilots in ((4, True, False), (13, True, True),
                              (18, True, False), (24, True, True)):
        ca = ma.get_config(mc, short=short, pilots=pilots)
        cb = mb.get_config(mc, short=short, pilots=pilots)
        pk = a.random_ts_packets(60, seed=mc)
        _same(pk, b.random_ts_packets(60, seed=mc))
        bba, bbb = a.ts_to_bbframes(pk, ca), b.ts_to_bbframes(pk, cb)
        _same(bba, bbb)
        pla = a.bbframes_to_plframes(bba, ca)
        _same(pla, b.bbframes_to_plframes(bbb, cb))
        _same(a.pilot_symbol_positions(ca), b.pilot_symbol_positions(cb))
        _same(a.interleave_dummies(pla, 2, n_dummies=2),
              b.interleave_dummies(pla, 2, n_dummies=2))
        _same(a.modulate_ts(pk, ca), b.modulate_ts(pk, cb))
    _same(a.dummy_plframe(), b.dummy_plframe())
    assert a.DUMMY_PLFRAME_LEN == b.DUMMY_PLFRAME_LEN


def check_dvbs_mod(a, b):
    ts = a.random_ts_groups(3, seed=5)
    _same(ts, b.random_ts_groups(3, seed=5))
    for rate in ("1/2", "3/4", "7/8"):
        _same(a.DVBSModulator(rate=rate).ts_to_symbols(ts),
              b.DVBSModulator(rate=rate).ts_to_symbols(ts))


def _gse_packets(g, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        p = rng.integers(1, 256, 300 + 13 * i).astype(np.uint8).tobytes()
        if i % 3 == 0 and len(p) > 400:
            out += g.gse_packets_fragmented(p, frag_id=i % 8, chunk=220)
        else:
            out.append(g.gse_packet_unfrag(p))
    return out


def check_gse_mod(a, b):
    pa, pb = _gse_packets(a, 10), _gse_packets(b, 10)
    assert pa == pb
    _same(a.gse_to_bbframes(pa, 7032), b.gse_to_bbframes(pb, 7032))


def check_bbframe_parser(a, b):
    txa, _ = _pair("tx.dvbs2_mod")
    mca, _ = _pair("spec.modcod")
    ga, _ = _pair("tx.gse_mod")
    cfg, _, bb = _ts_bbframes(txa, mca, 11)
    sa, _ = _pair("spec.scrambling")
    gse = sa.bb_scramble_bytes(ga.gse_to_bbframes(_gse_packets(ga, 12),
                                                  cfg.kbch))
    assert a.crc32_checksum(bb[0], 0xFFFFFFFF) == \
        b.crc32_checksum(bb[0], 0xFFFFFFFF)
    for frames in (sa.bb_scramble_bytes(bb), gse):     # descrambled
        pa, pb = a.BBFrameParser(cfg.kbch), b.BBFrameParser(cfg.kbch)
        pa.synched = pb.synched = True      # steady state
        half = len(frames) // 2
        head = pa.feed(frames[:half])
        assert head == pb.feed(frames[:half])
        pa.mark_gap()
        pb.mark_gap()
        _same(pa.get_state(), pb.get_state())
        # a state of one restores the other
        qb = b.BBFrameParser(cfg.kbch)
        qb.set_state(pa.get_state())
        want = pa.feed(frames[half + 1:])
        assert want == pb.feed(frames[half + 1:]) == qb.feed(frames[half + 1:])
        assert len(head) + len(want) > 0
        _same(pa.last_header, pb.last_header)


def check_config(a, b, tmp_path):
    assert a.DEFAULTS == b.DEFAULTS
    ca = a.Config(str(tmp_path / "a.json"))
    cb = b.Config(str(tmp_path / "b.json"))
    for c in (ca, cb):
        c["dvbs2_pilots"] = True
        c["dvbs2_coderate"] = "3/4"
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert b.Config(str(tmp_path / "a.json"))["dvbs2_coderate"] == "3/4"
    assert b.Config(autosave=False)["dvbs2_pilots"] == \
        a.Config(autosave=False)["dvbs2_pilots"]


def check_native(a, b):
    """Both bind the one native/libdvbs_native.so at the root of the
    checkout, and (when it is built) parse alike."""
    assert os.path.realpath(a._SO) == os.path.realpath(b._SO)
    assert a.available() == b.available()
    if not a.available():
        return
    txa, _ = _pair("tx.dvbs2_mod")
    mca, _ = _pair("spec.modcod")
    cfg, _, bb = _ts_bbframes(txa, mca, 13)
    pa, pb = a.NativeTSParser(cfg.kbch), b.NativeTSParser(cfg.kbch)
    sa, _ = _pair("spec.scrambling")
    bb = sa.bb_scramble_bytes(bb)                       # descrambled
    head = pa.feed(bb[:4])
    assert head == pb.feed(bb[:4]) and len(head) > 0
    assert pa.get_state() == pb.get_state()
    assert pa.feed(bb[4:]) == pb.feed(bb[4:])
    dm, _ = _pair("tx.dvbs_mod")
    fec, _ = _pair("spec.dvbs_fec")
    bits = _framed_bits(dm)
    da, db = a.NativeTSDeframer(), b.NativeTSDeframer()
    _same(da.feed(bits), db.feed(bits))
    ta, tb = a.NativeDVBSTail(), b.NativeDVBSTail()
    _same(ta.feed(bits), tb.feed(bits))


def _framed_bits(dm, n_groups=4, seed=14):
    """The interleaved, RS-coded byte stream of n_groups TS groups, as
    bits (what the DVB-S host tail reads after the Viterbi decoder)."""
    from dvbs_tpu.spec import dvbs_fec, rs_spec, scrambling
    ts = dm.random_ts_groups(n_groups, seed=seed).reshape(-1, 8 * 188)
    coded = np.concatenate([rs_spec.encode(
        scrambling.dvbs_scramble_group(g).reshape(8, 188)) for g in ts])
    return np.unpackbits(dvbs_fec.ConvInterleaver().process(
        coded.reshape(-1)))


def check_sink(a, b, tmp_path):
    data = bytes(range(256)) * 30
    for m, name in ((a, "a.ts"), (b, "b.ts")):
        s = m.FileSink(str(tmp_path / name))
        s.send_raw(data[:1000])
        s.send_raw(data[1000:])
        s.close()
    assert (tmp_path / "a.ts").read_bytes() == \
        (tmp_path / "b.ts").read_bytes() == data
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    port = rx.getsockname()[1]
    got = []
    for m in (a, b):
        s = m.UDPSink("127.0.0.1", port)
        s.send_ts_chunked(data[:188 * 25])     # 2 datagrams, 940 B kept
        s.send_ts_chunked(data[188 * 25:188 * 30])
        s.send_raw(b"tail")
        s.close()
        got.append([rx.recv(65536) for _ in range(4)])
    rx.close()
    assert got[0] == got[1]
    assert b"".join(got[0]) == data[:188 * 30] + b"tail"


def check_source(a, b, tmp_path):
    rng = np.random.default_rng(15)
    x = (0.3 * (rng.normal(size=999) + 1j * rng.normal(size=999))).astype(
        np.complex64)
    pa, pb = str(tmp_path / "a.cf32"), str(tmp_path / "b.cf32")
    a.write_iq_file(pa, x, "cf32")
    b.write_iq_file(pb, x, "cf32")
    assert open(pa, "rb").read() == open(pb, "rb").read()
    for m in (a, b):
        with pytest.raises(ValueError):
            m.write_iq_file(pa + "x", x, "cs16")
    raw = rng.integers(0, 256, 4000).astype(np.uint8).tobytes()
    (tmp_path / "raw.bin").write_bytes(raw)
    for fmt in ("cf32", "cs16", "cs8", "cu8"):
        if fmt == "cf32":
            path, data = pa, open(pa, "rb").read()
        else:
            path, data = str(tmp_path / "raw.bin"), raw
        _same(a.read_iq_file(path, fmt), b.read_iq_file(path, fmt))
        _same(a.read_iq_file(path, fmt, count=100),
              b.read_iq_file(path, fmt, count=100))
        _same(a.decode_iq_bytes(data, fmt), b.decode_iq_bytes(data, fmt))


def check_ts_deframer(a, b):
    dm, _ = _pair("tx.dvbs_mod")
    bits = _framed_bits(dm)
    bits = np.concatenate([np.zeros(37, np.uint8), bits])   # off the grid
    da, db = a.TSDeframer(), b.TSDeframer()
    cut = len(bits) // 2 + 11
    _same(da.feed(bits[:cut]), db.feed(bits[:cut]))
    assert da.get_state() == db.get_state()
    qb = b.TSDeframer()
    qb.set_state(da.get_state())
    want = da.feed(bits[cut:])
    _same(want, db.feed(bits[cut:]))
    _same(want, qb.feed(bits[cut:]))
    assert len(want) > 0


@pytest.mark.parametrize("name", MODULES)
def test_copy_equals_original(name, tmp_path):
    a, b = _pair(name)
    assert a.__file__ != b.__file__
    check = globals()["check_" + name.split(".")[1]]
    if "tmp_path" in check.__code__.co_varnames[:check.__code__.co_argcount]:
        check(a, b, tmp_path)
    else:
        check(a, b)


@pytest.mark.parametrize("payload", ["ts", "gse"])
def test_signal_makers_equal_bench(payload):
    """tx/signals.py makes the bytes that bench.py's makers make."""
    import bench
    from dvbs_tpu.spec import modcod as jm
    from dvbs_tpu_torch.spec import modcod as tm
    from dvbs_tpu_torch.tx import signals
    args = (40, 10, 0.008 * np.pi, 0.2)
    ya, sa = bench.s2_carrier_signal(jm.get_config(4, short=True), *args,
                                     payload=payload, snr_db=5.0)
    yb, sb = signals.s2_carrier_signal(tm.get_config(4, short=True), *args,
                                       payload=payload, snr_db=5.0)
    _same(ya, yb)
    _same(sa, sb)
    if payload == "ts":
        n = signals.contiguous_packets(sa[3:9].tobytes(), sb, "x")
        assert n == bench.contiguous_packets(sa[3:9].tobytes(), sa, "x") == 6
        with pytest.raises(AssertionError):
            signals.contiguous_packets(sa[[3, 5]].tobytes(), sb, "x")


def test_dvbs_signal_equals_bench_recipe():
    """tx/signals.dvbs_carrier_signal: bench.py's DVB-S recipe (seeds
    40 + c and 50 + c, 8 dB, 10 ppm) on dvbs_tpu's modulator."""
    from dvbs_tpu.tx import channel, dvbs_mod
    from dvbs_tpu_torch.tx import signals
    c, need = 2, 60000
    y, sent = signals.dvbs_carrier_signal(c, need)
    n_groups = -(-need // (16 * 1632)) + 2
    ts = dvbs_mod.random_ts_groups(n_groups, seed=40 + c)
    tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
    want = channel.impair(channel.shape(tx, sps=2), snr_db=8.0,
                          cfo=(0.004 + 0.002 * c) * np.pi,
                          delay_samples=0.2 + 0.1 * c, sco_ppm=10.0,
                          seed=50 + c)[:need]
    _same(y, want)
    _same(sent, ts.reshape(-1, 188))
