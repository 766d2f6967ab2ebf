"""Seeded test signals and the TS contiguity check (numpy only).

The continuous impaired streams that bench.py of the JAX package feeds
its gates (`s2_carrier_signal`, and the DVB-S stream of `bench_dvbs`),
kept here with the same seeds and parameters so that the port's smoke
run judges its gates on the same bytes, plus `contiguous_packets`, the
byte-exact contiguity standard those gates apply to the output.
"""
from __future__ import annotations

import numpy as np

from . import channel, dvbs2_mod, dvbs_mod, gse_mod


def contiguous_packets(got: bytes, sent: np.ndarray, label: str) -> int:
    """got must be one byte-exact contiguous run of sent's packets;
    returns the number of packets."""
    g = np.frombuffer(got, np.uint8)
    assert len(g) >= 188 and len(g) % 188 == 0, \
        f"{label}: no/ragged TS output ({len(g)} B)"
    gp = g.reshape(-1, 188)
    i0 = sent.tobytes().find(gp[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0, f"{label}: first packet not in TX"
    k0 = i0 // 188
    assert k0 + len(gp) <= len(sent), f"{label}: output beyond TX tail"
    assert np.array_equal(gp, sent[k0:k0 + len(gp)]), \
        f"{label}: output is not a contiguous run of the TX packets"
    return len(gp)


def s2_carrier_signal(cfg, n_pkts, seed, cfo, delay, payload="ts",
                      snr_db=5.0):
    """Distinct continuous impaired DVB-S2 stream (2 samples/symbol,
    10 ppm clock offset) and its TX packet record."""
    if payload == "ts":
        pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=seed)
        bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
        sent = pkts.reshape(-1, 188)
    else:
        rng = np.random.default_rng(seed)
        pdus = [rng.integers(1, 256, 300 + 13 * i).astype(np.uint8).tobytes()
                for i in range(n_pkts)]
        gp = []
        for i, p in enumerate(pdus):
            if i % 3 == 0 and len(p) > 400:
                gp += gse_mod.gse_packets_fragmented(p, frag_id=i % 8,
                                                     chunk=220)
            else:
                gp.append(gse_mod.gse_packet_unfrag(p))
        bb = gse_mod.gse_to_bbframes(gp, cfg.kbch)
        sent = pdus
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    y = channel.impair(x, snr_db=snr_db, cfo=cfo, delay_samples=delay,
                       sco_ppm=10.0, seed=seed + 1)
    return y, sent


def dvbs_carrier_signal(c: int, need: int):
    """Carrier c of the DVB-S bank's signals: a seam-free rate-1/2
    stream at 8 dB of `need` samples at 2 samples/symbol, and its TS
    packets [n, 188]."""
    # 16 samples per framed byte; a group is 8 x 204 framed bytes
    n_groups = -(-need // (16 * 1632)) + 2
    ts = dvbs_mod.random_ts_groups(n_groups, seed=40 + c)
    tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=8.0,
                       cfo=(0.004 + 0.002 * c) * np.pi,
                       delay_samples=0.2 + 0.1 * c, sco_ppm=10.0,
                       seed=50 + c)
    assert len(y) >= need, (len(y), need)
    return y[:need], ts.reshape(-1, 188)
