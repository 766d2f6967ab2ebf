"""The periodic capture: its period, its mode adaptation, and its
continuity across the wrap."""
from __future__ import annotations

import numpy as np

from rxbench import capture
from rxbench.txref import channel, dvbs2_mod, scrambling

from conftest import tiny_config


def test_period_geometry():
    q = capture.period_geometry(capture.modcod_config(
        dict(modcod=4, framesize="normal", pilots=False)))
    a = capture.period_geometry(capture.modcod_config(
        dict(modcod=24, framesize="normal", pilots=True)))
    assert (q["frames"], q["packets"], q["symbols"]) == (47, 1004, 1527030)
    assert (a["frames"], a["packets"], a["symbols"]) == (188, 6041, 2507544)
    for g in (q, a):
        assert g["frames"] * g["dfb"] == g["packets"] * 188


def test_periodic_bbframes_match_the_modulator():
    """The vectorised CRC chain and framing equal the frozen modulator's
    mode adaptation, with the CRC of the period's last packet carried
    into its first."""
    cfg = capture.modcod_config(dict(modcod=4, framesize="normal",
                                     pilots=False))
    rng = np.random.default_rng(5)
    pkts = rng.integers(0, 256, (1004, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    st = dvbs2_mod.TSStreamState()
    st.last_crc = dvbs2_mod._crc8_187(pkts[-1, 1:])
    ref = dvbs2_mod.ts_to_bbframes(pkts.reshape(-1), cfg, st)
    assert len(st.pending) == 0
    got = scrambling.bb_scramble_bytes(capture.periodic_bbframes(pkts, cfg))
    assert np.array_equal(got, ref)


def two_periods_in_one_piece(conf, c, seed):
    """The carrier made straight, over two periods in one piece: the
    symbol stream repeated, shaped by channel.shape (no wrap; four periods, the middle two used), resampled
    by channel.impair's exact interpolator, mixed and given the period's
    noise, with nothing read circularly inside the two periods."""
    cfg = capture.modcod_config(conf)
    prm = capture.carrier_params(conf, c, seed)
    rng = np.random.default_rng(np.random.SeedSequence(prm["payload_seed"]))
    geo = capture.period_geometry(cfg)
    pkts = rng.integers(0, 256, (geo["packets"], 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    _, frames = capture.encode_frames(capture.periodic_bbframes(pkts, cfg),
                                      cfg)
    sym = frames.reshape(-1)
    N, P = prm["n_tx"], prm["P"]
    x3 = channel.shape(np.tile(sym, 4), sps=2, alpha=conf["rrc_alpha"],
                       ntaps=conf["rrc_taps"])
    j = np.arange(2 * P)
    t = N + j * prm["ratio"] + prm["delay"]
    i0 = np.floor(t).astype(np.int64)
    k = np.arange(-7, 9)[None, :]
    mu = (t - i0)[:, None]
    w = 0.54 + 0.46 * np.cos(np.pi * (k - mu) / 8)
    taps = np.sinc(k - mu) * np.where(np.abs(k - mu) <= 8, w, 0)
    taps /= taps.sum(axis=1, keepdims=True)
    y = (x3[i0[:, None] + k] * taps).sum(axis=1)
    y = y * np.exp(2j * np.pi * prm["turns"] * j / P)
    return y + np.tile(capture.period_noise(conf, prm["noise_seed"], P), 2)


def test_capture_is_continuous_across_its_wrap():
    conf = tiny_config()
    y, rec = capture.carrier_signal(conf, 1, 2**31 + 99)
    straight = two_periods_in_one_piece(conf, 1, 2**31 + 99)
    rms = np.sqrt(np.mean(np.abs(y) ** 2))
    # the shaping's power normalisation over one period or three, and the
    # interpolator's phase table (1/8192 sample), differ from the straight
    # path by far less than the noise (sigma 0.4 at 5 dB)
    assert np.max(np.abs(np.tile(y, 2) - straight)) / rms < 2e-3
    # and the period is exact: one period after the wrap repeats the first
    assert rec["P"] * rec["ratio"] == 2 * capture.period_geometry(
        capture.modcod_config(conf))["symbols"]
