"""Seamless periodic captures of DVB-S2 carriers, made from a seed.

Each carrier is one period of an exactly periodic received signal, fed
round and round, so that a window of any length has no seam:

- the payload is the smallest whole number of BBFRAMEs that holds a
  whole number of TS packets at the maximum DFL (Kbch - 80 bits), so the
  period starts and ends on a packet and on a frame boundary, and the
  CRC-8 chain of mode adaptation runs round the period;
- the symbols are RRC-shaped circularly;
- the sample clock slips a whole number of samples each period, the
  carrier offset turns a whole number of times each period, and the
  noise is drawn once for the period;
- the period is packed to cs4 (1 byte a sample) with one scale.

Sample j of the endless stream is `capture[j % P]`; it holds the
transmitted 2-sps signal at position `j * ratio + delay`, where
`ratio = 2 * symbols / P`. The transmitter is the frozen copy in
`txref/`; nothing of the program under test is imported.

Run as a worker: `python -m rxbench.capture CONFIG.json CARRIER SEED OUT.npz`
writes one carrier's period and its transmitter record to OUT.npz.
"""
from __future__ import annotations

import json
import math
import sys

import numpy as np

from .txref import (bbheader, bch_spec, channel, constellations, dvbs2_mod,
                    interleaver, ldpc_spec, modcod, scrambling)

TS = bbheader.TS_SIZE          # 188
RESAMPLE_CHUNK = 1 << 18


def modcod_config(conf: dict) -> modcod.ModcodConfig:
    return modcod.get_config(conf["modcod"], short=conf["framesize"] == "short",
                             pilots=conf["pilots"])


def period_geometry(cfg: modcod.ModcodConfig) -> dict:
    """Frames and packets of one period: the least whole number of
    BBFRAMEs of DFL = kbch - 80 bits that holds whole TS packets."""
    dfb = (cfg.kbch - 80) // 8
    g = math.gcd(dfb, TS)
    frames = TS // g
    return dict(frames=frames, packets=dfb // g, dfb=dfb,
                symbols=frames * cfg.plframe_len)


def carrier_params(conf: dict, c: int, seed: int) -> dict:
    """The seeded impairments of carrier c: the fractional delay and the
    payload and noise generators' seeds come from `seed`; the clock slip
    and the carrier offset from the configuration."""
    cfg = modcod_config(conf)
    geo = period_geometry(cfg)
    n_tx = 2 * geo["symbols"]                     # 2-sps samples sent
    P = n_tx - int(conf["clock_slip_samples"])    # samples received
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1000 + c]))
    delay = float(rng.uniform(0.1, 0.9))
    cfo = (conf["cfo_pi_base"] + conf["cfo_pi_step"] * c) * np.pi
    turns = int(round(cfo * P / (2 * np.pi)))
    return dict(P=P, n_tx=n_tx, ratio=n_tx / P, delay=delay, turns=turns,
                payload_seed=[int(seed), 2000 + c],
                noise_seed=[int(seed), 3000 + c])


def crc8_units(pkts: np.ndarray) -> np.ndarray:
    """CRC-8 (poly 0xAB, bit-serial as dvbs2_mod._crc8_187) of each
    packet's 187 payload bytes, all packets at once. pkts [n, 188]."""
    bits = np.unpackbits(pkts[:, 1:], axis=1)
    crc = np.zeros(len(pkts), np.int64)
    for k in range(bits.shape[1]):
        b = bits[:, k].astype(np.int64) ^ (crc & 1)
        crc = (crc >> 1) ^ (0xAB * b)
    return crc.astype(np.uint8)


def periodic_bbframes(pkts: np.ndarray, cfg: modcod.ModcodConfig) -> np.ndarray:
    """Mode adaptation of one period of packets, round the period: unit
    i's sync byte carries the CRC-8 of packet i - 1 (packet n - 1 for the
    first). Returns the plain (not BB-scrambled) BBFRAMEs
    [frames, kbch/8]."""
    geo = period_geometry(cfg)
    assert len(pkts) == geo["packets"]
    units = pkts.copy()
    units[:, 0] = np.roll(crc8_units(pkts), 1)
    stream = units.reshape(-1)
    dfb = geo["dfb"]
    frames = np.zeros((geo["frames"], cfg.kbch // 8), np.uint8)
    for f in range(geo["frames"]):
        syncd = (-(f * dfb)) % TS
        frames[f, :10] = bbheader.BBHeader(dfl=dfb * 8, syncd=syncd * 8).pack()
        frames[f, 10:] = stream[f * dfb:(f + 1) * dfb]
    return frames


def encode_frames(plain: np.ndarray, cfg: modcod.ModcodConfig):
    """BB-scramble, BCH and LDPC encode, interleave, map and PL-frame.
    Returns (codewords [n, nldpc] uint8, plframes [n, L] complex64)."""
    bits = np.unpackbits(scrambling.bb_scramble_bytes(plain), axis=1)
    M = bch_spec.parity_matrix(cfg.framesize, cfg.rate).astype(np.float32)
    # sums of at most kbch < 2**24 ones: exact in float32
    par = np.mod(bits.astype(np.float32) @ M, 2).astype(np.uint8)
    cw = ldpc_spec.get_code(cfg.ldpc_table).encode(
        np.concatenate([bits, par], axis=1))
    frames = np.empty((len(plain), cfg.plframe_len), np.complex64)
    for i in range(len(plain)):
        stream = interleaver.interleave_bits(cw[i], cfg.constellation,
                                             cfg.framesize, cfg.rate)
        syms = constellations.bits_to_symbols(stream, cfg.constellation)
        payload = constellations.modulate(syms, cfg.constellation,
                                          cfg.g1, cfg.g2)
        frames[i] = dvbs2_mod.assemble_plframe(payload, cfg)
    return cw, frames


def shape_circular(symbols: np.ndarray, sps: int, alpha: float,
                   ntaps: int) -> np.ndarray:
    """channel.shape on a periodic symbol sequence: upsample and RRC
    filter circularly, sample k * sps on symbol k, unit average power."""
    n = len(symbols) * sps
    up = np.zeros(n, np.complex64)
    up[::sps] = symbols
    h = channel.rrc_taps(ntaps, alpha, sps)
    d = ntaps // 2
    x = np.convolve(np.concatenate([up[-d:], up, up[:d]]), h, mode="valid")
    x /= np.sqrt(np.mean(np.abs(x) ** 2))
    return x.astype(np.complex64)


PHASES = 8192                  # interpolator phases: mu to 1/8192 sample


def interp_table() -> np.ndarray:
    """channel.impair's 16-tap windowed-sinc interpolator at PHASES + 1
    fractional positions mu in [0, 1], taps normalised: [PHASES + 1, 16]."""
    k = np.arange(-7, 9)[None, :]
    mu = (np.arange(PHASES + 1) / PHASES)[:, None]
    w = 0.54 + 0.46 * np.cos(np.pi * (k - mu) / 8)
    taps = np.sinc(k - mu) * np.where(np.abs(k - mu) <= 8, w, 0)
    return (taps / taps.sum(axis=1, keepdims=True)).astype(np.float32)


def resample_circular(x: np.ndarray, P: int, delay: float) -> np.ndarray:
    """y[j] = x(j * len(x) / P + delay) for j < P, x read circularly, by
    channel.impair's windowed-sinc interpolator round the period (mu
    rounded to 1/PHASES of a sample: a timing jitter far under the
    noise)."""
    N = len(x)
    ratio = N / P
    table = interp_table()
    k = np.arange(-7, 9)[None, :]
    out = np.empty(P, np.complex64)
    for a in range(0, P, RESAMPLE_CHUNK):
        t = np.arange(a, min(P, a + RESAMPLE_CHUNK)) * ratio + delay
        i0 = np.floor(t).astype(np.int64)
        ph = np.rint((t - i0) * PHASES).astype(np.int64)
        idx = (i0[:, None] + k) % N
        taps = table[ph]
        out[a:a + len(t)] = (np.einsum("nk,nk->n", x.real[idx], taps)
                             + 1j * np.einsum("nk,nk->n", x.imag[idx], taps))
    return out


def pack_cs4(y: np.ndarray, scale: float) -> np.ndarray:
    """4-bit I (high nibble) and Q (low nibble) at `scale` / rms, one
    scale for the whole period, as a cs4 source delivers it."""
    rms = np.sqrt(np.mean(np.abs(y) ** 2)) + 1e-30
    q = np.clip(np.round(np.stack([y.real, y.imag]) * (scale / rms)),
                -7, 7).astype(np.int64)
    return (((q[0] & 15) << 4) | (q[1] & 15)).astype(np.uint8)


def carrier_signal(conf: dict, c: int, seed: int) -> tuple:
    """One carrier's period before packing: (y [P] complex64, record),
    the record holding packets [n_pkts, 188], plain BBFRAMEs
    [frames, kbch/8], codewords packed [frames, nldpc/8] and the timing
    parameters."""
    cfg = modcod_config(conf)
    prm = carrier_params(conf, c, seed)
    geo = period_geometry(cfg)
    rng = np.random.default_rng(np.random.SeedSequence(prm["payload_seed"]))
    pkts = rng.integers(0, 256, (geo["packets"], TS), dtype=np.uint8)
    pkts[:, 0] = bbheader.TS_SYNC
    plain = periodic_bbframes(pkts, cfg)
    cw, frames = encode_frames(plain, cfg)
    x = shape_circular(frames.reshape(-1), 2, conf["rrc_alpha"],
                       conf["rrc_taps"])
    P = prm["P"]
    y = resample_circular(x, P, prm["delay"])
    y *= np.exp(2j * np.pi * prm["turns"] * (np.arange(P) / P)
                ).astype(np.complex64)
    y += period_noise(conf, prm["noise_seed"], P)
    return y, dict(packets=pkts, bbframes=plain,
                   codewords=np.packbits(cw, axis=1), P=P,
                   ratio=prm["ratio"], delay=prm["delay"], turns=prm["turns"])


def period_noise(conf: dict, noise_seed: list, P: int) -> np.ndarray:
    """The period's complex Gaussian noise at the configuration's Es/N0
    per sample (unit signal power)."""
    rng = np.random.default_rng(np.random.SeedSequence(noise_seed))
    sigma = np.sqrt(10 ** (-conf["es_n0_db"] / 10) / 2)
    return (rng.normal(0, sigma, P) + 1j * rng.normal(0, sigma, P)
            ).astype(np.complex64)


def make_carrier(conf: dict, c: int, seed: int) -> dict:
    """carrier_signal's record with the period packed to cs4 (`capture`,
    [P] uint8)."""
    y, rec = carrier_signal(conf, c, seed)
    rec["capture"] = pack_cs4(y, conf["cs4_scale"])
    return rec


def main(argv: list) -> int:
    conf_path, c, seed, out = argv
    with open(conf_path) as f:
        conf = json.load(f)
    np.savez(out, **make_carrier(conf, int(c), int(seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
