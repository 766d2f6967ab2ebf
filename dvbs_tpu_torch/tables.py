"""Every constant table of the receive path, built in numpy.

The JAX package builds these tables inside modules that import jax, so
the port derives them again here from its own numpy layers (`spec/`,
`tx/`). This module is the port's counterpart
of carried-over weights: `receiver_tables` gathers what one receiver
geometry needs into a dict of numpy arrays, and `to_torch` turns such a
dict into tensors on a device. tests/test_torch_tables.py (and
tests/test_torch_viterbi.py for the trellis) holds each builder equal to
its JAX counterpart.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .spec import (bch_spec, constellations, dvbs_fec, ldpc_spec,
                           modcod, plheader, scrambling)
from .tx import channel, dvbs2_mod

LANES = 360                # QC circulant size of every DVB-S2 LDPC code

FIR_BLK = 256              # frontend._FIR_BLK
CORR_BLK = 512             # plsync._CORR_BLK
RRC_NTAPS, RRC_ALPHA, RRC_SPS = 65, 0.35, 2.0

FARROW_TAPS = 10           # frontend._FARROW_TAPS
FARROW_DEG = 9             # frontend._FARROW_DEG
FARROW_LO, FARROW_HI = 3.3, 4.7
TILE_SYM = 256             # frontend._TILE_SYM
SHIFT_BITS = 10            # frontend._SHIFT_BITS
MAX_SCO = 250e-6           # frontend._MAX_SCO

F_VALID = 1                # ldpc_pallas.F_VALID
F_MASK0 = 2                # ldpc_pallas.F_MASK0
F_SYNC = 4                 # the port's own, both: see kernel_tables
F_BAR = 8

# (sample_scale, point_scale, llr_scale) per constellation (demap._SCALES)
DEMAP_SCALES = {
    modcod.QPSK: (3.0, 2.0, 50.0),
    modcod.PSK8: (1.0, 1.0, 50.0),
    modcod.APSK16: (53.0, 50.0, 1.0),
    modcod.APSK32: (54.0, 50.0, 1.0),
}


# ---------------------------------------------------------------------------
# front end (frontend.py)
# ---------------------------------------------------------------------------

def rrc_taps() -> np.ndarray:
    """The matched filter's taps (frontend.matched_filter defaults)."""
    return np.asarray(channel.rrc_taps(RRC_NTAPS, RRC_ALPHA, RRC_SPS),
                      np.float32)


@functools.lru_cache()
def fir_matrix(taps_key: tuple, blk: int = FIR_BLK) -> np.ndarray:
    """Banded FIR matrix T [blk+K-1, blk], T[j, col] = taps[j-col]
    (frontend._fir_matrix)."""
    taps = np.asarray(taps_key, np.float32)
    K = len(taps)
    T = np.zeros((blk + K - 1, blk), np.float32)
    for col in range(blk):
        T[col:col + K, col] = taps
    return T


@functools.lru_cache()
def mid_taps(n: int = 24) -> np.ndarray:
    """Half-sample-offset interpolator (frontend._mid_taps)."""
    u = np.arange(n) - n // 2
    t = u - 0.5
    w = 0.54 + 0.46 * np.cos(np.pi * t / (n / 2))
    h = np.sinc(t) * np.where(np.abs(t) <= n / 2, w, 0.0)
    return (h / h.sum()).astype(np.float32)


def shift_bits_for(n_symbols: int) -> int:
    """Integer-shift range of the resampler (frontend._shift_bits_for)."""
    need = int(2 * (1.5 + n_symbols * MAX_SCO)) + 8
    return max(6, min(SHIFT_BITS, need.bit_length() + 1))


@functools.lru_cache()
def farrow_coeffs(n_taps: int = 8):
    """Per-candidate polynomial fit of the normalised windowed sinc
    (frontend._farrow_coeffs): ([TAPS, DEG+1] float32 highest power
    first, mid, half)."""
    d = np.linspace(FARROW_LO, FARROW_HI, 1024)
    half_sup = n_taps / 2.0
    vals = np.zeros((len(d), FARROW_TAPS))
    for ci in range(FARROW_TAPS):
        u = d - ci
        wnd = 0.54 + 0.46 * np.cos(np.pi * u / half_sup)
        vals[:, ci] = np.sinc(u) * np.where(np.abs(u) <= half_sup, wnd, 0.0)
    vals /= vals.sum(axis=1, keepdims=True)
    mid = (FARROW_LO + FARROW_HI) / 2.0
    halfr = (FARROW_HI - FARROW_LO) / 2.0
    un = (d - mid) / halfr
    V = np.vander(un, FARROW_DEG + 1)
    coef, *_ = np.linalg.lstsq(V, vals, rcond=None)
    err = np.abs(V @ coef - vals).max()
    assert err < 1e-3, f"farrow fit residual {err}"
    return np.ascontiguousarray(coef.T, np.float32), mid, halfr


# ---------------------------------------------------------------------------
# PL sync, header, phase (plsync.py, plhdr.py, plphase.py)
# ---------------------------------------------------------------------------

def corr_templates():
    """(sof_t, pls_t) differential header templates (plsync._templates)."""
    return plheader.header_diff_templates()


def corr_blk(n_symbols: int) -> int:
    """The correlation block plsync.correlate picks for n symbols."""
    return min(CORR_BLK, max(128, n_symbols - 89))


@functools.lru_cache()
def template_matrix(blk: int) -> np.ndarray:
    """T [blk+89, 2*blk], T[j, 2*col+t] = temp_t[j-col]
    (plsync._template_matrix)."""
    sof_t, pls_t = corr_templates()
    T = np.zeros((blk + 89, 2 * blk), np.float32)
    for col in range(blk):
        T[col:col + 90, 2 * col] = sof_t
        T[col:col + 90, 2 * col + 1] = pls_t
    return T


def pls_sym_matrix() -> np.ndarray:
    """[128, 64] complex64 pi/2-BPSK symbols per PLS code
    (plhdr._pls_sym_matrix)."""
    return plheader.pls_symbols()


def header_syms(pls_code: int) -> np.ndarray:
    """The 90 PLHEADER symbols of a PLS code (plphase._header_syms)."""
    return plheader.plheader_symbols(pls_code)


def payload_descramble_phasors(n: int) -> np.ndarray:
    """conj(PL scrambler phasors) for n payload symbols
    (plphase._payload_descramble_phasors)."""
    return np.conj(scrambling.pl_scrambler_phasors()[:n])


def payload_indices(cfg: modcod.ModcodConfig) -> np.ndarray:
    """Frame-relative indices of the payload symbols, pilots stripped
    (plphase.payload_indices)."""
    n_after = cfg.plframe_len - 90
    is_pilot = np.zeros(n_after, bool)
    for p in dvbs2_mod.pilot_symbol_positions(cfg):
        is_pilot[p - 90:p - 90 + 36] = True
    return (np.nonzero(~is_pilot)[0] + 90).astype(np.int32)


def pilot_starts(cfg: modcod.ModcodConfig) -> np.ndarray:
    """Frame-relative start of each 36-symbol pilot block, int32, empty
    without pilots (plphase.pilot_starts)."""
    return dvbs2_mod.pilot_symbol_positions(cfg).astype(np.int32)


PILOT_SYMBOL = (1 + 1j) / np.sqrt(2)     # every pilot symbol, before PL scrambling


def pilot_descramble_phasors(cfg: modcod.ModcodConfig) -> np.ndarray:
    """[n_p, 36] complex64: the PL descramble phasors of each pilot block
    times conj(PILOT_SYMBOL), so that a received pilot block times this
    is the carrier phasor alone (plphase.pilot_anchor_phases' dphs and
    the pilot segments of coarse_fed_common and lr_freq_common)."""
    descr = payload_descramble_phasors(cfg.plframe_len - 90)
    return (np.stack([descr[p - 90:p - 90 + 36] for p in pilot_starts(cfg)])
            * np.conj(PILOT_SYMBOL)).astype(np.complex64)


# ---------------------------------------------------------------------------
# demap, BCH, LDPC (demap.py, bch.py, ldpc_qc.py, ldpc_pallas.py)
# ---------------------------------------------------------------------------

def demap_tables(kind: str, g1: float | None, g2: float | None):
    """(points complex64 [S], mask0 bool [m, S]) with mask0[k, s] true
    when standard bit y_k of symbol s is 0 (demap._tables)."""
    pts = constellations.points(kind, g1, g2).astype(np.complex64)
    m = modcod.MOD_BITS[kind]
    S = len(pts)
    mask0 = np.zeros((m, S), bool)
    for s in range(S):
        for k in range(m):
            mask0[k, s] = ((s >> (m - 1 - k)) & 1) == 0
    return pts, mask0


@functools.lru_cache()
def bch_syndrome_matrix(framesize: str, rate: str) -> np.ndarray:
    """[nbch, 2t*m] uint8 GF(2) syndrome matrix (bch.syndrome_matrix)."""
    kbch, nbch, t = modcod.BCH_PARAMS[(framesize, rate)]
    gf = bch_spec.field_for(framesize)
    m = gf.m
    powers = (nbch - 1 - np.arange(nbch)).astype(np.int64)
    cols = []
    for j in range(1, 2 * t + 1):
        vals = gf.alpha_pow(j * powers)
        cols.append(((vals[:, None] >> np.arange(m)[None, :]) & 1
                     ).astype(np.uint8))
    return np.concatenate(cols, axis=1)


@functools.lru_cache()
def qc_tables(table: str) -> dict:
    """QC structure of an LDPC code (ldpc_qc.qc_tables): G, q, per-layer
    (group, shift) info entries, and the POST-layout permutation."""
    code = ldpc_spec.get_code(table)
    q = code.q
    G = code.K // LANES
    layers = [[] for _ in range(q)]
    for g in range(G):
        row = code.rows[g]
        for x in row[row >= 0]:
            layers[int(x) % q].append((g, int(x) // q))
    perm = np.empty(code.N, np.int64)
    perm[:code.K] = np.arange(code.K)
    a = np.arange(code.R)
    perm[code.K:] = (G + (a % q)) * LANES + (a // q)
    return dict(G=G, q=q, layers=layers, perm=perm.astype(np.int32),
                N=code.N, K=code.K)


@functools.lru_cache()
def kernel_tables(table: str) -> dict:
    """Layer schedule of the int8 decoder, natural orientation
    (ldpc_pallas.kernel_tables): g_tab, s_tab, f_tab int32 [q, Dmax].
    Entry e of layer r reads group g rolled by s; the last two entries
    are the parity groups, the wrap edge of layer 0 carries F_MASK0,
    and padding entries have f = 0.

    The port adds two flags for its CUDA kernel, whose threads (one a
    circulant row) share the posterior and meet at one address only
    where a group is touched at two different shifts; at one shift the
    same thread returns to its own address. F_SYNC marks every valid
    entry whose group an earlier entry of the same layer already has:
    the kernel orders such updates with barriers. F_BAR, on entry 0 of
    a layer, says that the layer must start behind a barrier: one of its
    groups was touched at another shift since the last barrier (a layer
    with F_SYNC entries counts as touched after its last barrier, which
    is more than needed and safe). A sweep begins behind a barrier
    anyway. The plain version, strictly sequential, ignores both."""
    t = qc_tables(table)
    G, q = t["G"], t["q"]
    rows = []
    for r in range(q):
        ents = [(g, s, F_VALID) for (g, s) in t["layers"][r]]
        ents.append((G + r, 0, F_VALID))
        if r == 0:
            ents.append((G + q - 1, 1, F_VALID | F_MASK0))
        else:
            ents.append((G + r - 1, 0, F_VALID))
        rows.append(ents)
    Dmax = max(len(e) for e in rows)
    g_tab = np.zeros((q, Dmax), np.int32)
    s_tab = np.zeros((q, Dmax), np.int32)
    f_tab = np.zeros((q, Dmax), np.int32)
    touched: dict = {}              # group -> shifts since the last barrier
    for r, ents in enumerate(rows):
        seen = set()
        for e, (g, s, f) in enumerate(ents):
            g_tab[r, e], s_tab[r, e] = g, s
            f_tab[r, e] = f | (F_SYNC if g in seen else 0)
            seen.add(g)
        if r and any(touched.get(g, {s}) != {s} for g, s, _ in ents):
            f_tab[r, 0] |= F_BAR
            touched = {}
        if len(seen) < len(ents):   # the layer's own barriers
            touched = {}
        for g, s, _ in ents:
            touched.setdefault(g, set()).add(s)
    return dict(G=G, q=q, Dmax=Dmax, g_tab=g_tab, s_tab=s_tab, f_tab=f_tab,
                N=t["N"], K=t["K"])


def pack_schedule(g_tab, s_tab, f_tab):
    """The schedule as the CUDA kernel takes it, one int32 an entry:
    g (< 256) | s (< 512) << 8 | flags << 17. Arrays or tensors."""
    return g_tab | (s_tab << 8) | (f_tab << 17)


def unpack_schedule(word):
    """(g, s, flags) of pack_schedule's words."""
    return word & 0xFF, (word >> 8) & 0x1FF, word >> 17


# ---------------------------------------------------------------------------
# K=7 rate-1/2 Viterbi trellis (viterbi.py, viterbi_pallas.py)
# ---------------------------------------------------------------------------

N_STATES = 64              # viterbi.N_STATES


def _branch_xy(b: int, s: int) -> tuple[int, int]:
    """(X, Y) coded bits of input bit b entering register s."""
    v = (b << 6) | s
    return (bin(v & dvbs_fec.G1).count("1") & 1,
            bin(v & dvbs_fec.G2).count("1") & 1)


@functools.lru_cache()
def trellis():
    """(prev [64, 2] int32, sign [64, 2, 2] float32) radix-2 tables
    (viterbi._trellis): prev[ns, j] is the predecessor that drops LSB j,
    sign[ns, j] the expected (X, Y) as +-1 (+1 = bit 0)."""
    prev = np.zeros((N_STATES, 2), np.int32)
    sign = np.zeros((N_STATES, 2, 2), np.float32)
    for ns in range(N_STATES):
        for j in range(2):
            s = ((ns & 0x1F) << 1) | j
            x, y = _branch_xy(ns >> 5, s)
            prev[ns, j] = s
            sign[ns, j] = (1.0 - 2.0 * x, 1.0 - 2.0 * y)
    return prev, sign


@functools.lru_cache()
def trellis_k(k: int):
    """Radix-2^k tables (viterbi._trellis_k): (sign [64, 2^k, 2k] the
    expected +-1 outputs of the fused branch from predecessor
    ((ns & low) << k) | j into ns, earliest (X, Y) first; bits_hi
    [2^k, k] the k input bits as a function of ns's top k bits)."""
    if not 1 <= k <= 6:
        raise ValueError(f"radix 2^{k}: k must be 1..6")
    R = 1 << k
    sign = np.zeros((N_STATES, R, 2 * k), np.float32)
    bits_hi = np.zeros((R, k), np.float32)
    low_mask = (1 << (6 - k)) - 1
    for hi in range(R):
        bits_hi[hi] = [(hi >> i) & 1 for i in range(k)]
    for ns in range(N_STATES):
        bs = [(ns >> (6 - k + i)) & 1 for i in range(k)]
        for j in range(R):
            s = ((ns & low_mask) << k) | j
            for i in range(k):
                x, y = _branch_xy(bs[i], s)
                sign[ns, j, 2 * i] = 1.0 - 2.0 * x
                sign[ns, j, 2 * i + 1] = 1.0 - 2.0 * y
                s = (bs[i] << 5) | (s >> 1)
            assert s == ns
    return sign, bits_hi


@functools.lru_cache()
def viterbi_tables_k3():
    """What kernel C's plain version reads (viterbi_pallas._tables_k3
    without its TPU expansion matrices; the CUDA kernel derives the same
    signs from G1/G2): sign [64, 8, 6] float32 =
    trellis_k(3)[0] and Bm [8, 64] float32, Bm[i, s] = bit i
    (earliest first) of the 3 inputs that entered state s, i.e.
    (s >> (3 + i)) & 1 (rows 3..7 zero)."""
    sign, _ = trellis_k(3)
    Bm = np.zeros((8, N_STATES), np.float32)
    for s in range(N_STATES):
        for i in range(3):
            Bm[i, s] = (s >> (3 + i)) & 1
    return sign, Bm


# ---------------------------------------------------------------------------
# one receiver geometry
# ---------------------------------------------------------------------------

def dvbs_front_tables() -> dict:
    """What the sample-domain front end reads (the matched filter, the
    Oerder-Meyr interpolator and the Farrow resampler): the whole of
    the DVB-S front end's tables, and the first entries of
    receiver_tables."""
    rrc = rrc_taps()
    mid = mid_taps()
    coef, fmid, fhalf = farrow_coeffs()
    return dict(
        rrc_taps=rrc,
        fir_rrc=fir_matrix(tuple(rrc.tolist()), FIR_BLK),
        mid_taps=mid,
        fir_mid=fir_matrix(tuple(mid.tolist()), FIR_BLK),
        farrow_coef=coef,
        farrow_band=np.asarray([fmid, fhalf], np.float64),
    )


def receiver_tables(cfg: modcod.ModcodConfig, n_symbols: int) -> dict:
    """Every array the symbol program and the FEC of one geometry read:
    `cfg` at `n_symbols` symbols (2*n_symbols samples) per carrier. With
    pilots it adds pilot_starts [n_p], pilot_descr [n_p, 36] and
    payload_descr, the descramble phasors of the payload symbols alone
    (models/dvbs2.py's descr[payload_idx - 90])."""
    L = cfg.plframe_len
    pts, mask0 = demap_tables(cfg.constellation, cfg.g1, cfg.g2)
    kt = kernel_tables(cfg.ldpc_table)
    pilots = {}
    if cfg.pilots:
        pilots = dict(
            pilot_starts=pilot_starts(cfg),
            pilot_descr=pilot_descramble_phasors(cfg),
            payload_descr=payload_descramble_phasors(L - 90)[
                payload_indices(cfg) - 90])
    return dict(
        **pilots,
        **dvbs_front_tables(),
        corr_T=template_matrix(corr_blk(n_symbols)),
        hdr_syms=header_syms(cfg.pls_code),
        descr=payload_descramble_phasors(L - 90),
        pls_syms=pls_sym_matrix(),
        demap_pts=pts,
        demap_mask0=mask0,
        bch_M=bch_syndrome_matrix(cfg.framesize, cfg.rate),
        ldpc_g=kt["g_tab"], ldpc_s=kt["s_tab"], ldpc_f=kt["f_tab"],
        bb_mask=scrambling.bb_scrambler_byte_mask(cfg.kbch // 8),
    )


def to_torch(np_tables: dict, device) -> dict:
    """dict of numpy arrays -> dict of tensors on `device` (complex as
    complex64, floats as float32, integers and bools as they are)."""
    out = {}
    for k, v in np_tables.items():
        a = np.asarray(v)
        if np.iscomplexobj(a):
            a = a.astype(np.complex64)
        elif a.dtype.kind == "f":
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
