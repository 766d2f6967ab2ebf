"""Kernel B's in-kernel shift and band arithmetic, checked on the CPU.

csrc/resample_farrow.cu takes the symbols' sample positions t and
derives each tile's biased shift rb and each symbol's band coordinate u
itself, then reads its four symbols' samples from a window of 16 kept in
registers. The kernel runs only on the card (tests/test_torch_cuda.py
holds it there, rb and u equal to shifts_and_band's). Here a numpy model
of its arithmetic, in its float32 operation order, is held against the
plain version (ops/resample_kernel.shifts_and_band, resample_plain):

- rb and u bit-exact with shifts_and_band on the CPU: another rb would
  read other samples;
- each thread's window covers every sample its symbols read, and the
  output computed from the windows alone agrees with resample_plain;
- the tiles that take the masked loads are exactly those whose samples
  leave [0, n2).

Cases: drifting positions, a ragged S (the last tile's centre past S:
edge-padded), large drift of both signs (rb clamped at 0 and at 2 bias
- 1), positions clamped to [0, n2 - 1] at both ends, windows that start
at sample 0 or end at n2 - 1 exactly (interior tiles at the bound), and
positions whose tile shifts are exact halves (rint rounds half to even,
as torch.round).

Tolerance: none for rb, u and the tile split (integer and float32 values
computed by the same operations in the same order). The output within
1e-5 of resample_plain on unit-variance samples (the kernel's fused
multiply-adds, modelled here as a float64 product-sum rounded once to
float32).

The model is written after the .cu body by hand: only
test_kernel_constants reads the CUDA source. Whoever changes the kernel's
arithmetic, its symbols a thread or its tile split changes the model
here with it.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dvbs_tpu_torch import tables
from dvbs_tpu_torch.ops import resample_kernel as rk

torch.set_num_threads(2)

TS, TAPS, DEG = tables.TILE_SYM, tables.FARROW_TAPS, tables.FARROW_DEG
SPT = 4                         # symbols a thread
THREADS = TS // SPT             # a tile's CTA
WIN = 2 * (SPT - 1) + TAPS      # samples a thread reads
SPAN = 2 * (TS - 1) + TAPS      # samples a tile reads
CU = Path(rk.__file__).resolve().parent.parent / "csrc" / "resample_farrow.cu"
f32 = np.float32


def _case(name):
    """(y [C, n2] complex64, t [C, S] float32) from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    C, S, n2 = 3, 8192, 2 * 8192 + 64
    k = np.arange(S, dtype=np.float64)
    if name == "drift":
        t = np.stack([2 * k + 0.3 + 0.17 * c + (1 + 0.2 * c) * 1e-5 * k
                      for c in range(C)])
    elif name == "ragged":
        S = 4096 + 100          # last tile: symbols 4096..4351, centre 4223
        k = k[:S]
        t = np.stack([2 * k + 0.3 - 0.4 * c - 2e-5 * k for c in range(C)])
    elif name == "clamped_rb":
        C = 2                   # bias 32: |r| reaches ~160 and ~-120
        t = np.stack([2 * k - 1.4 + 0.02 * k, 2 * k + 3.2 - 0.015 * k])
    elif name == "clamped_t":
        n2 = 2 * S - 700        # positions past n2 - 1 at the end
        t = np.stack([2 * k - 37.3 + 3e-4 * k, 2 * k + 5.6 - 3e-4 * k,
                      2 * k - 120.0 + 0.05 * k])
        t = np.clip(t, 0.0, n2 - 1.0)
    elif name == "exact_fit":
        n2 = 2 * S + 4          # windows from sample 0 and up to n2 - 1
        t = np.stack([2 * k + 4.3, 2 * k + 0.3, 2 * k + 3.7])
    elif name == "half_even":
        C = 4                   # r: rint(0.5), rint(1.5), rint(2.5), rint(-.5)
        t = np.stack([2 * k + h for h in (0.5, 1.5, 2.5, -0.5)])
    else:
        raise ValueError(name)
    y = (rng.normal(size=(C, n2)) + 1j * rng.normal(size=(C, n2))
         ).astype(np.complex64)
    return y, t.astype(np.float32)


CASES = ("drift", "ragged", "clamped_rb", "clamped_t", "exact_fit",
         "half_even")


def _kernel_model(t, n2, band):
    """csrc/resample_farrow.cu's shift and band arithmetic, a CTA (c, ti)
    at a time and its 64 threads at once: (u [C, nt*TS] float32, rb
    [C, nt] int32, edge [C, nt] bool, w [C, nt, THREADS] each thread's
    first sample)."""
    C, S = t.shape
    nt = -(-S // TS)
    bias = 1 << (tables.shift_bits_for(S) - 1)
    lo, hi = f32(tables.FARROW_LO), f32(tables.FARROW_HI)
    mid, halfr = f32(band[0]), f32(band[1])
    u = np.empty((C, nt * TS), np.float32)
    rb = np.empty((C, nt), np.int32)
    edge = np.empty((C, nt), bool)
    w = np.empty((C, nt, THREADS), np.int64)
    thread = np.arange(THREADS)
    for c in range(C):
        tc = t[c]
        for ti in range(nt):
            kc = ti * TS + TS // 2 - 1
            g0 = tc[min(kc, S - 1)] - f32(2 * kc)
            g1 = tc[min(kc + 1, S - 1)] - f32(2 * kc + 2)
            r = np.rint(f32(0.5) * (g0 + g1))
            rb[c, ti] = min(max(int(r) + bias, 0), 2 * bias - 1)
            w0 = 2 * TS * ti + int(rb[c, ti]) - bias - 4
            k0 = ti * TS + SPT * thread
            for s in range(SPT):
                k = k0 + s
                g = tc[np.minimum(k, S - 1)] - (2 * k).astype(np.float32)
                d = (g - r) + f32(4.0)
                u[c, k] = (np.minimum(np.maximum(d, lo), hi) - mid) / halfr
            edge[c, ti] = not (w0 >= 0 and w0 + SPAN <= n2)
            w[c, ti] = w0 + 2 * SPT * thread
    return u, rb, edge, w


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _model_output(y, t, u, w, coef):
    """The kernel's output from the threads' windows alone: v[2s + tap]
    of the window at w, zero outside [0, n2); Horner's rule and the tap
    sum as fused multiply-adds."""
    C, n2 = y.shape
    S = t.shape[1]
    nt = w.shape[1]
    idx = w[..., None] + np.arange(WIN)                 # [C, nt, THREADS, WIN]
    inside = (idx >= 0) & (idx < n2)
    v = np.where(inside, np.take_along_axis(
        y, np.clip(idx, 0, n2 - 1).reshape(C, -1), 1).reshape(idx.shape), 0)
    uu = u.reshape(C, nt, THREADS, SPT)
    re = np.zeros(uu.shape, np.float32)
    im = np.zeros(uu.shape, np.float32)
    for tap in range(TAPS):
        p = np.full(uu.shape, coef[tap, 0], np.float32)
        for d in range(1, DEG + 1):
            p = _fma(p, uu, coef[tap, d])
        vt = np.stack([v[..., 2 * s + tap] for s in range(SPT)], -1)
        re = _fma(p, vt.real, re)
        im = _fma(p, vt.imag, im)
    return (re + 1j * im).astype(np.complex64).reshape(C, nt * TS)[:, :S]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    y, t = _case(request.param)
    coef, fmid, fhalf = tables.farrow_coeffs()
    band = (fmid, fhalf)
    u_ref, rb_ref, bias = rk.shifts_and_band(torch.from_numpy(t), band)
    return dict(name=request.param, y=y, t=t, coef=coef, band=band,
                bias=bias, u_ref=u_ref, rb_ref=rb_ref,
                model=_kernel_model(t, y.shape[1], band))


def test_shift_and_band_bit_exact(case):
    u, rb, _, _ = case["model"]
    assert np.array_equal(rb, case["rb_ref"].numpy())
    assert np.array_equal(u.view(np.uint32),
                          case["u_ref"].numpy().view(np.uint32))
    bias = case["bias"]
    if case["name"] == "clamped_rb":
        assert (rb == 0).any() and (rb == 2 * bias - 1).any()
    if case["name"] == "half_even":
        assert rb.tolist() == [[bias + r] * rb.shape[1] for r in (0, 2, 2, 0)]
    t, S = case["t"], case["t"].shape[1]
    if case["name"] == "clamped_t":
        assert (t == 0).any() and (t == case["y"].shape[1] - 1).any()
    if case["name"] == "ragged":
        assert (rb.shape[1] - 1) * TS + TS // 2 - 1 >= S


def test_windows_cover_every_read(case):
    """Symbol j of tile ti reads sample 2 TS ti + rb - bias - 4 + 2j + tap
    (resample_plain's window); the thread's window holds it at 2s + tap.
    The output from the windows agrees with resample_plain."""
    y, t, bias = case["y"], case["t"], case["bias"]
    u, rb, _, w = case["model"]
    C, nt = rb.shape
    j = SPT * np.arange(THREADS)[:, None] + np.arange(SPT)  # [THREADS, SPT]
    for tap in range(TAPS):
        read = (2 * TS * np.arange(nt)[None, :, None, None]
                + rb[:, :, None, None].astype(np.int64) - bias - 4
                + 2 * j + tap)                          # [C, nt, THREADS, SPT]
        slot = read - w[..., None]
        assert np.array_equal(slot, np.broadcast_to(
            2 * np.arange(SPT) + tap, slot.shape))
        assert slot.min() >= 0 and slot.max() < WIN
    got = _model_output(y, t, u, w, case["coef"])
    ref = rk.resample_plain(torch.from_numpy(y), case["u_ref"],
                            case["rb_ref"], bias,
                            torch.from_numpy(case["coef"]), t.shape[1])
    assert np.abs(got - ref.numpy()).max() <= 1e-5


def test_masked_tiles_are_those_leaving_the_block(case):
    y, bias = case["y"], case["bias"]
    _, _, edge, _ = case["model"]
    rb = case["rb_ref"].numpy().astype(np.int64)
    C, nt = rb.shape
    n2 = y.shape[1]
    first = 2 * TS * np.arange(nt)[None, :] + rb - bias - 4
    reads = first[..., None, None] + 2 * np.arange(TS)[:, None] \
        + np.arange(TAPS)                               # [C, nt, TS, TAPS]
    leaves = ((reads < 0) | (reads >= n2)).reshape(C, nt, -1).any(-1)
    assert np.array_equal(edge, leaves)
    assert edge.any() and not edge.all()
    if case["name"] == "exact_fit":     # carrier 0's first, 1's last tile
        assert not edge[0, 0] and not edge[1, -1]
        assert edge[0, -1] and edge[1, 0]


def test_kernel_constants():
    """The model's constants are the kernel's and the tables'."""
    src = CU.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert consts["TS"] == str(TS) and consts["TAPS"] == str(TAPS)
    assert consts["DEG"] == str(DEG) and consts["SPT"] == str(SPT)
    assert consts["THREADS"] == "TS / SPT"
    assert consts["WIN"] == "2 * (SPT - 1) + TAPS"
    assert consts["SPAN"] == "2 * (TS - 1) + TAPS"
