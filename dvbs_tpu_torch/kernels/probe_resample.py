"""Stage probes of the resampler kernel: where kernel B's time goes.

Port of the Pallas TPU probes of tools/bisect_resample_kernel.py (stages
dma, rows, rb, barrel, swap, full), tools/bisect_resample_kernel2.py
(v0..v8) and tools/split_resample_pallas.py (split: kernel B's body on
operands staged by a separate prep pass, prep and kernel timed apart).
Every stage computes what the TPU probe computes for the same inputs;
csrc/resample_probe.cu runs it on a CUDA tensor and the plain PyTorch
version beside it on a CPU tensor. The plain versions serve the CPU
tests and the comparison on the card, nothing else.

    python -m dvbs_tpu_torch.kernels.probe_resample

prints one line per stage: equal to its plain version or not (max abs
error), and ms by CUDA events (device time from a replayed CUDA graph,
and the time of a launch from the host) at the TPU probes' small shapes
and at the 8-carrier bank's shape. A stage that fails to build or launch
raises. Needs one CUDA device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import backend, tables

TS = tables.TILE_SYM
EXTRA = 4                   # halo rows after each chunk of TC tiles
HBM_BPS = 3.35e12           # the H100 SXM's published HBM rate, bytes/s

# stage name -> id in csrc/resample_probe.cu, in the TPU probes' order
STAGES = {"v0": 0, "v1": 1, "v2": 2, "v3": 3, "v4": 4, "v5": 5, "v6": 6,
          "v7": 7, "v8": 8, "dma": 9, "rows": 10, "rb": 11, "barrel": 12,
          "swap": 13, "full": 14}
ALL_STAGES = tuple(STAGES) + ("split",)
_TWO_PLANES = ("v2", "dma", "rows", "rb", "barrel", "swap", "full")
_BLOCKED = ("v5", "v6", "v7", "v8")


def make_inputs(stage: str, device, C: int = 2, nck: int = 4, TC: int = 8,
                shift_bits: int = 9, seed: int = 0) -> dict:
    """The TPU probe's inputs for `stage`, made with numpy from `seed`:
    float32 planes a (and b), u, int32 rb, at C carriers and nck chunks
    of TC tiles of 256 (the probes run C=2, 4 chunks of 8, shift_bits
    9). v0..v2 have no carrier axis (C = 1); v5..v8 read the blocked
    [C, nck, TC+4, 256] with rb < 16; the other stages read
    [C, ntp+4, 256] planes with rb < 2^shift_bits."""
    rng = np.random.default_rng(seed)
    ntp = nck * TC
    if stage in ("v0", "v1", "v2"):
        C = 1
    if stage == "v0":
        shape = (C, ntp, TS)
    elif stage in _BLOCKED:
        shape = (C, nck, TC + EXTRA, TS)
    else:
        shape = (C, ntp + EXTRA, TS)
    d = dict(stage=stage, C=C, ntp=ntp, TC=TC, shift_bits=shift_bits)
    d["a"] = rng.normal(size=shape).astype(np.float32)
    if stage in _TWO_PLANES:
        d["b"] = rng.normal(size=shape).astype(np.float32)
    if stage == "full":
        d["u"] = rng.normal(size=(C, ntp, TS)).astype(np.float32)
    if stage in ("v7", "v8"):
        d["rb"] = rng.integers(0, 16, size=(C, ntp)).astype(np.int32)
    elif stage in ("rb", "barrel", "swap", "full"):
        d["rb"] = rng.integers(0, 1 << shift_bits,
                               size=(C, ntp)).astype(np.int32)
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in d.items()}


def run_stage(inp: dict) -> torch.Tensor:
    """One probe stage on make_inputs' dict -> float32 [C, ntp, 256]:
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if backend.use_kernel(inp["a"]):
        return stage_cuda(inp)
    return stage_plain(inp)


def _windows(flat: torch.Tensor, start: torch.Tensor, width: int):
    """flat [C, n], start [C, T] -> flat[c, start : start + width]
    as [C, T, width]."""
    idx = start[..., None] + torch.arange(width, device=flat.device)
    return torch.gather(flat, 1, idx.reshape(flat.shape[0], -1)
                        ).reshape(*start.shape, width)


def stage_plain(inp: dict) -> torch.Tensor:
    """Plain PyTorch version of every stage."""
    stage, C, ntp, TC = inp["stage"], inp["C"], inp["ntp"], inp["TC"]
    a, b, rb = inp["a"], inp.get("b"), inp.get("rb")
    dev = a.device
    if stage == "v0":
        return a * 2.0
    if stage in ("v1", "v3", "v4"):
        return a[:, :ntp] * 2.0
    if stage in ("v2", "dma", "rows"):
        return a[:, :ntp] + b[:, :ntp]
    if stage == "rb":
        return a[:, :ntp] + b[:, :ntp] + (rb >> 1).to(torch.float32)[..., None]
    if stage in ("v5", "v6"):
        return a[:, :, :TC].reshape(C, ntp, TS) * 2.0
    if stage == "v7":
        return a[:, :, :TC].reshape(C, ntp, TS) \
            + rb.to(torch.float32)[..., None]
    if stage == "v8":
        # chunk-local window: row i of chunk k starts at i*TS + (rb >> 1)
        nck = ntp // TC
        flat = a.reshape(C * nck, -1)
        start = (torch.arange(TC, device=dev) * TS)[None, :] \
            + (rb.reshape(C * nck, TC).to(torch.int64) >> 1)
        return _windows(flat, start, TS).reshape(C, ntp, TS)
    # barrel, swap, full: planes shifted by hv = rb >> 1 (its low
    # shift_bits - 1 bits), then the parity select of rb & 1
    hv = (rb.to(torch.int64) >> 1) & ((1 << (inp["shift_bits"] - 1)) - 1)
    odd = ((rb & 1) != 0)[..., None]
    start = (torch.arange(ntp, device=dev) * TS)[None, :] + hv
    width = TS + 5
    re_ = _windows(a.reshape(C, -1), start, width + 1)
    ro_ = _windows(b.reshape(C, -1), start, width + 1)
    if stage == "barrel":
        return re_[..., :TS] + ro_[..., :TS]
    e_pre = torch.where(odd, ro_[..., :width], re_[..., :width])
    o_pre = torch.where(odd, re_[..., 1:width + 1], ro_[..., :width])
    if stage == "swap":
        return e_pre[..., :TS] + o_pre[..., :TS]
    assert stage == "full", stage
    u = inp["u"]
    tap = torch.full_like(u, 0.1)
    for dg in range(1, tables.FARROW_DEG + 1):
        tap = tap * u + 0.01 * dg
    out = torch.zeros_like(u)
    for ci in range(tables.FARROW_TAPS):
        p = e_pre if ci % 2 == 0 else o_pre
        out = out + tap * p[..., ci // 2:ci // 2 + TS]
    return out


def stage_cuda(inp: dict) -> torch.Tensor:
    """Launch one stage of csrc/resample_probe.cu."""
    from . import build
    stage, C, ntp, TC = inp["stage"], inp["C"], inp["ntp"], inp["TC"]
    a = inp["a"]
    dev = a.device
    if stage == "v0":
        shape = (C, ntp, TS)
    elif stage in _BLOCKED:
        shape = (C, ntp // TC, TC + EXTRA, TS)
    else:
        shape = (C, ntp + EXTRA, TS)
    backend.check(a, "a", torch.float32, shape, dev)
    ptr = {}
    for k, dt, shp in (("b", torch.float32, shape),
                       ("u", torch.float32, (C, ntp, TS)),
                       ("rb", torch.int32, (C, ntp))):
        t = inp.get(k)
        if t is not None:
            backend.check(t, k, dt, shp, dev)
        ptr[k] = t.data_ptr() if t is not None else None
    if 2 * (TC + EXTRA) * TS * 4 > 48 * 1024:
        raise ValueError(f"TC {TC}: the row windows exceed 48 KB of shared "
                         f"memory")
    out = torch.empty((C, ntp, TS), dtype=torch.float32, device=dev)
    build.launch("resample_probe", STAGES[stage], a.data_ptr(), ptr["b"],
                 ptr["u"], ptr["rb"], out.data_ptr(), C, ntp, TC, EXTRA,
                 inp["shift_bits"])
    backend.LAUNCHES["resample_probe"] += 1
    return out


# ---------------------------------------------------------------------------
# split: kernel B's arithmetic on planes staged by a separate prep pass
# ---------------------------------------------------------------------------

def plane_width(nt: int, bias: int) -> int:
    """Samples per parity plane: the last tile at the largest shift reads
    up to nt*TS + bias + 4."""
    return nt * TS + bias + 8


def split_prep(y2: torch.Tensor, nt: int, bias: int):
    """Prep pass: the parity planes (e_re, o_re, e_im, o_im), each
    [C, plane_width] float32, of y2 [C, n2] zero-padded by bias + 4 on
    the left (and by zeros on the right). Kernel or plain by device."""
    if backend.use_kernel(y2):
        return split_prep_cuda(y2, nt, bias)
    return split_prep_plain(y2, nt, bias)


def split_prep_plain(y2: torch.Tensor, nt: int, bias: int):
    C, n2 = y2.shape
    Wp = plane_width(nt, bias)
    ypp = torch.zeros((C, 2 * Wp), dtype=y2.dtype, device=y2.device)
    n = min(n2, 2 * Wp - (bias + 4))
    ypp[:, bias + 4:bias + 4 + n] = y2[:, :n]
    e, o = ypp[:, 0::2], ypp[:, 1::2]
    return tuple(p.contiguous() for p in (e.real, o.real, e.imag, o.imag))


def split_prep_cuda(y2: torch.Tensor, nt: int, bias: int):
    from . import build
    C, n2 = y2.shape
    dev = y2.device
    backend.check(y2, "y2", torch.complex64, (C, n2), dev)
    Wp = plane_width(nt, bias)
    planes = tuple(torch.empty((C, Wp), dtype=torch.float32, device=dev)
                   for _ in range(4))
    build.launch("resample_probe_prep", y2.data_ptr(), C, n2, bias, Wp,
                 *[p.data_ptr() for p in planes])
    backend.LAUNCHES["resample_probe"] += 1
    return planes


def split_kernel(planes, u: torch.Tensor, rb: torch.Tensor,
                 coef: torch.Tensor, S: int) -> torch.Tensor:
    """Kernel pass: the Farrow sum of kernel B on staged planes -> [C, S]
    complex64. u [C, nt*TS], rb [C, nt] biased shifts, coef [TAPS, DEG+1].
    Kernel or plain by device."""
    if backend.use_kernel(u):
        return split_kernel_cuda(planes, u, rb, coef, S)
    return split_kernel_plain(planes, u, rb, coef, S)


def split_kernel_plain(planes, u, rb, coef, S: int) -> torch.Tensor:
    """Horner's rule per tap and the tap sum in kernel B's order, reading
    sample t of symbol (ti, j) from plane (odd + t) & 1 at
    TS*ti + (rb >> 1) + j + ((odd + t) >> 1)."""
    e_re, o_re, e_im, o_im = planes
    C, nt = rb.shape
    dev = u.device
    e = torch.complex(e_re, e_im)
    o = torch.complex(o_re, o_im)
    start = (torch.arange(nt, device=dev) * TS)[None, :] \
        + (rb.to(torch.int64) >> 1)
    width = TS + 6
    we, wo = _windows(e, start, width), _windows(o, start, width)
    odd = ((rb & 1) != 0)[..., None]
    uu = u.reshape(C, nt, TS)
    out = torch.zeros((C, nt, TS), dtype=torch.complex64, device=dev)
    for t in range(tables.FARROW_TAPS):
        tap = coef[t, 0].expand_as(uu)
        for dg in range(1, tables.FARROW_DEG + 1):
            tap = tap * uu + coef[t, dg]
        # m = odd + t: plane m & 1 at offset m >> 1
        h0, h1 = t >> 1, (t + 1) >> 1
        even_t = t % 2 == 0
        v0 = (we if even_t else wo)[..., h0:h0 + TS]      # odd = 0
        v1 = (wo if even_t else we)[..., h1:h1 + TS]      # odd = 1
        out = out + tap * torch.where(odd, v1, v0)
    return out.reshape(C, nt * TS)[:, :S]


def split_kernel_cuda(planes, u, rb, coef, S: int) -> torch.Tensor:
    from . import build
    C, nt = rb.shape
    dev = u.device
    Wp = planes[0].shape[1]
    for i, p in enumerate(planes):
        backend.check(p, f"plane{i}", torch.float32, (C, Wp), dev)
    backend.check(u, "u", torch.float32, (C, nt * TS), dev)
    backend.check(rb, "rb", torch.int32, (C, nt), dev)
    backend.check(coef, "coef", torch.float32,
                  (tables.FARROW_TAPS, tables.FARROW_DEG + 1), dev)
    if Wp < plane_width(nt, 0):
        raise ValueError(f"planes of {Wp} samples are too short for {nt} "
                         f"tiles")
    out = torch.empty((C, S), dtype=torch.complex64, device=dev)
    build.launch("resample_probe_split", *[p.data_ptr() for p in planes],
                 C, Wp, u.data_ptr(), rb.data_ptr(), S, nt, coef.data_ptr(),
                 out.data_ptr())
    backend.LAUNCHES["resample_probe"] += 1
    return out


def make_split_inputs(device, C: int = 8, S: int = 552960, seed: int = 0):
    """Kernel B's operands at [C, S] symbols (552960: the 8-carrier QPSK
    1/2 bank's block): y2 [C, 2S] complex64, positions drifting with
    both signs, and from them rb, u, bias (ops/resample_kernel), coef."""
    from ..ops import resample_kernel as rk
    rng = np.random.default_rng(seed)
    n2 = 2 * S
    y = torch.from_numpy((rng.normal(size=(C, n2)) + 1j * rng.normal(
        size=(C, n2))).astype(np.complex64)).to(device)
    k = np.arange(S)
    t = np.stack([2.0 * k + 0.3 + 0.17 * c +
                  (1 if c % 2 == 0 else -1) * (1 + 0.2 * c) * 1e-5 * k
                  for c in range(C)]).astype(np.float32)
    coef_np, fmid, fhalf = tables.farrow_coeffs()
    rb, u, bias = rk.shifts_and_band(torch.from_numpy(t).to(device),
                                     (fmid, fhalf))
    return dict(y2=y, u=u, rb=rb, bias=bias, S=S,
                coef=torch.from_numpy(coef_np).to(device))


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over reps calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device ms per call of fn(): `launches` calls captured in one CUDA
    graph and replayed, so that the host's time to enqueue a launch
    (longer than the small stages run) is not in the reading."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (launches * replays)


def run_all(device, sizes=((2, 4, 8), (8, 270, 8)), split_shape=(8, 552960),
            reps: int = 20) -> list[dict]:
    """Every stage against its plain version on `device` (a card), at
    each (C, nck, TC) of `sizes` and the split at `split_shape`: a list
    of dicts (stage, shape, max_abs_err, ms by CUDA events around
    eager launches, device_ms from a replayed CUDA graph, plain_ms,
    bytes (inputs read and output written once), hbm_bound_ms (those
    bytes at HBM_BPS) and, for v0, library_ms (torch.mul, graph-timed); the
    split adds prep_ms and kernel_ms, graph times too, and its error is
    against kernel B's plain version). Raises if a stage does not build
    or launch."""
    from ..ops import resample_kernel as rk
    rows = []
    for C, nck, TC in sizes:
        for stage in STAGES:
            inp = make_inputs(stage, device, C=C, nck=nck, TC=TC)
            got, ref = stage_cuda(inp), stage_plain(inp)
            torch.cuda.synchronize()
            nbytes = got.numel() * got.element_size() + sum(
                v.numel() * v.element_size() for v in inp.values()
                if isinstance(v, torch.Tensor))
            rows.append(dict(
                stage=stage, shape=[inp["C"], inp["ntp"], TS],
                max_abs_err=float((got - ref).abs().max()),
                ms=cuda_ms(lambda: stage_cuda(inp), reps),
                device_ms=graph_ms(lambda: stage_cuda(inp)),
                plain_ms=cuda_ms(lambda: stage_plain(inp), 3),
                bytes=nbytes, hbm_bound_ms=nbytes / HBM_BPS * 1e3,
                library_ms=graph_ms(lambda: torch.mul(inp["a"], 2.0))
                if stage == "v0" else None))
    C, S = split_shape
    sp = make_split_inputs(device, C, S)
    nt = sp["rb"].shape[1]
    planes = split_prep_cuda(sp["y2"], nt, sp["bias"])
    ref_planes = split_prep_plain(sp["y2"], nt, sp["bias"])
    got = split_kernel_cuda(planes, sp["u"], sp["rb"], sp["coef"], S)
    ref = rk.resample_plain(sp["y2"], sp["u"], sp["rb"], sp["bias"],
                            sp["coef"], S)
    fused = rk.resample_cuda(sp["y2"], sp["u"], sp["rb"], sp["bias"],
                             sp["coef"], S)
    torch.cuda.synchronize()
    prep_err = max(float((p - r).abs().max())
                   for p, r in zip(planes, ref_planes))
    prep_ms = graph_ms(lambda: split_prep_cuda(sp["y2"], nt, sp["bias"]))
    kernel_ms = graph_ms(lambda: split_kernel_cuda(
        planes, sp["u"], sp["rb"], sp["coef"], S))
    rows.append(dict(
        stage="split", shape=[C, S],
        max_abs_err=max(float((got - ref).abs().max()), prep_err),
        err_vs_kernel_b=float((got - fused).abs().max()),
        prep_ms=prep_ms, kernel_ms=kernel_ms,
        device_ms=prep_ms + kernel_ms,
        ms=cuda_ms(lambda: split_kernel_cuda(
            split_prep_cuda(sp["y2"], nt, sp["bias"]), sp["u"], sp["rb"],
            sp["coef"], S), reps),
        kernel_b_ms=graph_ms(lambda: rk.resample_cuda(
            sp["y2"], sp["u"], sp["rb"], sp["bias"], sp["coef"], S)),
        plain_ms=cuda_ms(lambda: split_kernel_plain(
            ref_planes, sp["u"], sp["rb"], sp["coef"], S), 3)))
    return rows


def main() -> int:
    dev = backend.default_device()
    print(f"device: {torch.cuda.get_device_name(0)}")
    for r in run_all(dev):
        extra = ""
        if r["stage"] == "split":
            extra = (f" (prep {r['prep_ms']:.4f} ms + kernel "
                     f"{r['kernel_ms']:.4f} ms; fused kernel B "
                     f"{r['kernel_b_ms']:.4f} ms; max abs err against "
                     f"kernel B {r['err_vs_kernel_b']:.3g})")
        equal = "equal to plain" if r["max_abs_err"] == 0 else \
            f"max abs err {r['max_abs_err']:.3g}"
        if r.get("hbm_bound_ms") is not None:
            share = r["hbm_bound_ms"] / r["device_ms"]
            extra += (f"; its {r['bytes']} bytes at {HBM_BPS:.3g} B/s "
                      f"(HBM) {r['hbm_bound_ms']:.4f} ms = " + (
                          f"{share:.2f} of the kernel's time" if share <= 1
                          else "more than the kernel's time (its replayed "
                          "bytes sit in the L2, whose rate is not "
                          "published): no share"))
        if r.get("library_ms") is not None:
            extra += f"; torch.mul {r['library_ms']:.4f} ms (CUDA graph)"
        print(f"{r['stage']:7s} {r['shape']}: {equal}; kernel "
              f"{r['device_ms']:.4f} ms on the device (CUDA graph), "
              f"{r['ms']:.4f} ms a launch from the host, plain "
              f"{r['plain_ms']:.3f} ms{extra}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
