"""The soft demapper's dispatch, its kernel's host-side checks and a numpy
model of its kernel's arithmetic, on the CPU; no JAX (test_soft_demap in
test_torch_plsync_plphase.py and test_torch_pilots.py holds the plain
version against dvbs_tpu).

- on CPU tensors `soft_demap` runs the plain version, exactly, and
  launches nothing;
- `kernel_params` (the CUDA wrapper's host side) refuses a mask0 that is
  not the standard bit pattern, and reads each table from its tensor once
  per version;
- `demap.soft_demap` replaced on its module, as rxbench/faults.py does,
  is what a SymbolProgram forward calls;
- `kernel_model`, csrc/soft_demap.cu's arithmetic in numpy (a subset's
  own maximum, the sums point by point, the halving count from frexp),
  against the plain version. Edit it with the .cu.

Tolerance of the model against the plain version: demap.against_plain's,
as tests/test_torch_cuda.py holds the kernel: each LLR within 1e-5 x sca
x (1 + ss |x| + ps max|p|) / npwr, and at a halving step 127 x 2^j one
halving more or fewer. Everything else exact.
"""
import numpy as np
import pytest
import torch

from dvbs_tpu_torch import backend, tables
from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver
from dvbs_tpu_torch.ops import demap
from dvbs_tpu_torch.spec import modcod

torch.set_num_threads(2)

MODCODS = (4, 13, 18, 24)               # QPSK, 8PSK, 16APSK, 32APSK


def _tables(mc: int):
    cfg = modcod.get_config(mc)
    p, m0 = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)
    return cfg.constellation, torch.from_numpy(p), torch.from_numpy(m0)


def _syms(mc: int, name: str, n: int = 2048):
    """(syms complex64, npwr): noisy points, far outside the outer ring
    (|x| 10 to 1000), each point where its scaled distance is 0, zero,
    and noisy points at npwr 1/32 (the halving clamp acts)."""
    kind, pts, _ = _tables(mc)
    p = pts.numpy()
    ss, ps, _ = tables.DEMAP_SCALES[kind]
    rng = np.random.default_rng(200 + mc)
    x = p[rng.integers(0, len(p), n)] + 0.15 * (
        rng.normal(size=n) + 1j * rng.normal(size=n))
    if name == "far":
        x = x * 10.0 ** rng.uniform(1, 3, n)
    elif name == "on_point":
        x = np.tile(p * (ps / ss), 8)
    elif name == "zero":
        x = np.zeros(100)
    return (torch.from_numpy(x.astype(np.complex64)),
            1 / 32 if name == "clamp" else 1.0)


def kernel_model(syms: torch.Tensor, kind: str, pts: torch.Tensor,
                 mask0: torch.Tensor, npwr: float = 1.0) -> torch.Tensor:
    """csrc/soft_demap.cu in float32 numpy, on what its wrapper gives it."""
    scaled, ss, sca = demap.kernel_params(kind, pts, mask0)
    x = syms.numpy().astype(np.complex64).reshape(-1)
    out = kernel_rows(x, scaled.reshape(-1, 2), ss, sca, 1.0 / npwr)
    return torch.from_numpy(out.reshape(*syms.shape, out.shape[1]))


def kernel_rows(x: np.ndarray, p: np.ndarray, ss: float, sca: float,
                inv_npwr: float) -> np.ndarray:
    """The kernel's arithmetic, a row a symbol x [n] complex64, points p
    [M, 2] scaled: distances, per bit each subset's maximum and its exps
    summed point by point, the difference scaled, the halving count
    exact. -> [n, m] float32."""
    M = len(p)
    m = M.bit_length() - 1
    f32 = np.float32
    xr, xi = x.real * f32(ss), x.imag * f32(ss)
    dr, di = xr[:, None] - p[:, 0], xi[:, None] - p[:, 1]
    z = -np.sqrt(dr * dr + di * di) * f32(inv_npwr)
    out = np.empty((len(x), m), np.float32)
    with np.errstate(over="ignore"):
        for k in range(m):
            bit = (np.arange(M) >> (m - 1 - k)) & 1
            lse = []
            for b in (0, 1):
                mx = z[:, bit == b].max(axis=1)
                acc = np.zeros(len(x), np.float32)
                for s in np.flatnonzero(bit == b):
                    acc += np.exp(z[:, s] - mx)
                lse.append(np.log(acc) + mx)
            out[:, k] = (lse[0] - lse[1]) * f32(sca)
    return halving_model(out)


def halving_model(x: np.ndarray) -> np.ndarray:
    """The kernel's clamp: x 2^-ceil(log2(|x| / 127)) where |x| > 127,
    the count from frexp (r = f 2^e, f in [0.5, 1))."""
    r = np.abs(x) / np.float32(127)
    f, e = np.frexp(r)
    halve = np.where(r > 1, np.where(f == 0.5, e - 1, e), 0)
    return np.ldexp(x, -halve).astype(np.float32)


@pytest.mark.parametrize("mc", MODCODS)
def test_cpu_tensors_run_the_plain_version(mc):
    kind, pts, mask0 = _tables(mc)
    x, _ = _syms(mc, "noisy")
    x = x.reshape(2, -1)
    backend.reset_launches()
    got = demap.soft_demap(x, kind, pts, mask0)
    assert backend.LAUNCHES["soft_demap"] == 0
    assert got.dtype == torch.float32
    assert got.shape == (*x.shape, mask0.shape[0])
    assert torch.equal(got, demap.soft_demap_plain(x, kind, pts, mask0))


@pytest.mark.parametrize("mc", MODCODS)
def test_kernel_params_scale_the_points(mc):
    kind, pts, mask0 = _tables(mc)
    scaled, ss, sca = demap.kernel_params(kind, pts, mask0)
    want_ss, ps, want_sca = tables.DEMAP_SCALES[kind]
    assert (ss, sca) == (want_ss, want_sca)
    want = torch.view_as_real(pts * ps)
    assert np.array_equal(scaled, want.numpy().reshape(-1))
    assert np.array_equal(mask0.numpy(), tables.demap_mask0(len(pts)))


@pytest.mark.parametrize("bad", ["flipped", "rows_reversed", "transposed",
                                 "one_point_short", "64_points", "batched"])
def test_kernel_params_refuse_a_nonstandard_mask0(bad):
    kind, pts, mask0 = _tables(24)
    m0 = mask0.numpy()
    if bad == "batched":                # right values, shape [1, 5, 32]
        m = torch.from_numpy(m0[None])
    else:
        m = torch.from_numpy({
            "flipped": ~m0, "rows_reversed": m0[::-1].copy(),
            "transposed": m0.T.copy(), "one_point_short": m0[:, :-1].copy(),
            "64_points": tables.demap_mask0(64)}[bad])
    with pytest.raises(ValueError):
        demap.kernel_params(kind, pts, m)


def test_kernel_params_refuse_points_that_do_not_match():
    kind, pts, mask0 = _tables(24)
    with pytest.raises(ValueError):
        demap.kernel_params(kind, pts[:16], mask0)
    with pytest.raises(ValueError):
        demap.kernel_params(kind, pts.to(torch.complex128), mask0)


def test_kernel_params_read_each_table_once_per_version(monkeypatch):
    kind, pts, mask0 = _tables(18)
    pts = pts.clone()
    reads = []
    real = demap._check_mask0
    monkeypatch.setattr(demap, "_check_mask0",
                        lambda m: reads.append(1) or real(m))
    first, _, _ = demap.kernel_params(kind, pts, mask0)
    again, _, _ = demap.kernel_params(kind, pts, mask0)
    assert again is first and len(reads) == 1
    pts.mul_(2)                         # a new version: read again
    doubled, _, _ = demap.kernel_params(kind, pts, mask0)
    assert np.array_equal(doubled, 2 * first) and len(reads) == 1


def test_replaced_soft_demap_reaches_the_symbol_program(monkeypatch):
    """As rxbench/faults.py plants `llrs_altered`: the replacement on the
    module is called by the program's forward, and what it returns is the
    program's LLRs."""
    rx = DVBS2Receiver(mc=4, short=True, block_symbols=1 << 15,
                       device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 2, 1 << 16)).astype(
        np.float32))
    ref = rx.program(x)["llrs"]
    calls, real = [], demap.soft_demap

    def negated(*a, **k):
        calls.append(a[0].shape)
        return -real(*a, **k)
    monkeypatch.setattr(demap, "soft_demap", negated)
    got = rx.program(x)["llrs"]
    assert calls == [(1, rx.program.F, rx.cfg.payload_len)]
    assert torch.equal(got, -ref)


@pytest.mark.parametrize("name", ["noisy", "far", "on_point", "zero",
                                  "clamp"])
@pytest.mark.parametrize("mc", MODCODS)
def test_kernel_model_matches_plain(mc, name):
    kind, pts, mask0 = _tables(mc)
    x, npwr = _syms(mc, name)
    got = kernel_model(x, kind, pts, mask0, npwr)
    share, _, at_step = demap.against_plain(got, x, kind, pts, mask0, npwr)
    assert share <= 1 and 100 * at_step <= got.numel(), (share, at_step)
    if name == "clamp":
        raw = demap.llrs_unclamped(x, kind, pts, mask0, npwr)
        assert bool((raw.abs() > 127).any())
        assert float(got.abs().max()) <= 127
    if name == "far":                   # one shared maximum would fail
        assert bool(torch.isfinite(got).all())


def test_kernel_model_halving_is_exact():
    """At and beside each halving step 127 x 2^j the model halves the
    least number of times that brings |x| to 127 or under."""
    steps = np.float32(127) * np.float32(2.0) ** np.arange(6)
    xs = np.concatenate([steps, np.nextafter(steps, np.float32(np.inf)),
                         np.nextafter(steps, np.float32(0)), [1e-3, 100]])
    xs = np.concatenate([xs, -xs]).astype(np.float32)
    y = halving_model(xs)
    assert (np.abs(y) <= 127).all()
    # one halving fewer would leave it above 127
    assert ((np.abs(y) > 63.5) | (y == xs)).all()
    assert np.array_equal(y[:6], np.full(6, 127, np.float32))
