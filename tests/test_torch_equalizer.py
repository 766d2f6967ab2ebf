"""The port's block LMS equalizer (ops/equalizer.py) and the receiver's
equalize=True hook against dvbs_tpu's, on the same numpy inputs.

- lms_equalize on the signals of tests/test_equalizer.py (QPSK through
  the 3-tap multipath channel with noise, seed 0; the clean stream,
  seed 1): within 1e-4 max abs of dvbs_tpu's, and the EVM assertions
  of that file hold for the port;
- a batch of C = 3 streams equals three single calls;
- DVBS2Receiver(equalize=True) on the hook's 2-ray echo block (seed 6):
  frame_ok and the BBFRAME bytes equal dvbs_tpu's, and the program's
  symbols after the equalizer are those of lms_equalize.

Tolerances: the QPSK slicer is a hard decision and each side solves
its normal equations with its own LAPACK, so a symbol near zero may
slice the other way and move the taps slightly: 1e-4 max abs on the
equalized symbols (measured ~1e-6); 1e-5 between a batched and a single
call (float32 matmuls blocked differently). Decoded bytes: exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.models.dvbs2 import DVBS2Receiver as JaxReceiver  # noqa: E402
from dvbs_tpu.ops import equalizer as jeq  # noqa: E402
from dvbs_tpu.spec import constellations, modcod  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver  # noqa: E402
from dvbs_tpu_torch.ops import equalizer  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4


def _multipath():
    rng = np.random.default_rng(0)
    syms = constellations.points(modcod.QPSK)[
        rng.integers(0, 4, 16384)].astype(np.complex64)
    ch = np.array([1.0, 0.3, 0.15j])
    rx = np.convolve(syms, ch)[:len(syms)].astype(np.complex64)
    rx += (rng.normal(0, 0.05, len(rx)) +
           1j * rng.normal(0, 0.05, len(rx))).astype(np.complex64)
    return syms, rx


def _clean():
    rng = np.random.default_rng(1)
    return constellations.points(modcod.QPSK)[
        rng.integers(0, 4, 8192)].astype(np.complex64)


def _eq(x):
    return equalizer.lms_equalize(torch.from_numpy(x)).numpy()


def test_qpsk_slice():
    z = torch.tensor([0.3 + 0.2j, -0.1 + 0.5j, 0.2 - 1j, -2 - 3j, 0j],
                     dtype=torch.complex64)
    want = np.asarray(jeq._qpsk_slice(jnp.asarray(z.numpy())))
    got = equalizer._qpsk_slice(z)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


def test_lms_corrects_multipath_as_dvbs_tpu():
    syms, rx = _multipath()
    got = _eq(rx)
    want = np.asarray(jeq.lms_equalize(jnp.asarray(rx)))
    assert got.dtype == np.complex64 and got.shape == rx.shape
    assert np.abs(got - want).max() <= TOL
    evm_in = float(np.mean(np.abs(rx[2000:] - syms[2000:]) ** 2))
    evm_out = float(np.mean(np.abs(got[4000:] - syms[4000:]) ** 2))
    assert evm_out < evm_in * 0.3


def test_lms_transparent_on_clean_signal_as_dvbs_tpu():
    syms = _clean()
    got = _eq(syms)
    want = np.asarray(jeq.lms_equalize(jnp.asarray(syms)))
    assert np.abs(got - want).max() <= TOL
    assert float(np.mean(np.abs(got[2048:] - syms[2048:]) ** 2)) < 1e-3


def test_batch_equals_single_calls():
    syms, rx = _multipath()
    x = np.stack([rx, rx[::-1].copy(), syms])       # C = 3
    got = _eq(x)
    assert got.shape == x.shape
    for c in range(3):
        assert np.abs(got[c] - _eq(x[c])).max() <= 1e-5


def test_receiver_equalize_hook_equals_dvbs_tpu(monkeypatch):
    """tests/test_equalizer.py's block: a static 2-ray echo at 2 symbols
    (0.18 - 0.1j), 9 dB, CFO 0.004 pi, seed 6."""
    cfg = modcod.get_config(4, short=True)
    pkts = dvbs2_mod.random_ts_packets(120, seed=5)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    echo = np.zeros(3, np.complex64)
    echo[0], echo[2] = 1.0, 0.18 - 0.1j
    x = np.convolve(x, echo)[:len(x)]
    y = channel.impair(x, snr_db=9.0, cfo=0.004 * np.pi, seed=6)
    blk = y[:2 * (1 << 15)]
    kw = dict(mc=4, short=True, block_symbols=1 << 15, equalize=True)
    want = JaxReceiver(**kw).process_symbols_block(blk)
    rx = DVBS2Receiver(device="cpu", **kw)
    assert rx.program.equalize
    seen = []
    orig = equalizer.lms_equalize

    def spy(z):
        out = orig(z)
        seen.append((z, out))
        return out
    monkeypatch.setattr(equalizer, "lms_equalize", spy)
    got = rx.process_symbols_block(blk)
    assert len(seen) == 1 and seen[0][1].shape == seen[0][0].shape
    assert want.frame_ok.any(), "no frame decoded with the equalizer on"
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    np.testing.assert_array_equal(got.bbframes, want.bbframes)
    np.testing.assert_array_equal(got.starts, want.starts)
