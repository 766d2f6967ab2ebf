"""dvbs_tpu_torch.ops.frontend against dvbs_tpu.ops.frontend on the CPU.

Both packages get the same numpy inputs, made from a seed; the JAX side
runs its XLA path (vmapped over carriers where the port batches).

Tolerances and why:
- exact: unpack_cs4, pack_cs4, pack_bits_to_bytes (integer work);
- float stages (agc, coarse CFO, mix, the shift-and-add FIR): max error
  <= 1e-4 of the reference's largest magnitude; both are float32 with
  sums taken in another order;
- bf16-matmul stages (the matched filter, the Oerder-Meyr terms, timing
  recovery): RMS error <= 1e-3 of the reference's RMS. Both round the
  matmul inputs to bf16, so a 1e-7 upstream difference can flip one
  input's rounding (2^-8 relative) and move that output by ~1e-3; the
  RMS over the block is the stable measure.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.ops import frontend as jf  # noqa: E402
from dvbs_tpu.tx import channel  # noqa: E402
from dvbs_tpu_torch import tables  # noqa: E402
from dvbs_tpu_torch.ops import frontend as tf  # noqa: E402

torch.set_num_threads(2)

FLOAT_TOL = 1e-4
BF16_RMS_TOL = 1e-3


def _signal(seed, n_sym, cfo=0.0, delay=0.3, snr=8.0):
    rng = np.random.default_rng(seed)
    sym = ((2 * rng.integers(0, 2, n_sym) - 1) +
           1j * (2 * rng.integers(0, 2, n_sym) - 1)) / np.sqrt(2)
    x = channel.shape(sym.astype(np.complex64), sps=2)
    y = channel.impair(x, snr_db=snr, cfo=cfo, delay_samples=delay,
                       sco_ppm=20.0, seed=seed)
    return np.pad(y, (0, 2 * n_sym - len(y)))


def _bank(n_sym=8192, **kw):
    return np.stack([_signal(11, n_sym, cfo=0.01, **kw),
                     _signal(12, n_sym, cfo=-0.02, **kw)])


def _max_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _rms_rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.sqrt(np.mean(np.abs(got - ref) ** 2) /
                   np.mean(np.abs(ref) ** 2))


def test_cs4_and_bit_packing_exact():
    rng = np.random.default_rng(0)
    y = _bank(2048)
    for s in y:
        np.testing.assert_array_equal(tf.pack_cs4(s), jf.pack_cs4(s))
    packed = rng.integers(0, 256, (3, 4096)).astype(np.uint8)
    np.testing.assert_array_equal(
        tf.unpack_cs4(torch.from_numpy(packed)).numpy(),
        np.asarray(jf.unpack_cs4(jnp.asarray(packed))))
    bits = rng.integers(0, 2, (5, 8 * 111)).astype(np.uint8)
    np.testing.assert_array_equal(
        tf.pack_bits_to_bytes(torch.from_numpy(bits)).numpy(),
        np.asarray(jf.pack_bits_to_bytes(jnp.asarray(bits))))


def test_agc_cfo_mix_float():
    x = _bank()
    xt = torch.from_numpy(x)
    a_t = tf.agc(xt)
    a_j = jax.vmap(jf.agc)(jnp.asarray(x))
    assert _max_rel(a_t.numpy(), a_j) <= FLOAT_TOL
    a = np.array(a_j)
    cfo_t = tf.coarse_cfo_estimate(torch.from_numpy(a))
    cfo_j = jax.vmap(jf.coarse_cfo_estimate)(jnp.asarray(a))
    assert np.max(np.abs(cfo_t.numpy() - np.asarray(cfo_j))) <= FLOAT_TOL
    cfo = np.array(cfo_j)
    m_t = tf.mix(torch.from_numpy(a), torch.from_numpy(cfo))
    m_j = jax.vmap(jf.mix)(jnp.asarray(a), jnp.asarray(cfo))
    assert _max_rel(m_t.numpy(), m_j) <= FLOAT_TOL


@pytest.mark.parametrize("kind", ["rrc", "mid"])
def test_fir_filter_bf16_matmul(kind):
    x = _bank()
    taps = tables.rrc_taps() if kind == "rrc" else tables.mid_taps()
    T = tf.bf16_round(torch.from_numpy(tables.fir_matrix(tuple(taps.tolist()))))
    got = tf.fir_filter(torch.from_numpy(x), torch.from_numpy(taps), T)
    ref = jax.vmap(lambda v: jf.fir_filter(v, taps))(jnp.asarray(x))
    assert _rms_rel(got.numpy(), ref) <= BF16_RMS_TOL


def test_fir_filter_shift_and_add():
    # K < 16 takes the shift-and-add path on both sides (float32)
    x = _bank(1024)
    taps = np.asarray([0.1, -0.25, 0.5, 1.0, 0.5, -0.25, 0.1], np.float32)
    got = tf.fir_filter(torch.from_numpy(x), torch.from_numpy(taps))
    ref = jax.vmap(lambda v: jf.fir_filter(v, taps))(jnp.asarray(x))
    assert _max_rel(got.numpy(), ref) <= FLOAT_TOL


def test_oerder_meyr_terms():
    x = _bank()
    mid = tables.mid_taps()
    T = tf.bf16_round(torch.from_numpy(tables.fir_matrix(tuple(mid.tolist()))))
    got = tf._oerder_meyr_terms(torch.from_numpy(x), torch.from_numpy(mid), T)
    ref = jax.vmap(jf._oerder_meyr_terms)(jnp.asarray(x))
    assert _rms_rel(got.numpy(), ref) <= BF16_RMS_TOL


def _recover(y2, n_windows, tau_hint=None):
    mid = tables.mid_taps()
    T = tf.bf16_round(torch.from_numpy(tables.fir_matrix(tuple(mid.tolist()))))
    coef, fmid, fhalf = tables.farrow_coeffs()
    hint = None if tau_hint is None else torch.from_numpy(tau_hint)
    return tf.recover_symbols_full(
        torch.from_numpy(y2), torch.from_numpy(mid), T,
        torch.from_numpy(coef), (fmid, fhalf), n_windows=n_windows,
        tau_hint=hint)


@pytest.mark.parametrize("case", ["line", "timing_step", "hint"])
def test_recover_symbols_full(case):
    if case == "timing_step":
        # a delay step mid-block breaks the line fit: piecewise path
        a = _bank(8192, delay=0.2)
        b = _bank(8192, delay=0.9)
        y2 = np.concatenate([a[:, :8192], b[:, 8192:]], axis=1)
    else:
        y2 = _bank(8192)
    hint = np.asarray([0.3, np.nan], np.float32) if case == "hint" else None
    z_t, tau_t, end_t = _recover(y2, 16, hint)
    if hint is None:
        z_j, tau_j, end_j = jax.vmap(
            lambda v: jf.recover_symbols_full(v, 16))(jnp.asarray(y2))
    else:
        z_j, tau_j, end_j = jax.vmap(
            lambda v, h: jf.recover_symbols_full(v, 16, h))(
                jnp.asarray(y2), jnp.asarray(hint))
    assert np.max(np.abs(tau_t.numpy() - np.asarray(tau_j))) <= 1e-3
    assert np.max(np.abs(end_t.numpy() - np.asarray(end_j))) <= 1e-3
    assert _rms_rel(z_t.numpy(), z_j) <= BF16_RMS_TOL


def test_matched_filter_and_recover_symbols():
    x = _bank(8192)
    rrc = tables.rrc_taps()
    T = tf.bf16_round(torch.from_numpy(tables.fir_matrix(tuple(rrc.tolist()))))
    y = tf.matched_filter(torch.from_numpy(x), torch.from_numpy(rrc), T)
    y_j = jax.vmap(jf.matched_filter)(jnp.asarray(x))
    assert _rms_rel(y.numpy(), y_j) <= BF16_RMS_TOL
    mid = tables.mid_taps()
    Tm = tf.bf16_round(torch.from_numpy(tables.fir_matrix(tuple(mid.tolist()))))
    coef, fmid, fhalf = tables.farrow_coeffs()
    y2 = np.array(y_j)
    z_t, tau_t = tf.recover_symbols(torch.from_numpy(y2), torch.from_numpy(mid),
                                    Tm, torch.from_numpy(coef), (fmid, fhalf),
                                    n_windows=16)
    z_j, tau_j = jax.vmap(lambda v: jf.recover_symbols(v, 16))(jnp.asarray(y2))
    assert np.max(np.abs(tau_t.numpy() - np.asarray(tau_j))) <= 1e-3
    assert _rms_rel(z_t.numpy(), z_j) <= BF16_RMS_TOL
