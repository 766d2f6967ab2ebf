"""Kernel A's plain version (dvbs_tpu_torch.ops.ldpc_kernel.decode_plain)
against dvbs_tpu's int8 layered decoder, ldpc_pallas.decode_qc_pallas
run in Pallas interpret mode, and the layout glue of ldpc_qc.

Tolerances and why:
- hard bits, n_bad and trials: bit-exact (integer arithmetic, the same
  schedule);
- llr_to_post / post_to_hard: exact (reshapes and transposes);
- quantize_llrs: +-1 LSB on at most 1e-4 of the entries (the per-frame
  rms is a float32 sum taken in another order, which can move a value
  sitting at a rounding boundary).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.ops import ldpc_pallas, ldpc_qc  # noqa: E402
from dvbs_tpu.spec import ldpc_spec  # noqa: E402
from dvbs_tpu_torch import backend, tables  # noqa: E402
from dvbs_tpu_torch.ops import ldpc_kernel  # noqa: E402
from dvbs_tpu_torch.ops import ldpc_qc as tqc  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def noisy_case():
    """128 C4 codewords at 3 dB (tests/test_ldpc_pallas.py's case)."""
    code = ldpc_spec.get_code("C4")
    rng = np.random.default_rng(0)
    m = rng.integers(0, 2, (ldpc_pallas.B, code.K)).astype(np.uint8)
    cw = code.encode(m)
    x = 1.0 - 2.0 * cw.astype(np.float32)
    sigma = np.sqrt(10 ** (-3.0 / 10))
    y = x + rng.normal(0, sigma, x.shape).astype(np.float32)
    llr_f = (2.0 * y / sigma ** 2).astype(np.float32)
    llr = np.asarray(ldpc_pallas.quantize_llrs(jnp.asarray(llr_f)))
    return llr_f, llr, cw


def _both(llr, table, n_iters, early_exit):
    ref = ldpc_pallas.decode_qc_pallas(jnp.asarray(llr), table,
                                       n_iters=n_iters, interpret=True,
                                       early_exit=early_exit)
    got = ldpc_kernel.decode(torch.from_numpy(np.array(llr)), table,
                             n_iters=n_iters, early_exit=early_exit)
    return [g.numpy() for g in got], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("n_iters,early_exit", [(1, False), (3, False),
                                                (12, True)])
def test_plain_bit_exact_c4(noisy_case, n_iters, early_exit):
    _, llr, cw = noisy_case
    got, ref = _both(llr, "C4", n_iters, early_exit)
    for name, g, r in zip(("hard", "n_bad", "trials"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert got[0].dtype == np.uint8
    assert got[1].dtype == got[2].dtype == np.int32
    if early_exit:
        assert (got[1] == 0).all() and np.array_equal(got[0], cw)
        assert (got[2] >= 1).all() and (got[2] < n_iters).all()


def test_plain_bit_exact_b4_one_sweep():
    t = tables.qc_tables("B4")
    rng = np.random.default_rng(1)
    llr = rng.integers(-25, 26, (ldpc_pallas.B, t["N"])).astype(np.int8)
    got, ref = _both(llr, "B4", 1, False)
    for name, g, r in zip(("hard", "n_bad", "trials"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("table", ["C4", "B4"])
def test_post_layout_exact(table):
    t = tables.qc_tables(table)
    G, q = t["G"], t["q"]
    rng = np.random.default_rng(3)
    llr = rng.integers(-127, 128, (5, t["N"])).astype(np.int8)
    pj = np.asarray(ldpc_qc.llr_to_post(jnp.asarray(llr), G, q))
    pt = tqc.llr_to_post(torch.from_numpy(llr), G, q).numpy()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(
        tqc.post_to_hard(torch.from_numpy(np.array(pj)), G, q).numpy(),
        np.asarray(ldpc_qc.post_to_hard(jnp.asarray(pj), G, q)))


def test_quantize_llrs(noisy_case):
    llr_f, llr, _ = noisy_case
    got = ldpc_kernel.quantize_llrs(torch.from_numpy(llr_f)).numpy()
    assert got.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - llr.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


def test_calls_of_128_frames(noisy_case):
    """decode_calls cuts 133 frames into a 128-frame call and a 5-frame
    call, with no padding; both decode to the transmitted codewords."""
    _, llr, cw = noisy_case
    x = torch.from_numpy(np.concatenate([llr, llr[:5]]))
    hard, n_bad, trials = ldpc_kernel.decode_calls(x, "C4", 12)
    assert hard.shape == (133, cw.shape[1])
    assert (n_bad.numpy() == 0).all()
    np.testing.assert_array_equal(hard[:128].numpy(), cw)
    np.testing.assert_array_equal(hard[128:].numpy(), cw[:5])


def test_cpu_tensor_takes_plain_version(noisy_case):
    _, llr, _ = noisy_case
    backend.reset_launches()
    ldpc_kernel.decode(torch.from_numpy(np.array(llr[:4])), "C4", n_iters=2)
    assert backend.LAUNCHES["ldpc_layered"] == 0

