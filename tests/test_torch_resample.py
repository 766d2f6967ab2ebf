"""Kernel B's plain version (dvbs_tpu_torch.ops.resample_kernel) against
dvbs_tpu's resampler: the XLA formulation frontend.resample_windowed and
the Pallas kernel in interpret mode (resample_pallas._resample_batched),
at the three cases of tests/test_resample_pallas.py.

Tolerance: max abs error <= 1e-5 on unit-variance samples, as the JAX
package holds its kernel against its XLA path; both sides evaluate the
same float32 Horner polynomials and tap sums (the XLA side may contract
multiply-adds).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.ops import frontend as jf  # noqa: E402
from dvbs_tpu.ops import resample_pallas as rp  # noqa: E402
from dvbs_tpu_torch import backend, tables  # noqa: E402
from dvbs_tpu_torch.ops import resample_kernel as rk  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5


def _mk(C, S, seed=0, drift=1e-5):
    rng = np.random.default_rng(seed)
    n2 = 2 * S + 64
    y = (rng.normal(size=(C, n2)) + 1j * rng.normal(size=(C, n2))
         ).astype(np.complex64)
    k = np.arange(S)
    t = np.stack([2.0 * k + 0.3 + 0.17 * c + (1 + 0.2 * c) * drift * k
                  for c in range(C)]).astype(np.float32)
    return y, t


def _large_drift():
    rng = np.random.default_rng(2)
    S = 8192
    n2 = 2 * S + 64
    y = (rng.normal(size=(2, n2)) + 1j * rng.normal(size=(2, n2))
         ).astype(np.complex64)
    k = np.arange(S)
    t = np.stack([2.0 * k - 1.4 + 4e-5 * k,
                  2.0 * k + 3.2 - 3e-5 * k]).astype(np.float32)
    return y, t


CASES = {
    "matches_xla": lambda: _mk(3, 8192),
    "ragged_block": lambda: _mk(2, 4096 + 128, seed=1),
    "negative_and_large_drift": _large_drift,
}


def _port(y, t):
    coef, fmid, fhalf = tables.farrow_coeffs()
    return rk.resample(torch.from_numpy(y), torch.from_numpy(t),
                       torch.from_numpy(coef), (fmid, fhalf)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_resampler(case):
    y, t = CASES[case]()
    ref = jax.vmap(jf.resample_windowed)(jnp.asarray(y), jnp.asarray(t))
    assert np.abs(_port(y, t) - np.asarray(ref)).max() <= TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    y, t = CASES[case]()
    ref = rp._resample_batched(jnp.asarray(y), jnp.asarray(t),
                               interpret=True)
    assert np.abs(_port(y, t) - np.asarray(ref)).max() <= TOL


def test_cpu_tensor_takes_plain_version():
    y, t = _mk(2, 1024)
    backend.reset_launches()
    _port(y, t)
    assert backend.LAUNCHES["resample_farrow"] == 0

