"""The port's entry points (dvbs_tpu_torch/entry.py) against dvbs_tpu's
__graft_entry__, on the CPU.

- entry(): the flagship block program (QPSK 1/2 short frames, 2^15
  symbols) on one block of samples equals dvbs_tpu's `_sym_fn` on the
  same block: starts and pls exact, the LLRs within the tolerance below;
- dryrun_multichip(4, device="cpu"): 4 gloo ranks pass every check of
  dvbs_tpu's dryrun_multichip (the multi-carrier step, the {2, 2} grid,
  the sharded bank stream);
- with no card, dryrun_multichip(2) and entry() raise RuntimeError: the
  CPU runs only when asked for.

Tolerances: the LLRs come from a chain of float32 sums run in another
order (and bf16-rounded filter inputs on both sides), scaled up by the
demapper: within 1.0 (one int8 LSB) of dvbs_tpu's (measured 0.52), and
their int8 quantisation within 1 LSB in under 0.5% of the entries, as
in test_torch_stream. The exception is the demapper's clamp, which
halves a magnitude above 127 (constellation.cpp:263-270): a value at
127 on one side may be 63.5 on the other. At most 0.1% of the entries
may sit there (measured 1 of 32,400).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from dvbs_tpu.ops import ldpc_pallas as jlp  # noqa: E402
from dvbs_tpu_torch import entry  # noqa: E402
from dvbs_tpu_torch.ops import ldpc_kernel  # noqa: E402

torch.set_num_threads(2)


def test_entry_program_equals_dvbs_tpu():
    program, (example,) = entry.entry(device="cpu")
    jfn, (jexample,) = jentry.entry()
    assert tuple(example.shape) == (1,) + jexample.shape
    block = entry.multi_carrier_signals(1, example.shape[-1])
    with torch.no_grad():
        out = {k: v[0].numpy() for k, v in
               program(torch.from_numpy(block)).items()}
    want = {k: np.asarray(v) for k, v in jfn(jnp.asarray(block[0])).items()}
    assert out.keys() == want.keys()
    np.testing.assert_array_equal(out["starts"], want["starts"])
    np.testing.assert_array_equal(out["pls"], want["pls"])
    a, b = out["llrs"], want["llrs"]
    assert a.shape == b.shape == (2, 16200)
    hi = np.maximum(np.abs(a), np.abs(b))
    lo = np.minimum(np.abs(a), np.abs(b))
    edge = (hi >= 126.9) & np.isclose(hi, 2 * lo, rtol=1e-3)
    assert edge.mean() <= 1e-3
    assert np.abs(a - b)[~edge].max() <= 1.0
    qa = ldpc_kernel.quantize_llrs(torch.from_numpy(a)).numpy().astype(int)
    qb = np.asarray(jlp.quantize_llrs(jnp.asarray(b))).astype(int)
    d = np.abs(qa - qb)[~edge]
    assert d.max() <= 1 and (d > 0).mean() <= 5e-3


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "8/8 frames decoded across a 4-rank carrier mesh" in out
    assert "2D grid {'carrier': 2, 'time': 2} halo-exchange decode ok" in out
    assert "with contiguous TS" in out


def test_no_card_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
