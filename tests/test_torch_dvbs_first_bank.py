"""The port's first-block DVB-S bank against dvbs_tpu's, on the CPU.

Twin of tests/test_dvbs_bank.py: build_dvbs_bank with two carriers of
rate 1/2 at 10 dB, 2^17 samples a block, cs4 and f16 ingest. Both
packages get the same numpy samples. dvbs_tpu on the CPU decodes with
its XLA Viterbi decoder and the port with kernel C's plain version; the
bank emits segment cores only, where the two agree when no path metric
is near a tie, as at this SNR.

Exact: the re-encode BER, n_pairs, every decoded bit, and the TS bytes
each carrier's bits give through the host tail.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.parallel import dvbs_bank as jb  # noqa: E402
from dvbs_tpu.tx import channel, dvbs_mod  # noqa: E402
from dvbs_tpu_torch.models.dvbs import DVBSReceiver  # noqa: E402
from dvbs_tpu_torch.ops.frontend import pack_cs4  # noqa: E402
from dvbs_tpu_torch.parallel import dvbs_bank as tb  # noqa: E402

torch.set_num_threads(2)

C = 2
N = 2 * (1 << 16)


@pytest.fixture(scope="module")
def signals():
    """test_dvbs_bank's two carriers: (samples [C, N], packets sent)."""
    sigs, sents = [], []
    for c in range(C):
        ts = dvbs_mod.random_ts_groups(6, seed=30 + c)
        x = channel.shape(dvbs_mod.DVBSModulator(rate="1/2")
                          .ts_to_symbols(ts), sps=2)
        y = channel.impair(x, snr_db=10.0, cfo=(0.003 + 0.004 * c) * np.pi,
                           delay_samples=0.2 + 0.3 * c, seed=31 + c)
        assert len(y) >= N
        sigs.append(y[:N])
        sents.append(ts.reshape(-1, 188))
    return np.stack(sigs), sents


def _ingest(y, ingest):
    if ingest == "cs4":
        return np.stack([pack_cs4(s) for s in y])
    rms = np.sqrt(np.mean(np.abs(y) ** 2, axis=1, keepdims=True))
    yn = y / rms
    return np.stack([yn.real, yn.imag], axis=1).astype(np.float16)


@pytest.mark.parametrize("ingest", ["cs4", "f16"])
def test_first_block_bank(signals, ingest):
    y, sents = signals
    samples = _ingest(y, ingest)
    jstep, jexample = jb.build_dvbs_bank(C, rate="1/2", block_samples=N,
                                         ingest=ingest)
    ref = jstep(jnp.asarray(samples))
    step, example = tb.build_dvbs_bank(C, rate="1/2", block_samples=N,
                                       ingest=ingest, device="cpu")
    assert samples.shape == example.shape == jexample.shape
    assert samples.dtype == example.dtype == jexample.dtype
    out = step(torch.from_numpy(samples))
    n_pairs = out["n_pairs"]
    assert n_pairs == ref["n_pairs"]
    ber = out["ber"].numpy()
    np.testing.assert_array_equal(ber, np.asarray(ref["ber"]))
    assert (ber < 0.02).all()
    bits = np.unpackbits(out["bits"].numpy(), axis=1)[:, :n_pairs]
    np.testing.assert_array_equal(
        bits, np.unpackbits(np.asarray(ref["bits"]), axis=1)[:, :n_pairs])
    assert not np.array_equal(bits[0], bits[1])
    # each carrier's bits through the host tail: its own packets
    for c in range(C):
        rx = DVBSReceiver(rate="1/2", block_symbols=N // 2, device="cpu")
        got = rx._host_tail(bits[c], None, N // 2).ts_packets
        assert len(got) >= 8
        k0 = sents[c].tobytes().find(got[0].tobytes()) // 188
        np.testing.assert_array_equal(got, sents[c][k0:k0 + len(got)])
    # a second call reuses the lock: the same outputs
    again = step(torch.from_numpy(samples))
    assert torch.equal(again["bits"], out["bits"])


def test_unknown_ingest_and_no_lock():
    with pytest.raises(ValueError):
        tb.build_dvbs_bank(C, block_samples=N, ingest="cs8", device="cpu")
    step, example = tb.build_dvbs_bank(C, block_samples=1 << 14,
                                       ingest="f16", device="cpu")
    noise = np.random.default_rng(5).normal(size=example.shape)
    with pytest.raises(RuntimeError, match="no Viterbi lock"):
        step(torch.from_numpy(noise.astype(np.float16)))
