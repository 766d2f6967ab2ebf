"""The port's Viterbi decoders and trellis tables against dvbs_tpu's, on the CPU.

Both packages get the same numpy LLRs, made from a seed: noisy
codewords of the K=7 code (+-2 + N(0, 0.8)), some with every third Y
erased (0 = erasure, as depuncturing leaves it).

Tolerance: none, every table and every decoded bit must be equal.
- tables: both sides run the same numpy arithmetic;
- ops/viterbi.decode_segments against viterbi.decode_segments (the XLA
  decoder) on all bits, wings included: both take first-index argmaxes
  of float32 sums of the same terms with the same normalization;
- ops/viterbi_kernel.decode_plain (kernel C's plain version) against
  decode_segments_pallas(interpret=True) on all bits, wings included:
  both round the LLRs to bf16 and follow the same tournament and
  traceback. On segment cores it also equals the XLA decoder and the
  transmitted bits; in the wings the two decoders differ by design
  (start state, tie-break, normalization).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.ops import viterbi as jv  # noqa: E402
from dvbs_tpu.ops import viterbi_pallas as jvp  # noqa: E402
from dvbs_tpu_torch import tables  # noqa: E402
from dvbs_tpu_torch.ops import viterbi as tv  # noqa: E402
from dvbs_tpu_torch.ops import viterbi_kernel as vk  # noqa: E402
from test_viterbi_pallas import _make_llrs  # noqa: E402

torch.set_num_threads(2)

# (seed, B, T, erasures, wing): the shapes of tests/test_viterbi_pallas.py
# and one segment of the DVB-S bank (core 512 + 2 x 96)
CASES = [(0, 8, 99, False, 24), (7, 130, 151, True, 30),
         (3, 16, 704, True, 96)]


def _case(seed, B, T, erasures):
    llrs, truth = _make_llrs(np.random.default_rng(seed), B, T)
    if erasures:
        llrs[:, ::3, 1] = 0.0
    return llrs, truth


@pytest.mark.parametrize("name", ["trellis", "trellis_k3", "trellis_k4",
                                  "viterbi_tables_k3"])
def test_tables_equal(name):
    if name == "trellis":
        got, ref = tables.trellis(), jv._trellis()
    elif name == "viterbi_tables_k3":
        _, _, _, Bm = jvp._tables_k3()
        got, ref = tables.viterbi_tables_k3(), (jv._trellis_k(3)[0], Bm)
    else:
        k = int(name[-1])
        got, ref = tables.trellis_k(k), jv._trellis_k(k)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", CASES[:2], ids=["8x99", "130x151"])
def test_xla_decoder_bit_exact(case):
    seed, B, T, erasures, _ = case
    llrs, _ = _case(seed, B, T, erasures)
    got = tv.decode_segments(torch.from_numpy(llrs)).numpy()
    ref = np.asarray(jv.decode_segments(jnp.asarray(llrs)))
    assert got.dtype == np.uint8 and got.shape == (B, T)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", CASES, ids=["8x99", "130x151", "16x704"])
def test_kernel_c_plain_matches_pallas(case):
    seed, B, T, erasures, wing = case
    llrs, truth = _case(seed, B, T, erasures)
    got = vk.decode_plain(torch.from_numpy(llrs)).numpy()
    ref = np.asarray(jvp.decode_segments_pallas(jnp.asarray(llrs),
                                                interpret=True, bt=128))
    assert got.dtype == np.uint8 and got.shape == (B, T)
    np.testing.assert_array_equal(got, ref)
    # the dispatcher takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        vk.decode_segments(torch.from_numpy(llrs)).numpy(), got)
    xla = np.asarray(jv.decode_segments(jnp.asarray(llrs)))
    core = slice(wing, T - wing)
    np.testing.assert_array_equal(got[:, core], xla[:, core])
    np.testing.assert_array_equal(got[:, core], truth[:, core])


def test_kernel_c_all_erasures():
    """An all-zero segment: every candidate ties, the tournament keeps
    j = 0, and the traceback from state 0 stays there."""
    llrs = np.zeros((2, 704, 2), np.float32)
    got = vk.decode_plain(torch.from_numpy(llrs)).numpy()
    ref = np.asarray(jvp.decode_segments_pallas(jnp.asarray(llrs),
                                                interpret=True, bt=128))
    np.testing.assert_array_equal(got, ref)
    assert not got.any()


def test_kernel_c_shared_memory_budget():
    """A warp's share: two 68-float strips, two 32-float tables, and per
    step 24 bytes of LLRs and 32 of decisions, rounded up to 16 bytes;
    four segments of the bank's 704 pairs a CTA, four such CTAs an SM
    (228 KB, of which each resident CTA reserves 1 KB); four of the
    single-carrier receiver's 2240 pairs fit a CTA too."""
    assert vk.smem_bytes(704) == -(-(800 + 235 * (24 + 32)) // 16) * 16
    assert vk.CTA_SEGMENTS == 4
    assert vk.smem_bytes(704, 4) == 4 * vk.smem_bytes(704)
    assert 4 * (vk.smem_bytes(704, 4) + 1024) <= 228 * 1024
    assert vk.smem_bytes(2240, 4) <= vk.SMEM_LIMIT
    assert vk.smem_bytes(4000, 4) > vk.SMEM_LIMIT >= vk.smem_bytes(4000)
    assert vk.smem_bytes(1 << 20) > vk.SMEM_LIMIT


def test_segment_and_decode_stream():
    rng = np.random.default_rng(5)
    llrs, truth = _make_llrs(rng, 1, 5000)
    stream = llrs[0]
    stream[1::4, 0] = 0.0
    segs_t, n_t = tv.segment_stream(stream, core=1024, wing=64)
    segs_j, n_j = jv.segment_stream(stream, core=1024, wing=64)
    assert n_t == n_j
    np.testing.assert_array_equal(segs_t, segs_j)
    got = tv.decode_stream(stream, core=1024, wing=64, device="cpu")
    ref = jv.decode_stream(stream, core=1024, wing=64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, truth[0])
