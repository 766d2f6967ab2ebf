"""The port's single-carrier DVB-S receiver against dvbs_tpu's, on the CPU.

Twins of tests/test_dvbs_e2e.py: models/dvbs.DVBSReceiver (front end,
hint carry, locked chain, process_block) and DVBSStream, at 32k symbols
a block. Both packages get the same numpy signals (tx.dvbs_mod,
tx.channel, seeded). dvbs_tpu ships its soft values through float16
(its TPU transport), the port keeps them float32; and on the CPU
dvbs_tpu's locked chain decodes with its XLA Viterbi decoder
(select_decoder("auto")) while the port runs kernel C's plain version.
The two decoders agree on segment cores, which is all the chain emits,
where both get soft values of the same signs and no path metric is
near a tie: so bits are compared at 12 dB, where every decision is
clear, and the noisy and rotated cases are compared on what the host
makes of them (lock decisions and TS bytes).

Tolerances and why:
- exact: _update_hints (the same float32 numpy code), the lock decision
  (rate, rotation, alignment drop), the locked chain's bits and
  re-encode BER at 12 dB, every TS byte, the integer metrics;
- soft values, scatter and carry: RMS error <= 2 * BF16_RMS_TOL of the
  reference's RMS (the bank front's tolerance, bf16-rounded matched
  filter inputs, plus dvbs_tpu's float16 rounding of its outputs,
  2^-11 relative at most);
- hints: cfo <= 1e-6 rad/sample; NCO phase <= 1e-4 rad (cfo's error
  times the 64k-sample advance, then mod 2 pi in float32); tau <= 1e-3
  (timing recovery's test); theta <= 2e-3 rad (f4's 1e-5 rad/symbol
  error times the 32k symbols of a block, plus the V&V phase).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.models import dvbs as jd  # noqa: E402
from dvbs_tpu.tx import channel, dvbs_mod  # noqa: E402
from dvbs_tpu_torch import backend  # noqa: E402
from dvbs_tpu_torch.models import dvbs as td  # noqa: E402
from dvbs_tpu_torch.ops import viterbi_kernel  # noqa: E402
from test_torch_frontend import BF16_RMS_TOL  # noqa: E402

torch.set_num_threads(2)

BS = 1 << 15                    # symbols per block
N = 2 * BS                      # samples per block
SOFT_TOL = 2 * BF16_RMS_TOL


def _signal(rate="1/2", n_blocks=6, snr_db=12.0, cfo=0.004 * np.pi,
            phase=0.4, delay=0.3, seed=3):
    """A DVB-S carrier of at least n_blocks blocks at 10 ppm clock
    offset: (samples, packets sent)."""
    px, py = jd.dvbs_fec.PUNCTURE[rate]
    n_kept = int(px.sum() + py.sum())
    # a group is 8 * 204 bytes, n_kept coded bits for every p of them;
    # a symbol carries 2 coded bits in 2 samples
    samples_per_group = 8 * 204 * 8 * n_kept // len(px)
    n_groups = -(-n_blocks * N // samples_per_group) + 2
    ts = dvbs_mod.random_ts_groups(n_groups, seed=seed)
    tx = dvbs_mod.DVBSModulator(rate=rate).ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=snr_db, cfo=cfo,
                       phase=phase, delay_samples=delay, sco_ppm=10.0,
                       seed=seed + 1)
    assert len(y) >= n_blocks * N
    return y.astype(np.complex64), ts.reshape(-1, 188)


def _rms_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _check_hints(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert abs(got[0] - ref[0]) <= 1e-6
    d = (got[1] - ref[1] + np.pi) % (2 * np.pi) - np.pi
    assert abs(d) <= 1e-4
    assert abs(got[2] - ref[2]) <= 1e-3
    assert abs(got[3] - ref[3]) <= 2e-3
    assert got[4] == ref[4] == 0


def _contiguous(got: bytes, sent: np.ndarray) -> int:
    """The output is one run of the packets sent: their count."""
    g = np.frombuffer(got, np.uint8).reshape(-1, 188)
    assert len(g) > 0
    i0 = sent.tobytes().find(g[0].tobytes())
    assert i0 >= 0 and i0 % 188 == 0
    np.testing.assert_array_equal(g, sent[i0 // 188:i0 // 188 + len(g)])
    return len(g)


def _blocks(rx, y):
    """process_block over y as test_dvbs_e2e._run does (advance by what
    each block consumed); returns (TS bytes, (rate, rotation, drop,
    locked) of every lock search, blocks run)."""
    locks = []
    orig = rx._try_lock

    def spy(soft):
        orig(soft)
        locks.append((rx.rate, rx.rotation, rx.drop, rx.locked))
    rx._try_lock = spy
    out, used, k = bytearray(), 0, 0
    while used + N <= len(y):
        out.extend(rx.process_block(y[used:used + N]).ts_packets.tobytes())
        used += rx.last_consumed
        k += 1
    return bytes(out), locks, k


@pytest.fixture(scope="module")
def jax_rx():
    """A dvbs_tpu receiver shared by the tests, so that its jitted front
    end and locked chains compile once (each new receiver compiles its
    own): fresh(**kw) puts it in the initial state of
    DVBSReceiver(block_symbols=BS, **kw)."""
    rx = jd.DVBSReceiver(block_symbols=BS)

    def fresh(rate=None):
        new = jd.DVBSReceiver(rate=rate, block_symbols=BS)
        rx.fixed_rate = new.fixed_rate
        rx.set_state(new.get_state())
        rx.__dict__.pop("_try_lock", None)       # a spy of _blocks
        return rx
    return fresh


def _both(jax_rx, y, **kw):
    """The same block loop through both packages' receivers."""
    want = _blocks(jax_rx(**kw), y)
    rx = td.DVBSReceiver(block_symbols=BS, device="cpu", **kw)
    got = _blocks(rx, y)
    return got, want, rx


@pytest.fixture(scope="module")
def half():
    return _signal("1/2")


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carried", [False, True], ids=["first", "carried"])
def test_front(half, jax_rx, carried):
    """The receiver's front end on one block: soft values, next-block
    hints at the block end, the 1024-point scatter."""
    y = half[0][N:2 * N] if carried else half[0][:N]
    hints = np.asarray([0.0118, 2.31, 0.21, 0.7, 0.0] if carried
                       else [0, 0, 0, 0, 1], np.float32)
    rms = np.sqrt(np.mean(np.abs(y) ** 2))
    ri = np.stack([y.real, y.imag]).astype(np.float32) / np.float32(rms)
    ref = [np.asarray(v, np.float32) for v in
           jax_rx()._front(jnp.asarray(ri), jnp.asarray(hints))]
    front = td.ReceiverFront(torch.device("cpu"))
    soft, nh, scat = (v[0].numpy() for v in front(
        torch.from_numpy(y[None]), torch.from_numpy(hints[None])))
    assert soft.shape == ref[0].shape == (N,)
    assert scat.shape == ref[2].shape == (2, td.N_SCATTER)
    assert _rms_rel(soft, ref[0]) <= SOFT_TOL
    assert _rms_rel(scat, ref[2]) <= SOFT_TOL
    _check_hints(nh, ref[1])


@pytest.mark.parametrize("tau_end", [0.0, 0.26, -0.24, 0.74, -1.3, 2.51])
def test_update_hints(tau_end):
    """The hint carry on the host: the same float32 numpy arithmetic,
    equal to the last bit; tau's whole samples fold into the advance."""
    new = np.asarray([0.0123, 5.9, tau_end, -2.2, 0.0], np.float32)
    rxs = [jd.DVBSReceiver.__new__(jd.DVBSReceiver),
           td.DVBSReceiver.__new__(td.DVBSReceiver)]
    for rx in rxs:
        rx._hints = np.asarray([0.0121, 6.1, 0.1, 0.3, 0.0], np.float32)
        rx._update_hints(new, N)
    (a, b) = rxs
    np.testing.assert_array_equal(a._hints, b._hints)
    assert a._hints.dtype == b._hints.dtype == np.float32
    assert a.last_consumed == b.last_consumed == N - round(2 * tau_end)
    assert abs(b._hints[2]) <= 0.25


def test_locked_chain(half, jax_rx):
    """The locked chain on block 3 from the state dvbs_tpu's receiver
    reached after two blocks (locked, carried hints and LLR carry):
    bits and re-encode BER exact, hints, carry and scatter within
    their tolerances; one uint8 buffer comes back."""
    y = half[0]
    jrx = jax_rx()
    used = 0
    for _ in range(2):
        jrx.process_block(y[used:used + N])
        used += jrx.last_consumed
    assert jrx.locked and jrx.drop == 0
    state = jrx.get_state()
    blk = y[used:used + N]
    chain, n_pairs = jrx._get_locked_chain(N)
    rms = np.sqrt(np.mean(np.abs(blk) ** 2))
    ri = np.stack([blk.real, blk.imag]).astype(np.float32) / np.float32(rms)
    ref = {k: np.asarray(v) for k, v in jax.device_get(chain(
        jnp.asarray(ri), jnp.asarray(jrx._hints),
        jnp.asarray(jrx._llr_carry))).items()}

    rx = td.DVBSReceiver(block_symbols=BS, device="cpu")
    rx.set_state(state)

    def checked(llrs):
        """Kernel C's plain version, given only what its CUDA wrapper
        takes (float32 [B, T, 2], contiguous)."""
        backend.check(llrs, "llrs", torch.float32, (llrs.shape[0], 2240, 2),
                      llrs.device)
        return viterbi_kernel.decode_plain(llrs)
    rx._decode_segments = checked
    tchain = rx._get_locked_chain(N)
    assert tchain.n_pairs == n_pairs and tchain.B == -(-n_pairs // 2048)
    buf = tchain(torch.from_numpy(blk[None]),
                 torch.from_numpy(rx._hints[None]),
                 torch.from_numpy(rx._llr_carry))
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    out = tchain.split(buf.numpy())
    np.testing.assert_array_equal(out["bits"], ref["bits"])
    assert out["ber"][0] == ref["ber"][0] < 0.05
    _check_hints(out["hints"], ref["hints"])
    assert _rms_rel(out["scat"].reshape(2, -1), ref["scat"]) <= SOFT_TOL
    assert out["carry"].shape == ref["carry"].shape
    if len(ref["carry"]):
        assert _rms_rel(out["carry"], ref["carry"]) <= SOFT_TOL
    assert rx._get_locked_chain(N) is tchain       # cached per key


# ---------------------------------------------------------------------------
# the receiver across block seams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_rate_auto_detected(jax_rx, rate):
    """Every code rate, found by the lock search, across >= 3 seams of
    the locked chain: the same lock and TS bytes as dvbs_tpu, one
    contiguous run of the packets sent."""
    y, sent = _signal(rate, n_blocks=5,
                      seed=10 + jd.dvbs_fec.RATES.index(rate))
    got, want, rx = _both(jax_rx, y)
    assert got[1] == want[1] and got[1][0][:2] == (rate, 0)
    assert got[1][0][3] and len(got[1]) == 1
    assert got[2] >= 5 and rx.locked and rx.ber < 0.05
    assert got[0] == want[0]
    assert _contiguous(got[0], sent) >= 40


def test_fixed_rate(jax_rx):
    y, sent = _signal("3/4", n_blocks=5, seed=21)
    got, want, rx = _both(jax_rx, y, rate="3/4")
    assert got[1] == want[1] and rx.rate == "3/4"
    assert got[0] == want[0]
    assert _contiguous(got[0], sent) >= 40


@pytest.mark.parametrize("phase", [np.pi / 2 + 0.1, np.pi + 0.05],
                         ids=["rotated", "inverted"])
def test_rotated_and_inverted_carrier(jax_rx, phase):
    """Near 90 degrees the lock takes the rotation hypothesis; near 180
    the deframer takes the inverted sync."""
    y, sent = _signal("1/2", n_blocks=5, phase=phase, seed=31)
    got, want, rx = _both(jax_rx, y)
    assert got[1] == want[1] and rx.locked
    assert got[1][0][1] == (1 if phase < 2 else 0)
    assert got[0] == want[0]
    assert _contiguous(got[0], sent) >= 40


def test_noisy(jax_rx):
    y, sent = _signal("1/2", n_blocks=5, snr_db=5.0, cfo=0.01 * np.pi,
                      seed=41)
    got, want, rx = _both(jax_rx, y)
    assert got[1] == want[1] and rx.locked
    assert got[0] == want[0]
    assert _contiguous(got[0], sent) >= 40
    assert rx.rs_avg_errors < 2.0
