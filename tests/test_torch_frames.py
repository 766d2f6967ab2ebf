"""The host's frame decision (dvbs_tpu_torch/models/frames.py), on the CPU;
no JAX.

- unit cases on crafted numpy lanes: the sync gate, the escalation merge,
  the host BCH repair (codewords from bch_spec.encode), the continuity
  delta test, the dummy-slot test, the vote's admission and its
  supermajority;
- the bank stream's host BCH repair: a 2-carrier bank whose step flags
  a gated lane `bch_bad` and corrupts its hard bits and bytes repairs it
  on the host, counts it, and emits the TS bytes of an unfaulted run.

Tolerance: exact throughout (booleans, integers and bytes).
"""
import numpy as np
import pytest
import torch

from dvbs_tpu_torch.models import frames
from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
from dvbs_tpu_torch.models.dvbs2 import frames_per_block
from dvbs_tpu_torch.ops.frontend import pack_cs4
from dvbs_tpu_torch.ops.plsync import DUMMY_LEN
from dvbs_tpu_torch.parallel import mesh
from dvbs_tpu_torch.spec import bch_spec, modcod, scrambling
from dvbs_tpu_torch.tx import channel, dvbs2_mod

torch.set_num_threads(2)

CFG = modcod.get_config(4, short=True)          # QPSK 1/2 short, t = 12


def test_gate_is_at_the_threshold():
    q = np.array([0.5999, 0.6, 0.6001, 0.0], np.float32)
    assert frames.gate(q, 0.6).tolist() == [False, True, True, False]


def _lanes():
    return dict(ldpc_ok=np.array([True, False, False, False]),
                bch_bad=np.array([False, True, True, False]),
                kbch_bytes=np.arange(12, dtype=np.uint8).reshape(4, 3),
                trials=np.array([3, 10, 10, 10], np.int32))


def test_escalation_merges_the_rerun_lanes_only():
    out, calls = _lanes(), []
    sync = np.array([True, True, False, True])
    rerun_out = dict(ldpc_ok=np.array([False, True, True, True]),
                     bch_bad=np.array([True, False, False, True]),
                     kbch_bytes=np.full((4, 3), 200, np.uint8),
                     trials=np.array([32, 7, 9, 32], np.int32))

    def rerun():
        calls.append(1)
        return rerun_out, "hard2"
    retried, hard2 = frames.escalate(out, sync, 10, rerun)
    before = _lanes()
    assert calls == [1] and hard2 == "hard2"
    assert retried.tolist() == [False, True, False, True]
    for lane in (1, 3):
        for k in ("ldpc_ok", "bch_bad", "kbch_bytes"):
            assert np.array_equal(out[k][lane], rerun_out[k][lane]), k
        assert out["trials"][lane] == 10 + rerun_out["trials"][lane]
    for lane in (0, 2):          # converged, and under the gate
        for k in before:
            assert np.array_equal(out[k][lane], before[k][lane]), k


def test_escalation_without_a_lane_to_rerun_calls_nothing():
    out = _lanes()
    out["ldpc_ok"][:] = True

    def rerun():
        raise AssertionError("no lane to rerun")
    retried, hard2 = frames.escalate(out, np.ones(4, bool), 10, rerun)
    assert not retried.any() and hard2 is None


def _codeword(seed):
    msg = np.random.default_rng(seed).integers(0, 2, CFG.kbch, np.uint8)
    return msg, bch_spec.encode(msg, CFG.framesize, CFG.rate)


def test_bch_repair():
    """Lanes: 0 clean; 1 three bits off (repaired); 2 beyond repair; 3
    flagged but under the gate; 4 clean but under the gate."""
    msgs, rows = [], []
    for lane in range(5):
        msg, cw = _codeword(lane)
        msgs.append(msg)
        rows.append(cw.copy())
    rows[1][[5, 700, CFG.nbch - 1]] ^= 1
    far = np.random.default_rng(9).choice(CFG.kbch, 60, replace=False)
    rows[2][far] ^= 1                        # t = 12
    rows[3][[1, 2]] ^= 1
    sent = [scrambling.bb_scramble_bytes(np.packbits(m)) for m in msgs]
    garbage = np.full(CFG.kbch // 8, 0xA5, np.uint8)
    out = dict(bch_bad=np.array([False, True, True, True, False]),
               kbch_bytes=np.stack([sent[0], garbage, garbage, garbage,
                                    sent[4]]))
    sync = np.array([True, True, True, False, False])
    fetched = []

    def row(lane):
        fetched.append(int(lane))
        return rows[lane]
    frame_ok, plain, corr = frames.bch_repair(CFG, sync, out, row)
    assert fetched == [1, 2]                 # no row under the gate
    assert frame_ok.tolist() == [True, True, False, False, False]
    assert corr.tolist() == [0, 3, -1, -1, -1] and corr.dtype == np.int32
    assert np.array_equal(plain[0], sent[0])
    assert np.array_equal(plain[1], sent[1])
    for lane in (2, 3):                      # not repaired: as they came
        assert np.array_equal(plain[lane], garbage)
    assert np.array_equal(out["kbch_bytes"][1], garbage)   # a copy


L = CFG.plframe_len


@pytest.mark.parametrize("k", range(frames.MAX_DUMMIES + 1))
@pytest.mark.parametrize("jitter", [-frames.FRAME_TOL, 0, frames.FRAME_TOL])
def test_continuous_with_up_to_three_dummies_between(k, jitter):
    d = L + k * DUMMY_LEN
    assert frames.continuous(d + jitter, L)
    assert not frames.continuous(d - frames.FRAME_TOL - 1, L)
    assert not frames.continuous(d + frames.FRAME_TOL + 1, L)


def test_four_dummies_between_is_a_gap():
    d = L + (frames.MAX_DUMMIES + 1) * DUMMY_LEN
    assert DUMMY_LEN == 90 + 36 * 90
    for jitter in (-frames.FRAME_TOL, 0, frames.FRAME_TOL):
        assert not frames.continuous(d + jitter, L)
    assert not frames.continuous(0, L)


@pytest.mark.parametrize("pls,conf,dummy,votes", [
    (0, 0.5, True, False), (3, 0.5, True, False), (0, 0.4999, False, False),
    (0, 1.0, True, False), (3, 0.7, True, False), (4, 0.7, False, True),
    (4, 0.6999, False, False), (4, 0.5, False, False),
    (96, 1.0, False, True)])
def test_dummy_slot_and_vote_admission(pls, conf, dummy, votes):
    assert frames.is_dummy(np.int32(pls), conf) == dummy
    assert frames.admits_vote(np.int32(pls), conf) == votes


def test_supermajority():
    assert frames.supermajority(frames.VOTE_FRAMES) == 45
    assert frames.supermajority(6) == 5


# ---------------------------------------------------------------------------
# the bank's host BCH repair, end to end at a tiny geometry
# ---------------------------------------------------------------------------

C = 2
BLOCK = mesh.bank_block_symbols(C, mc=4, short=True, frames_total=4)
N = 2 * BLOCK


def _carrier(seed, cfo, delay):
    pkts = dvbs2_mod.random_ts_packets(80, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, CFG)
    tx = dvbs2_mod.bbframes_to_plframes(bb, CFG).reshape(-1)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=6.0, cfo=cfo,
                       delay_samples=delay, sco_ppm=10.0, seed=seed + 1)
    return pack_cs4(y)


def _stream(sigs, fault=None):
    """A fresh 2-carrier bank fed the signals in half-block chunks, its
    step wrapped by `fault` (given the step's outputs); returns (stream,
    TS bytes per carrier)."""
    st = DVBS2BankStream(C, mc=4, short=True, block_symbols=BLOCK,
                         fec="xla", ingest="cs4", device="cpu")
    if fault is not None:
        step = st.step_fn
        st.step_fn = lambda x: fault(step(x))
    outs = [bytearray() for _ in range(C)]
    for lo in range(0, len(sigs[0]), N // 2):
        for o, b in zip(outs, st.feed([s[lo:lo + N // 2] for s in sigs])):
            o.extend(b)
    return st, [bytes(o) for o in outs]


def test_bank_repairs_a_flagged_lane_on_the_host():
    F = frames_per_block(CFG, BLOCK)
    n = N + 2 * 2 * F * L + 2 * L
    sigs = [_carrier(31, 0.006 * np.pi, 0.3)[:n],
            _carrier(47, -0.011 * np.pi, 0.7)[:n]]
    faulted = []

    def fault(out):
        """The first step: its best-synced lane flagged, three bits of its
        hard row and a byte of its bytes flipped."""
        if not faulted:
            lane = int(out["quality"].reshape(-1).argmax())
            assert out["quality"].reshape(-1)[lane] >= 0.6
            assert bool(out["ldpc_ok"][lane])     # no escalation
            h = out["hard"]
            for b in (3, 1000, CFG.kbch - 2):
                h[lane, b] = 1 - h[lane, b]
            out["kbch_bytes"][lane, 0] ^= 0xFF
            out["bch_bad"][lane] = True
            faulted.append(lane)
        return out
    plain, ts_plain = _stream(sigs)
    st, ts = _stream(sigs, fault)
    assert faulted and plain.stats.bch_repaired == 0
    assert st.stats.bch_repaired == 1 and st.stats.escalations == 0
    assert (st.frames_ok == st.frames_seen).all()
    assert all(len(t) > 0 for t in ts)
    assert ts == ts_plain
