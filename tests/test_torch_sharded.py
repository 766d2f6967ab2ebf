"""The port's carrier-sharded builds on gloo CPU ranks against dvbs_tpu's
on the conftest's 8-device CPU mesh, with the same numpy inputs.

- build_multi_carrier on 4 ranks, 2 carriers each, of the dry run's
  distinct carriers (QPSK 1/2 short frames, 2^15 symbols): every frame
  decodes, locked == C*F, and hard, trials, ldpc_ok and pls equal
  dvbs_tpu's build_multi_carrier(4, carriers_per_device=2);
- DVBS2BankStream over build_carrier_bank_sharded on 4 ranks at the dry
  run's geometry (short frames, 8 frames a block, n_iters=16, cs8 ingest,
  >= 2 block seams plus flush): each carrier's TS bytes equal those of
  dvbs_tpu's DVBS2BankStream over its build_carrier_bank_sharded(4);
- build_carrier_bank_sharded on 2 ranks of 2 carriers (cs4, 3 dB, one
  LDPC sweep): the gathered step outputs, each rank's own llrs lanes and
  the full-budget escalation of them equal the single-device
  build_carrier_bank(fec="xla");
- every rank returns the same gathered outputs.

Tolerances: exact for bits, bytes and integer decisions (hard bits are
the codewords both decoders converge to, TS bytes the parser's output
of them; trials, ldpc_ok, bch_bad, pls and starts come from the same
float32 schedules). Float fields of the sharded bank against the
single-device bank: within 1e-5 of the field's largest magnitude (each
rank batches 2 carriers where the bank batches 4, so float32 sums run
in another order); quality against dvbs_tpu within 1e-3.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.models.bank_stream import DVBS2BankStream as JaxBankStream  # noqa: E402,E501
from dvbs_tpu.parallel import mesh as jmesh  # noqa: E402
from dvbs_tpu_torch import entry  # noqa: E402
from dvbs_tpu_torch.parallel import collectives, mesh  # noqa: E402
from test_torch_timeshard import _same_on_every_rank  # noqa: E402

torch.set_num_threads(2)

D = 4


@pytest.mark.skipif(len(jax.devices()) < D, reason="needs a 4-device mesh")
def test_multi_carrier_four_ranks_equal_dvbs_tpu():
    cpd = 2
    samples = entry.multi_carrier_signals(D * cpd, 2 * entry.BLOCK)
    res = collectives.spawn(entry.multi_carrier_rank, D, "cpu", samples, cpd)
    _same_on_every_rank(res)
    got = res[0]
    C, F = got["ldpc_ok"].shape
    assert C == D * cpd and got["hard"].shape == (C, F, 16200)
    assert got["ldpc_ok"].all()
    assert got["locked"].tolist() == [C * F]
    step, example, _ = jmesh.build_multi_carrier(
        D, carriers_per_device=cpd, mc=4, short=True,
        block_symbols=entry.BLOCK)
    assert example.shape == samples.shape
    want = {k: np.asarray(v) for k, v in step(samples).items()}
    for k in ("hard", "trials", "ldpc_ok", "pls", "locked"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["quality"], want["quality"], atol=1e-3)


@pytest.mark.skipif(len(jax.devices()) < D, reason="needs a 4-device mesh")
def test_sharded_bank_stream_same_ts_as_dvbs_tpu():
    bs = mesh.bank_block_symbols(D, mc=4, short=True, frames_total=8)
    F = 2
    L = 8190
    need = 2 * bs + 2 * 2 * F * L + 2 * L
    sigs, sents = entry.stream_signals(D, need)
    res = collectives.spawn(entry.bank_stream_rank, D, "cpu", sigs, bs)
    for r in res[1:]:
        assert r["ts"] == res[0]["ts"]
        np.testing.assert_array_equal(r["frames_ok"], res[0]["frames_ok"])
    got = res[0]
    assert got["F"] == F
    assert (got["frames_ok"] == got["frames_seen"]).all()
    assert (got["frames_seen"] >= 3 * F).all()

    program = jmesh.build_carrier_bank_sharded(
        D, carriers_per_device=1, mc=4, short=True, block_symbols=bs,
        n_iters=16)
    st = JaxBankStream(D, mc=4, short=True, block_symbols=bs, ingest="cs8",
                       program=program)
    want = [bytearray() for _ in range(D)]
    for lo in range(0, need, 2 * bs):
        for o, ts in zip(want, st.feed([s[lo:lo + 2 * bs] for s in sigs])):
            o.extend(ts)
    for o, ts in zip(want, st.flush()):
        o.extend(ts)
    np.testing.assert_array_equal(got["frames_seen"], st.frames_seen)
    for c in range(D):
        assert got["ts"][c] == bytes(want[c]), f"carrier {c}"
        assert len(got["ts"][c]) >= 188 * 10
        assert sents[c].find(got["ts"][c][:188 * 5]) >= 0


def test_sharded_bank_step_and_escalation_equal_the_bank():
    """2 ranks of 2 carriers (cs4, 3 dB): the gathered step outputs and
    the full-budget escalation equal the single-device
    build_carrier_bank (fec="xla") on the same block, field by field;
    the llrs stay on their rank, each rank's equal to its own lanes of
    the bank's."""
    from dvbs_tpu_torch.ops.frontend import pack_cs4
    from dvbs_tpu_torch.spec import modcod
    ranks, cpd = 2, 2
    bs = mesh.bank_block_symbols(ranks * cpd, mc=4, short=True,
                                 frames_total=8)
    cfg = modcod.get_config(4, short=True)
    x = np.stack([pack_cs4(entry._signal(cfg, 60, 600 + c, 3.0,
                                         0.003 * (c + 1) * np.pi, 0.1 * c,
                                         700 + c)[0][:2 * bs])
                  for c in range(ranks * cpd)])
    res = collectives.spawn(entry.bank_step_rank, ranks, "cpu", x, cpd, bs,
                            1)
    step, example, escalate = mesh.build_carrier_bank(
        ranks * cpd, mc=4, short=True, block_symbols=bs, n_iters=1,
        fec="xla", ingest="cs4", stream_outputs=True, device="cpu")
    assert example.shape == x.shape
    with torch.no_grad():
        out = step(torch.from_numpy(x))
        esc = escalate(out["llrs"])
    assert not out["ldpc_ok"].all()         # 1 sweep leaves frames open
    assert esc["ldpc_ok"].sum() > out["ldpc_ok"].sum()
    lanes = cpd * (out["llrs"].shape[0] // (ranks * cpd))
    for r, (got, got_esc) in enumerate(res):
        assert got.keys() == out.keys() and got_esc.keys() == esc.keys()
        for want, have in ((out, got), (esc, got_esc)):
            for k, v in want.items():
                v = v.numpy()
                if k == "llrs":
                    v = v[r * lanes:(r + 1) * lanes]
                    assert have[k].shape == v.shape, k
                if v.dtype.kind == "f":
                    # float32 sums over another batch of carriers
                    tol = 1e-5 * max(1.0, float(np.abs(v).max()))
                    assert np.abs(have[k] - v).max() <= tol, k
                else:
                    np.testing.assert_array_equal(have[k], v, err_msg=k)
