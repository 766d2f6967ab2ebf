"""The port's time- and grid-sharded receivers on gloo CPU ranks against
dvbs_tpu's serial block receiver on the same windows.

Each sharded build runs in ranks spawned by parallel.collectives.spawn
(one process a rank, one thread each); every rank returns the gathered
outputs. The reference for a wrap-free shard is dvbs_tpu's receiver on
the window that shard sees: its symbol program (`_sym_fn`) and full
trial budget FEC (`_fec2_fn`) on the float32 window, as dvbs_tpu's own
time-sharded step runs them, and `process_symbols_block` for the frame
verdicts and bytes (at the CLI geometry the bytes are dvbs_tpu's hard
bits packed and BB-descrambled, which spares a pass-1 FEC compile).

Geometries: QPSK 1/2 short frames at 2^15 symbols (A = 32,760 samples a
shard, a halo of 32,776 > A: two hops around the ring), the CLI's
normal frames at 2^17 (A = 194,940, halo 67,204: one hop), and a ring
of one, where a rank is its own neighbour.

Tolerances: exact everywhere. starts are integer decisions, hard bits
are the LDPC codewords the decoders converge to, kbch bytes are those
bits packed and descrambled.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from dvbs_tpu.models.dvbs2 import DVBS2Receiver as JaxReceiver  # noqa: E402
from dvbs_tpu.spec import modcod  # noqa: E402
from dvbs_tpu.spec.scrambling import bb_scramble_bytes  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch import entry  # noqa: E402
from dvbs_tpu_torch.parallel import collectives  # noqa: E402

torch.set_num_threads(2)

B = 1 << 15


def _signal(cfg, n_pkts, pkt_seed, snr_db, cfo, delay, seed):
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=pkt_seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, cfg)
    tx = dvbs2_mod.bbframes_to_plframes(bb, cfg).reshape(-1)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=snr_db, cfo=cfo,
                       delay_samples=delay, seed=seed)
    return y, [fr.tobytes() for fr in bb]


def _ri(x):
    return np.stack([x.real, x.imag]).astype(np.float32)


def _shards(y, D, A):
    return np.stack([_ri(y[d * A:(d + 1) * A]) for d in range(D)])


@pytest.fixture(scope="module")
def jrx_short():
    return JaxReceiver(mc=4, short=True, block_symbols=B)


def _serial(jrx, window):
    """dvbs_tpu's symbol program and full-budget FEC on one window."""
    out = jrx._sym_fn(_ri(window))
    fd = jrx._fec2_fn(out["llrs"])
    return {k: np.asarray(v) for k, v in
            dict(starts=out["starts"], hard=fd["hard"],
                 trials=fd["trials"], ldpc_ok=fd["ldpc_ok"]).items()}


def _check_shard(jrx, got: dict, idx, window):
    """Shard idx of the gathered outputs equals the serial receiver on
    the window: starts and hard bit-exact, every frame decoded, the
    bytes equal to process_symbols_block's."""
    want = _serial(jrx, window)
    assert got["ldpc_ok"][idx].all() and want["ldpc_ok"].all()
    np.testing.assert_array_equal(got["starts"][idx], want["starts"])
    np.testing.assert_array_equal(got["hard"][idx], want["hard"])
    ref = jrx.process_symbols_block(window)
    assert ref.frame_ok.all()
    np.testing.assert_array_equal(got["kbch_bytes"][idx], ref.bbframes)


def _same_on_every_rank(res):
    for r in res[1:]:
        assert r.keys() == res[0].keys()
        for k in r:
            np.testing.assert_array_equal(r[k], res[0][k], err_msg=k)


def test_time_sharded_four_ranks_equal_serial_blocks(jrx_short):
    D = 4
    cfg = modcod.get_config(4, short=True)
    y, sent = _signal(cfg, 1600, 21, 8.0, 0.006 * np.pi, 0.3, 22)
    A = 2 * jrx_short.n_frames * cfg.plframe_len
    assert (2 * B - A + A - 1) // A == 2            # the halo spans 2 hops
    res = collectives.spawn(entry.time_sharded_rank, D, "cpu",
                            _shards(y, D, A))
    _same_on_every_rank(res)
    got = res[0]
    F = jrx_short.n_frames
    assert got["hard"].shape == (D, F, cfg.nldpc)
    assert got["cfo"].shape == (D, 1) and got["starts"].shape == (D, F)
    for d in range(D - 1):              # the last shard reads wrapped halo
        _check_shard(jrx_short, got, d, y[d * A:d * A + 2 * B])
    # the frames across shards are the BBFRAMEs sent, contiguously
    frames = [np.packbits(got["hard"][d, f, :cfg.kbch]).tobytes()
              for d in range(D - 1) for f in range(F)]
    first = sent.index(frames[0])
    assert frames == sent[first:first + len(frames)]


def test_grid_sharded_two_by_two(jrx_short):
    """{carrier: 2, time: 2} on 4 ranks: each carrier's halo ring is its
    own, so distinct carriers decode their own streams, and each
    wrap-free shard (c, 0) equals the serial receiver on its window."""
    C, T = 2, 2
    cfg = modcod.get_config(4, short=True)
    A = 2 * jrx_short.n_frames * cfg.plframe_len
    sigs, sents = [], []
    for c in range(C):
        y, sent = _signal(cfg, 500, 30 + c, 8.0, (0.002 + 0.002 * c) * np.pi,
                          0.1 * c, 40 + c)
        sigs.append(y)
        sents.append(sent)
    shards = np.stack([_shards(y, T, A) for y in sigs])
    assert shards.shape == (C, T, 2, A)
    res = collectives.spawn(entry.grid_sharded_rank, C * T, "cpu", shards)
    _same_on_every_rank(res)
    got = res[0]
    assert got["hard"].shape[:2] == (C, T)
    for c in range(C):
        _check_shard(jrx_short, got, (c, 0), sigs[c][:2 * B])
        frames = [np.packbits(h[:cfg.kbch]).tobytes()
                  for h in got["hard"][c, 0]]
        first = sents[c].index(frames[0])
        assert frames == sents[c][first:first + len(frames)]
    assert not np.array_equal(got["hard"][0, 0], got["hard"][1, 0])


def test_ring_of_one_is_the_identity(jrx_short):
    """World size 1: the rank is its own right neighbour, so its window
    is its shard repeated, as dvbs_tpu's ppermute with the pair (0, 0)
    makes it."""
    cfg = modcod.get_config(4, short=True)
    y, _ = _signal(cfg, 400, 25, 8.0, 0.004 * np.pi, 0.2, 26)
    A = 2 * jrx_short.n_frames * cfg.plframe_len
    res = collectives.spawn(entry.time_sharded_rank, 1, "cpu",
                            _shards(y, 1, A))
    wrapped = np.concatenate([y[:A]] * 3)[:2 * B]
    want = _serial(jrx_short, wrapped)
    np.testing.assert_array_equal(res[0]["starts"][0], want["starts"])
    np.testing.assert_array_equal(res[0]["hard"][0], want["hard"])
    np.testing.assert_array_equal(res[0]["ldpc_ok"][0], want["ldpc_ok"])


def test_time_sharded_cli_geometry_one_hop():
    """Normal frames at the CLI's 2^17 symbols on 2 ranks: the halo
    (67,204 samples) is within one shard (194,940). Shard 0 equals
    dvbs_tpu's serial receiver at that geometry on the same window."""
    D, block = 2, 1 << 17
    cfg = modcod.get_config(4, short=False)
    jrx = JaxReceiver(mc=4, short=False, block_symbols=block)
    A = 2 * jrx.n_frames * cfg.plframe_len
    assert A == 194940 and 2 * block - A == 67204
    y, sent = _signal(cfg, 300, 23, 6.0, 0.004 * np.pi, 0.3, 24)
    res = collectives.spawn(entry.time_sharded_rank, D, "cpu",
                            _shards(y, D, A), 4, False, block)
    _same_on_every_rank(res)
    want = _serial(jrx, y[:2 * block])
    got = res[0]
    assert got["ldpc_ok"][0].all() and want["ldpc_ok"].all()
    for k in ("starts", "hard", "trials"):
        np.testing.assert_array_equal(got[k][0], want[k], err_msg=k)
    np.testing.assert_array_equal(
        got["kbch_bytes"][0],
        bb_scramble_bytes(np.packbits(want["hard"][:, :cfg.kbch], axis=-1)))
    frames = [np.packbits(h[:cfg.kbch]).tobytes() for d in range(D - 1)
              for h in got["hard"][d]]
    first = sent.index(frames[0])
    assert frames == sent[first:first + len(frames)]
