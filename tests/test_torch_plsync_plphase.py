"""PL sync, phase chain, PLS detect, demap and deinterleave of the port
against dvbs_tpu, on the same numpy inputs.

The symbol stream is a 2-carrier, short-frame QPSK 1/2 DVB-S2 signal at
6 dB, brought to the symbol grid by dvbs_tpu's own front end; each stage
then gets the JAX stage's input, so errors do not compound.

Tolerances and why:
- exact: frame starts, PLS indices, extracted frames and the
  deinterleaver (index work on equal inputs);
- scores, phases, frequencies, confidences: max abs error <= 1e-3
  (float32 sums in another order; correlate also rounds its inputs to
  bf16, so a 1e-7 difference can flip one rounding);
- LLRs: max abs error <= 1e-3 of the largest |LLR| (exp/log in float32
  at the reference's x50 scale).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dvbs_tpu.ops import demap as jdemap  # noqa: E402
from dvbs_tpu.ops import frontend as jf  # noqa: E402
from dvbs_tpu.ops import plhdr as jplhdr  # noqa: E402
from dvbs_tpu.ops import plphase as jph  # noqa: E402
from dvbs_tpu.ops import plsync as jsync  # noqa: E402
from dvbs_tpu.spec import interleaver as jil  # noqa: E402
from dvbs_tpu.spec import modcod  # noqa: E402
from dvbs_tpu.tx import channel, dvbs2_mod  # noqa: E402
from dvbs_tpu_torch import tables  # noqa: E402
from dvbs_tpu_torch.ops import demap, interleaver, plhdr, plphase, plsync  # noqa: E402,E501
from dvbs_tpu_torch.parallel.mesh import bank_block_symbols  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-3
MC, SHORT = 4, True
CFG = modcod.get_config(MC, short=SHORT)
L = CFG.plframe_len


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.max(np.abs(got - ref)) <= tol, np.max(np.abs(got - ref))


@pytest.fixture(scope="module")
def stream():
    """z [2, S] symbols from dvbs_tpu's front end, and the frame count."""
    block = bank_block_symbols(2, mc=MC, short=SHORT, frames_total=4)
    ys = []
    for seed, cfo in ((7, 0.004 * np.pi), (8, -0.009 * np.pi)):
        pkts = dvbs2_mod.random_ts_packets(300, seed=seed)
        bb = dvbs2_mod.ts_to_bbframes(pkts, CFG)
        tx = dvbs2_mod.bbframes_to_plframes(bb, CFG).reshape(-1)
        y = channel.impair(channel.shape(tx, sps=2), snr_db=6.0, cfo=cfo,
                           delay_samples=0.3, seed=seed)
        ys.append(y[:2 * block])

    def front(y):
        x = jf.agc(y)
        x = jf.mix(x, jf.coarse_cfo_estimate(x))
        return jf.recover_symbols(jf.matched_filter(x), n_windows=16)[0]
    z = np.asarray(jax.vmap(front)(jnp.asarray(np.stack(ys))))
    F = (block - 2 * 256 - 90) // L - 1
    return z, F


@pytest.fixture(scope="module")
def located(stream):
    z, F = stream
    score, cvec = jax.vmap(jsync.correlate)(jnp.asarray(z))
    starts, quality = jax.vmap(
        lambda s: jsync.locate_frames(s, L, F, margin=256))(score)
    frames = jax.vmap(lambda zz, s: jsync.extract_frames(zz, s, L))(
        jnp.asarray(z), starts)
    return (np.asarray(score), np.asarray(cvec), np.asarray(starts),
            np.asarray(quality), np.asarray(frames))


def test_correlate(stream, located):
    z, _ = stream
    score_j, cvec_j = located[:2]
    T = torch.from_numpy(tables.template_matrix(tables.corr_blk(z.shape[1])))
    score, cvec = plsync.correlate(_t(z), T)
    _close(score.numpy(), score_j)
    _close(cvec.numpy(), cvec_j)


def test_locate_and_extract(stream, located):
    z, F = stream
    score_j, _, starts_j, quality_j, frames_j = located
    starts, quality = plsync.locate_frames(_t(score_j), L, F, margin=256)
    np.testing.assert_array_equal(starts.numpy(), starts_j)
    np.testing.assert_array_equal(quality.numpy(), quality_j)
    # the port's own score locates the same frames (clean signal)
    T = torch.from_numpy(tables.template_matrix(tables.corr_blk(z.shape[1])))
    s2, _ = plsync.locate_frames(plsync.correlate(_t(z), T)[0], L, F,
                                 margin=256)
    np.testing.assert_array_equal(s2.numpy(), starts_j)
    frames = plsync.extract_frames(_t(z), _t(starts_j), L)
    np.testing.assert_array_equal(frames.numpy(), frames_j)


def test_locate_fallback_and_clamp():
    """Weak first peak -> per-frame relocation; starts near the block
    end -> clamped extraction windows, as dynamic_slice clamps."""
    rng = np.random.default_rng(5)
    n, Lf, F = 6000, 1000, 4
    score = rng.uniform(0, 0.3, (2, n)).astype(np.float32)
    score[0, [300, 1300, 2450, 3300]] = [0.9, 0.9, 0.95, 0.2]
    score[1, [100, 1100, 2100, 3600]] = [0.7, 0.8, 0.9, 0.9]
    sj, qj = jax.vmap(lambda s: jsync.locate_frames(s, Lf, F, margin=50))(
        jnp.asarray(score))
    st, qt = plsync.locate_frames(_t(score), Lf, F, margin=50)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    z = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
         ).astype(np.complex64)
    starts = np.asarray([[0, 10, 5500, 5999], [-3, 4000, 5001, 20]],
                        np.int32)
    fj = jax.vmap(lambda zz, s: jsync.extract_frames(zz, s, Lf))(
        jnp.asarray(z), jnp.asarray(starts))
    ft = plsync.extract_frames(_t(z), _t(starts), Lf)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def test_phase_chain(located):
    frames = located[4]                                 # [2, F, L]
    hdr = torch.from_numpy(tables.header_syms(CFG.pls_code))
    fed_j = jax.vmap(lambda f: jph.coarse_fed_common(f, CFG))(frames)
    _close(plphase.coarse_fed_common(_t(frames), hdr).numpy(), fed_j)
    F = frames.shape[1]
    fed = np.broadcast_to(np.asarray(fed_j)[:, None], (2, F)).copy()
    f1_j = np.asarray(jax.vmap(jph.apply_freq)(frames, fed))
    _close(plphase.apply_freq(_t(frames), _t(fed)).numpy(), f1_j)
    flr_j = jax.vmap(lambda f: jph.lr_freq_common(f, CFG))(f1_j)
    _close(plphase.lr_freq_common(_t(f1_j), hdr).numpy(), flr_j)
    th_j = jax.vmap(lambda f: jph.header_phase(f, CFG))(f1_j)
    _close(plphase.header_phase(_t(f1_j), hdr).numpy(), th_j)


def test_vv_track_and_derotate(located):
    frames = located[4]
    descr = tables.payload_descramble_phasors(L - 90)
    payload = (frames[..., 90:] * descr).astype(np.complex64)
    theta0 = np.zeros(payload.shape[:2], np.float32)
    vv_j = jax.vmap(jph.qpsk_vv_track)(payload, theta0)
    vv = plphase.qpsk_vv_track(_t(payload), _t(theta0))
    _close(vv.numpy(), vv_j)
    d_j = jph.derotate(payload, vv_j)
    _close(plphase.derotate(_t(payload), _t(vv_j)).numpy(), d_j)


def test_detect_pls(located):
    frames = located[4]
    th = np.asarray(jax.vmap(lambda f: jph.header_phase(f, CFG))(frames))
    hdr = np.asarray(jph.derotate(frames[..., :90], th[..., None]))
    idx_j, conf_j = jax.vmap(jplhdr.detect_pls)(hdr)
    idx, conf = plhdr.detect_pls(_t(hdr),
                                 torch.from_numpy(tables.pls_sym_matrix()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert (idx.numpy() == CFG.pls_code).all()
    _close(conf.numpy(), conf_j)


@pytest.mark.parametrize("mc", [4, 13, 18, 26])
def test_soft_demap(mc):
    cfg = modcod.get_config(mc, short=True)
    rng = np.random.default_rng(mc)
    pts = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)[0]
    syms = (pts[rng.integers(0, len(pts), (2, 3, 500))] +
            0.2 * (rng.normal(size=(2, 3, 500)) +
                   1j * rng.normal(size=(2, 3, 500)))).astype(np.complex64)
    ref = np.asarray(jdemap.soft_demap(jnp.asarray(syms), cfg.constellation,
                                       cfg.g1, cfg.g2))
    p, m0 = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)
    got = demap.soft_demap(_t(syms), cfg.constellation,
                           torch.from_numpy(p), torch.from_numpy(m0)).numpy()
    _close(got, ref, TOL * np.abs(ref).max())


@pytest.mark.parametrize("mc,short", [(4, False), (12, True), (13, False),
                                      (18, True), (26, False)])
def test_deinterleave_exact(mc, short):
    cfg = modcod.get_config(mc, short=short)
    m = cfg.mod_bits
    rng = np.random.default_rng(mc)
    llrs = rng.normal(size=(2, cfg.nldpc // m, m)).astype(np.float32)
    ref = jil.deinterleave_device(jnp.asarray(llrs), cfg.constellation,
                                  cfg.framesize, cfg.rate)
    got = interleaver.deinterleave(_t(llrs), cfg.constellation,
                                   cfg.framesize, cfg.rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
