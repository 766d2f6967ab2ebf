"""dvbs_tpu_torch.tables: every constant table equals dvbs_tpu's.

The port re-derives in numpy the tables that dvbs_tpu builds inside
jax-importing modules. Tolerance: none, every array must be equal
(np.array_equal), since both sides run the same numpy arithmetic.
`jax_receiver_tables` builds the port's per-geometry dict from the JAX
package's own builders; tests/test_torch_bank.py runs the port from it.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from dvbs_tpu.ops import bch as jbch  # noqa: E402
from dvbs_tpu.ops import demap as jdemap  # noqa: E402
from dvbs_tpu.ops import frontend as jfrontend  # noqa: E402
from dvbs_tpu.ops import ldpc_pallas, ldpc_qc  # noqa: E402
from dvbs_tpu.ops import plhdr as jplhdr  # noqa: E402
from dvbs_tpu.ops import plphase as jplphase  # noqa: E402
from dvbs_tpu.ops import plsync as jplsync  # noqa: E402
from dvbs_tpu.spec import modcod, scrambling  # noqa: E402
from dvbs_tpu.tx.channel import rrc_taps  # noqa: E402
from dvbs_tpu_torch import tables  # noqa: E402

torch.set_num_threads(2)


def jax_receiver_tables(cfg, n_symbols: int) -> dict:
    """tables.receiver_tables(cfg, n_symbols), built by dvbs_tpu."""
    rrc = np.asarray(rrc_taps(65, 0.35, 2.0), np.float32)
    mid = jfrontend._mid_taps()
    coef, fmid, fhalf = jfrontend._farrow_coeffs()
    blk = min(jplsync._CORR_BLK, max(128, n_symbols - 89))
    pts, mask0 = jdemap._tables(cfg.constellation, cfg.g1, cfg.g2)
    kt = ldpc_pallas.kernel_tables(cfg.ldpc_table)
    return dict(
        **(jax_pilot_tables(cfg) if cfg.pilots else {}),
        rrc_taps=rrc,
        fir_rrc=jfrontend._fir_matrix(tuple(rrc.tolist()), jfrontend._FIR_BLK),
        mid_taps=mid,
        fir_mid=jfrontend._fir_matrix(tuple(mid.tolist()), jfrontend._FIR_BLK),
        farrow_coef=coef,
        farrow_band=np.asarray([fmid, fhalf], np.float64),
        corr_T=jplsync._template_matrix(blk),
        hdr_syms=jplphase._header_syms(cfg.pls_code),
        descr=jplphase._payload_descramble_phasors(cfg.plframe_len - 90),
        pls_syms=jplhdr._pls_sym_matrix(),
        demap_pts=pts,
        demap_mask0=mask0,
        bch_M=jbch.syndrome_matrix(cfg.framesize, cfg.rate),
        ldpc_g=kt["g_tab"], ldpc_s=kt["s_tab"], ldpc_f=kt["f_tab"],
        bb_mask=scrambling.bb_scrambler_byte_mask(cfg.kbch // 8),
    )


def jax_pilot_tables(cfg) -> dict:
    """The pilot constants of tables.receiver_tables, from dvbs_tpu's
    plphase (its pilot_anchor_phases' dphs times conj of the pilot, and
    models/dvbs2.py's descr[payload_idx - 90])."""
    L = cfg.plframe_len
    descr = jplphase._payload_descramble_phasors(L - 90)
    ps = jplphase.pilot_starts(cfg)
    dphs = np.stack([descr[p - 90:p - 90 + 36] for p in ps])
    return dict(
        pilot_starts=ps,
        pilot_descr=(dphs * np.conj((1 + 1j) / np.sqrt(2))
                     ).astype(np.complex64),
        payload_descr=descr[jplphase.payload_indices(cfg) - 90])


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("table", ["B4", "C4", "B11"])
def test_ldpc_tables_equal(table):
    jq, tq = ldpc_qc.qc_tables(table), tables.qc_tables(table)
    for k in ("G", "q", "N", "K"):
        assert jq[k] == tq[k]
    assert jq["layers"] == tq["layers"]
    _assert_same(jq["perm"], tq["perm"])
    jk, tk = ldpc_pallas.kernel_tables(table), tables.kernel_tables(table)
    assert set(jk) == set(tk)
    for k in jk:
        # F_SYNC is the port's own flag, derived from g_tab
        _assert_same(jk[k], tk[k] & (tables.F_VALID | tables.F_MASK0)
                     if k == "f_tab" else tk[k])


@pytest.mark.parametrize("mc,short,n_symbols,pilots", [
    (4, False, 552960, False),   # the bank's headline geometry
    (4, True, 25344, False),     # short-frame test geometry
    (13, True, 30000, False),    # 8PSK 2/3: other demap / BCH tables
    (18, False, 140000, False),  # 16APSK 2/3: 4 bits per symbol
    (26, True, 40000, False),    # 32APSK 5/6
    (14, False, 377920, True),   # the pilots banks: 8PSK 3/4 (B7),
    (18, False, 284288, True),   # 16APSK 2/3 (B6),
    (24, False, 227392, True),   # 32APSK 3/4 (B7)
    (4, True, 25344, True),      # short QPSK with pilots
])
def test_receiver_tables_equal(mc, short, n_symbols, pilots):
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    jt = jax_receiver_tables(cfg, n_symbols)
    tt = tables.receiver_tables(cfg, n_symbols)
    assert set(jt) == set(tt)
    for k in jt:
        # ldpc_f carries the port's own F_SYNC beside dvbs_tpu's flags
        _assert_same(jt[k], tt[k] & (tables.F_VALID | tables.F_MASK0)
                     if k == "ldpc_f" else tt[k])


@pytest.mark.parametrize("blk", [128, 300, 512])
def test_template_matrix_equal(blk):
    _assert_same(jplsync._template_matrix(blk), tables.template_matrix(blk))
    for a, b in zip(jplsync._templates(), tables.corr_templates()):
        _assert_same(a, b)


@pytest.mark.parametrize("n", [256, 4096, 552960, 1 << 22])
def test_shift_bits_equal(n):
    assert jfrontend._shift_bits_for(n) == tables.shift_bits_for(n)


@pytest.mark.parametrize("mc,short,pilots", [(4, False, False),
                                             (13, True, True),
                                             (18, False, True)])
def test_payload_indices_equal(mc, short, pilots):
    cfg = modcod.get_config(mc, short=short, pilots=pilots)
    _assert_same(jplphase.payload_indices(cfg), tables.payload_indices(cfg))


@pytest.mark.parametrize("mc,short", [(4, False), (14, False), (18, False),
                                      (24, False), (13, True), (24, True)])
def test_pilot_constants_equal(mc, short):
    cfg = modcod.get_config(mc, short=short, pilots=True)
    ps = tables.pilot_starts(cfg)
    _assert_same(ps, jplphase.pilot_starts(cfg))
    assert len(ps) == cfg.pilot_blocks
    descr = jplphase._payload_descramble_phasors(cfg.plframe_len - 90)
    pd = tables.pilot_descramble_phasors(cfg)
    assert pd.shape == (len(ps), 36) and pd.dtype == np.complex64
    for k, p in enumerate(ps):
        # a descrambled pilot block divided by the pilot symbol is 1
        pilot = (1 + 1j) / np.sqrt(2) * np.conj(descr[p - 90:p - 90 + 36])
        np.testing.assert_allclose(pilot * pd[k], 1.0, atol=1e-6)
    rt = tables.receiver_tables(cfg, 30000)
    _assert_same(rt["payload_descr"],
                 descr[jplphase.payload_indices(cfg) - 90])
    assert rt["payload_descr"].shape == (cfg.payload_len,)
    assert "pilot_starts" not in tables.receiver_tables(
        modcod.get_config(mc, short=short), 30000)


def test_to_torch_types():
    cfg = modcod.get_config(4, short=True)
    tt = tables.to_torch(tables.receiver_tables(cfg, 25344), "cpu")
    assert tt["hdr_syms"].dtype == torch.complex64
    assert tt["fir_rrc"].dtype == torch.float32
    assert tt["farrow_band"].dtype == torch.float32
    assert tt["demap_mask0"].dtype == torch.bool
    assert tt["bch_M"].dtype == torch.uint8
    assert tt["ldpc_g"].dtype == torch.int32
    assert all(t.is_contiguous() for t in tt.values())
