#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvbs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: name and power limit (nvidia-smi), TF32 off;
2. every phase's signals, made at once in worker processes (one per
   CPU core, up to 8) while the CUDA kernels build from
   dvbs_tpu_torch/csrc (one nvcc per source, cached in build/kernels/
   by a hash of the sources);
3. kernel A (int8 layered LDPC) against its plain PyTorch version at
   [128, 64800] on the LDPC tables B4, B7 and B6: one fixed sweep on
   random int8 LLRs, and 12 sweeps with early exit on noisy codewords
   near each code's threshold. hard, n_bad and trials must be equal;
4. kernel B (barrel+Farrow resampler) against its plain version at
   C=8 and each bank's symbols per block (552960 for QPSK 1/2; 377920,
   284288 and 227392 for the pilots banks; 262144 for DVB-S) with
   drifting positions of both signs: max abs error <= 1e-5;
5. kernel C (radix-8 Viterbi ACS + traceback) against its plain version,
   bit for bit on every output bit: noisy codewords at the DVB-S bank's
   shape [4096, 704, 2] with every third Y erased (whose segment cores
   must also equal the bits sent), a ragged [130, 151, 2], and one
   all-erasure segment;
6. the DVB-S2 main path: DVBS2BankStream with 8 carriers of DVB-S2 QPSK
   1/2 normal frames, cs4 ingest, fed bench.py's headline signals for
   >= 4 blocks plus flush. Every carrier's TS must be one byte-exact
   contiguous run of its own packets, every frame must decode, and
   kernels A and B must have been launched. Then the device-resident
   bank step is timed with CUDA events;
7. the DVB-S main path: DVBSBankStream with 8 carriers of DVB-S rate
   1/2, cs4 ingest, 2^19 samples per block, fed bench.py's DVB-S
   signals for 6 blocks' worth. Every carrier must stay locked with a
   re-encode BER < 0.05, its TS must be one byte-exact contiguous run
   of >= 100 of its own packets, and kernels B and C must have been
   launched. The host tail's (native or python) time over the streamed
   run is reported, and the device-resident step is timed with CUDA
   events;
8. the pilots banks of bench.py (bench_hiord_bank): 8 carriers of 8PSK
   3/4, 16APSK 2/3 and 32APSK 3/4 normal frames with pilots, cs4, 128
   frames per block. For each, one bank step must decode all 128
   frames with no BCH flag, every carrier's TS (NativeTSParser) must be
   one byte-exact contiguous run, and kernels A and B must have been
   launched; the step is timed with CUDA events. 8PSK 3/4 is also
   streamed through DVBS2BankStream for >= 2 blocks plus flush with
   every frame decoded and every carrier's TS contiguous.

With --profile TRACE.json, a torch.profiler breakdown of the QPSK,
DVB-S and 32APSK bank steps by layer and kernel follows their phases;
the Chrome traces go to TRACE.json, TRACE_dvbs.json and
TRACE_32apsk.json.

Prints the kernels' JSON line (launches: the sum over the main paths'
runs, each run with the counts set to 0 just before it), then as its
last line {"ok": true, "device": {...}}. Needs one CUDA device.
"""
import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

N_CARRIERS = 8
MC, SHORT = 4, False            # QPSK 1/2, normal frames (LDPC table B4)
E2E_BLOCKS = 4
RESAMPLE_TOL = 1e-5
DVBS_BLOCK = 2 * (1 << 18)      # bench.py's DVB-S block, samples per carrier
DVBS_BLOCKS = 5                 # streamed: (DVBS_BLOCKS + 1) blocks' worth
# kernel A's noisy checks: (table, code rate, Eb/N0 dB near the int8
# decoder's threshold, where the trials spread over sweeps 7..10)
LDPC_CASES = (("B4", 1 / 2, 2.5), ("B7", 3 / 4, 3.0), ("B6", 2 / 3, 2.6))
# bench.py's pilots banks (bench_hiord_bank): MODCOD, SNR dB, label
PILOTS_BANKS = ((14, 9.5, "8psk34"), (18, 11.0, "16apsk23"),
                (24, 14.5, "32apsk34"))
PILOTS_PKTS = 700               # bench_hiord_bank's packets per carrier
STREAM_MC = 14                  # the pilots bank also streamed
STREAM_BLOCKS = 2               # streamed: >= 2 blocks plus flush


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over reps calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from dvbs_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s) -> {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# signals, made in worker processes (numpy only; they never touch the card)
# ---------------------------------------------------------------------------

def s2_carrier(mc: int, pilots: bool, n_pkts: int, seed: int, cfo: float,
               delay: float, snr_db: float):
    """One carrier of bench.s2_carrier_signal, cs4-packed, and its TS
    packets."""
    import bench
    from dvbs_tpu.spec import modcod
    from dvbs_tpu_torch.ops.frontend import pack_cs4
    cfg = modcod.get_config(mc, short=False, pilots=pilots)
    y, sent = bench.s2_carrier_signal(cfg, n_pkts, seed, cfo, delay,
                                      snr_db=snr_db)
    return pack_cs4(y), sent


def dvbs_carrier(c: int):
    """One of bench.py's DVB-S signals (bench_dvbs): a seam-free rate-1/2
    stream at 8 dB, cs4-packed, and its TS packets."""
    from dvbs_tpu.tx import channel, dvbs_mod
    from dvbs_tpu_torch.ops.frontend import pack_cs4
    need = (DVBS_BLOCKS + 1) * DVBS_BLOCK
    # 16 samples per framed byte; a group is 8 x 204 framed bytes
    n_groups = -(-need // (16 * 1632)) + 2
    ts = dvbs_mod.random_ts_groups(n_groups, seed=40 + c)
    tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=8.0,
                       cfo=(0.004 + 0.002 * c) * np.pi,
                       delay_samples=0.2 + 0.1 * c, sco_ppm=10.0,
                       seed=50 + c)
    assert len(y) >= need, (len(y), need)
    return pack_cs4(y[:need]), ts.reshape(-1, 188)


def stream_need(cfg, block: int, F: int, blocks: int) -> int:
    """Samples per carrier that a stream of `blocks` blocks after the
    first, plus flush, consumes (2 samples per symbol)."""
    return 2 * block + blocks * 2 * F * cfg.plframe_len + \
        2 * cfg.plframe_len


def stream_pkts(mc: int) -> int:
    """Packets per carrier that cover the streamed pilots run."""
    from dvbs_tpu.spec import modcod
    from dvbs_tpu_torch.parallel.mesh import bank_block_symbols
    cfg = modcod.get_config(mc, short=False, pilots=True)
    block = bank_block_symbols(N_CARRIERS, mc=mc, pilots=True)
    F = (block - 2 * 256 - 90) // cfg.plframe_len - 1
    frames = stream_need(cfg, block, F, STREAM_BLOCKS) // (
        2 * cfg.plframe_len) + 2
    return int(frames * (cfg.kbch - 80) / 8 / 188) + 1


def start_signals(pool) -> dict:
    """Submit every phase's signals: {phase: [future per carrier]}."""
    cs = range(N_CARRIERS)
    jobs = {"s2": [pool.submit(s2_carrier, MC, False, 2000, 10 + 3 * c,
                               (0.008 + 0.002 * c) * np.pi, 0.2 + 0.1 * c,
                               5.0) for c in cs]}
    for mc, snr, _ in PILOTS_BANKS:
        n_pkts = stream_pkts(mc) if mc == STREAM_MC else PILOTS_PKTS
        jobs[mc] = [pool.submit(s2_carrier, mc, True, n_pkts, 110 + 3 * c,
                                (0.006 + 0.002 * c) * np.pi, 0.25 + 0.1 * c,
                                snr) for c in cs]
    jobs["dvbs"] = [pool.submit(dvbs_carrier, c) for c in cs]
    return jobs


def phase_signals_and_build() -> dict:
    """Every phase's signals, made in worker processes while the kernels
    build: {phase: ([cs4 per carrier], [packets per carrier])}."""
    t0 = time.perf_counter()
    workers = min(8, len(os.sched_getaffinity(0)))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = start_signals(pool)
        phase_build()
        sigs = {k: [f.result() for f in v] for k, v in jobs.items()}
    out = {}
    for k, v in sigs.items():
        cs4 = [s for s, _ in v]
        if k != "dvbs":                 # equal lengths, as bench.py cuts them
            n = min(len(s) for s in cs4)
            cs4 = [s[:n] for s in cs4]
        out[k] = (cs4, [p for _, p in v])
    print(f"signals: {sum(len(v[0]) for v in out.values())} carriers in "
          f"{workers} worker processes ({time.perf_counter() - t0:.1f} s, "
          f"the build included): " + ", ".join(
              f"{k} {len(v[0][0])} cs4 samples" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_ldpc(torch, dev):
    """Kernel A against its plain version on each table of LDPC_CASES.
    The kernels row reports B4's noisy case (the headline bank's)."""
    from dvbs_tpu.spec import ldpc_spec
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import ldpc_kernel
    row, errs = None, []
    for k, (table, rate, ebno) in enumerate(LDPC_CASES):
        kt = tables.kernel_tables(table)
        B, N = ldpc_kernel.CALL_FRAMES, kt["N"]
        rng = np.random.default_rng(1 + k)
        rand = torch.from_numpy(rng.integers(-25, 26, (B, N))
                                .astype(np.int8)).to(dev)
        code = ldpc_spec.get_code(table)
        cw = code.encode(rng.integers(0, 2, (B, code.K)).astype(np.uint8))
        sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebno / 10)))
        y = 1.0 - 2.0 * cw.astype(np.float32) + \
            rng.normal(0, sigma, cw.shape).astype(np.float32)
        noisy = ldpc_kernel.quantize_llrs(
            torch.from_numpy(2.0 * y / sigma ** 2).to(dev))
        for label, llr, n_iters, ee in (
                ("random, 1 sweep", rand, 1, False),
                (f"Eb/N0 {ebno} dB, 12 sweeps, early exit", noisy, 12, True)):
            got = ldpc_kernel.decode_cuda(llr, kt, n_iters, early_exit=ee)
            ref = ldpc_kernel.decode_plain(llr, kt, n_iters, early_exit=ee)
            torch.cuda.synchronize()
            for name, a, b in zip(("hard", "n_bad", "trials"), got, ref):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"kernel A {table} {label}: {name} differs from "
                        f"the plain version in {int((a != b).sum())} places")
            ms = cuda_ms(lambda: ldpc_kernel.decode_cuda(
                llr, kt, n_iters, early_exit=ee), 10)
            plain_ms = cuda_ms(lambda: ldpc_kernel.decode_plain(
                llr, kt, n_iters, early_exit=ee), 1)
            err = max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                      for a, b in zip(got, ref))
            tr = got[2].cpu().numpy()
            n_ok = int((got[1] == 0).sum())
            if ee:
                n_right = int((got[0].cpu().numpy() == cw).all(axis=1).sum())
                assert n_ok == n_right == B, (table, n_ok, n_right)
            print(f"kernel A {table} (q {kt['q']}, Dmax {kt['Dmax']}) "
                  f"[{B}, {N}] {label}: bit-exact; trials "
                  f"{tr.min()}..{tr.max()} {np.bincount(tr).tolist()}, "
                  f"{n_ok}/{B} frames clean; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.1f} ms")
            errs.append(err)
            if ee and row is None:
                row = dict(name="ldpc_layered", route="cuda",
                           source="dvbs_tpu_torch/csrc/ldpc_layered.cu",
                           replaces="dvbs_tpu/ops/ldpc_pallas.py:478",
                           ms=ms, plain_ms=plain_ms)
    row["max_abs_err"] = max(errs)
    return row


def phase_resample(torch, dev):
    """Kernel B against its plain version at each bank's symbols per
    block: QPSK 1/2, the three pilots banks (shift bits 10, 9, 9, 8) and
    DVB-S. The kernels row reports the first (the headline bank's)."""
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import resample_kernel as rk
    C = N_CARRIERS
    coef_np, fmid, fhalf = tables.farrow_coeffs()
    coef = torch.from_numpy(coef_np).to(dev)
    row = None
    for S in (552960, 377920, 284288, 227392, DVBS_BLOCK // 2):
        n2 = 2 * S
        rng = np.random.default_rng(2)
        y = torch.from_numpy((rng.normal(size=(C, n2)) + 1j * rng.normal(
            size=(C, n2))).astype(np.complex64)).to(dev)
        k = np.arange(S)
        t = np.stack([2.0 * k + 0.3 + 0.17 * c +
                      (1 if c % 2 == 0 else -1) * (1 + 0.2 * c) * 1e-5 * k
                      for c in range(C)]).astype(np.float32)
        t = torch.from_numpy(t).to(dev)
        rb, u, bias = rk.shifts_and_band(t, (fmid, fhalf))
        got = rk.resample_cuda(y, u, rb, bias, coef, S)
        ref = rk.resample_plain(y, u, rb, bias, coef, S)
        err = float(torch.max(torch.abs(got - ref)))
        if not err <= RESAMPLE_TOL:
            raise AssertionError(f"kernel B [{C}, {S}]: max abs error {err} "
                                 f"> {RESAMPLE_TOL}")
        ms = cuda_ms(lambda: rk.resample_cuda(y, u, rb, bias, coef, S), 20)
        plain_ms = cuda_ms(lambda: rk.resample_plain(y, u, rb, bias, coef,
                                                     S), 3)
        print(f"kernel B [{C}, {S}] (bias {bias}): max abs err {err:.3g} "
              f"(tol {RESAMPLE_TOL}), kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms")
        if row is None:
            row = dict(name="resample_farrow", route="cuda",
                       source="dvbs_tpu_torch/csrc/resample_farrow.cu",
                       replaces="dvbs_tpu/ops/resample_pallas.py:202",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return row


def phase_viterbi(torch, dev):
    """Kernel C against its plain version, bit-exact on every output bit
    (wings included), on three inputs."""
    from dvbs_tpu.spec import dvbs_fec
    from dvbs_tpu_torch.ops import viterbi_kernel as vk
    rng = np.random.default_rng(3)
    B, T, wing = 4096, 704, 96           # the DVB-S bank's segments
    truth = rng.integers(0, 2, (B, T))
    bp = np.concatenate([np.zeros((B, 6), np.int64), truth], axis=1)
    xy = np.stack([sum(bp[:, j:j + T] for j in range(7) if (g >> j) & 1) % 2
                   for g in (dvbs_fec.G1, dvbs_fec.G2)], axis=2)
    bank = (1.0 - 2.0 * xy) * 2.0 + rng.normal(0, 0.8, (B, T, 2))
    bank[:, ::3, 1] = 0.0                # depuncture-style erasures
    ragged = rng.normal(0, 1.5, (130, 151, 2))
    ragged[:, ::3, 1] = 0.0
    cases = (("noisy codewords [4096, 704, 2], every third Y erased", bank),
             ("ragged [130, 151, 2]", ragged),
             ("all-erasure [1, 704, 2]", np.zeros((1, T, 2))))
    err = 0
    for label, x in cases:
        xt = torch.from_numpy(x.astype(np.float32)).to(dev)
        got = vk.decode_cuda(xt)
        ref = vk.decode_plain(xt)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(
                f"kernel C {label}: {int((got != ref).sum())} bits differ "
                f"from the plain version")
        err = max(err, int((got.to(torch.int32) - ref.to(torch.int32))
                           .abs().max()))
        print(f"kernel C {label}: bit-exact on all {got.numel()} bits")
    big = torch.from_numpy(bank.astype(np.float32)).to(dev)
    core = vk.decode_cuda(big)[:, wing:T - wing].cpu().numpy()
    n_bad = int((core != truth[:, wing:T - wing]).sum())
    if n_bad:
        raise AssertionError(f"kernel C: {n_bad} core bits differ from the "
                             f"bits sent")
    ms = cuda_ms(lambda: vk.decode_cuda(big), 20)
    plain_ms = cuda_ms(lambda: vk.decode_plain(big), 2)
    print(f"kernel C [{B}, {T}, 2]: cores equal the bits sent; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
    return dict(name="viterbi_acs", route="cuda",
                source="dvbs_tpu_torch/csrc/viterbi_acs.cu",
                replaces="dvbs_tpu/ops/viterbi_pallas.py:247",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def stream_bank(torch, st, sigs, sents, blocks: int, label: str) -> dict:
    """Feed a DVBS2BankStream `blocks` blocks after the first, plus flush,
    with the counts set to 0 just before; every frame must decode and
    every carrier's TS must be one byte-exact contiguous run of its own
    packets. Returns the launch counts of the run."""
    import bench
    from dvbs_tpu_torch import backend
    cfg = st.cfg
    n = 2 * st.block_symbols
    F = st.F
    kb = cfg.kbch // 8
    slen = len(sigs[0])
    need = stream_need(cfg, st.block_symbols, F, blocks)
    assert slen >= need, (slen, need)
    outs = [bytearray() for _ in range(N_CARRIERS)]
    fed = 0
    backend.reset_launches()
    t0 = time.perf_counter()
    while fed < need:
        e = min(fed + n // 2, need)
        for c, o in zip(st.feed([s[fed:e] for s in sigs]), outs):
            o.extend(c)
        fed = e
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    print(f"{label}: {N_CARRIERS} carriers x {fed} samples streamed in "
          f"{dt:.1f} s; frames ok {st.frames_ok.tolist()} of "
          f"{st.frames_seen.tolist()}; launches {launches}")
    assert (st.frames_seen >= (blocks + 1) * F).all(), st.frames_seen
    assert (st.frames_ok == st.frames_seen).all(), \
        f"frames lost: {st.frames_ok} of {st.frames_seen}"
    want = (blocks + 1) * F * (kb // 188) - 2
    for c in range(N_CARRIERS):
        npk = bench.contiguous_packets(bytes(outs[c]), sents[c],
                                       f"{label} c{c}")
        assert npk >= want, f"c{c}: {npk} packets < {want}"
    print(f"{label} TS: every carrier one byte-exact contiguous run "
          f"(>= {want} packets each)")
    for name in ("ldpc_layered", "resample_farrow"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the {label}"
    return launches


def time_step(torch, step, dev_in, label: str, what: str, smi: str):
    """Min and mean ms of a device-resident bank step over 3 batches of
    10 reps, by CUDA events, printed with the card and the rate."""
    batches = [cuda_ms(lambda: step(dev_in), 10) for _ in range(3)]
    ms_min, ms_mean = min(batches), sum(batches) / len(batches)
    C, n = dev_in.shape[0], dev_in.shape[-1]
    msps = C * n / (ms_min * 1e-3) / 1e6
    print(f"{label} [{C} x {n} cs4 samples, {what}]: min "
          f"{ms_min:.3f} ms, mean {ms_mean:.3f} ms per block (3 batches x "
          f"10), {msps:.2f} Msamples/s at the min; card {smi}")


def phase_main_path(torch, dev, smi, sigs, sents):
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    st = DVBS2BankStream(N_CARRIERS, mc=MC, short=SHORT, fec="int8",
                         ingest="cs4", device=dev)
    launches = stream_bank(torch, st, sigs, sents, E2E_BLOCKS, "main path")
    # device-resident step: min and mean over 3 batches of 10 reps
    n = 2 * st.block_symbols
    dev_in = torch.from_numpy(np.stack([s[:n] for s in sigs])).to(dev)
    out = st.step_fn(dev_in)
    assert bool(out["ldpc_ok"].all()) and not bool(out["bch_bad"].any())
    time_step(torch, st.step_fn, dev_in, "bank step",
              f"{N_CARRIERS * st.F} frames", smi)
    return launches, lambda: st.step_fn(dev_in)


def phase_dvbs(torch, dev, smi, sigs, sents):
    import bench
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.parallel.dvbs_bank import DVBSBankStream
    n = DVBS_BLOCK
    need = len(sigs[0])
    st = DVBSBankStream(N_CARRIERS, rate="1/2", block_samples=n,
                        ingest="cs4", device=dev)
    tail = "native" if st._native_tail else "python"
    outs = [bytearray() for _ in range(N_CARRIERS)]
    backend.reset_launches()
    t0 = time.perf_counter()
    for lo in range(0, need, n):
        for c, o in zip(st.feed([s[lo:lo + n] for s in sigs]), outs):
            o.extend(c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    print(f"DVB-S main path: {N_CARRIERS} carriers x {need} samples "
          f"streamed in {dt:.1f} s ({tail} host tail); locked "
          f"{st.locked.tolist()}; ber {st.ber.tolist()}; launches "
          f"{launches}")
    assert st.locked.all() and (st.ber < 0.05).all(), \
        f"DVB-S bank must stay locked: ber={st.ber}"
    npk = [bench.contiguous_packets(bytes(outs[c]), sents[c], f"dvbs c{c}")
           for c in range(N_CARRIERS)]
    assert min(npk) >= 100, npk
    print(f"DVB-S TS: every carrier one byte-exact contiguous run "
          f"({min(npk)}..{max(npk)} packets)")
    for name in ("viterbi_acs", "resample_farrow"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the DVB-S main path"

    blocks = st.steps_run
    print(f"DVB-S host tail ({tail}): {st.tail_seconds:.2f} s for {blocks} "
          f"blocks of {N_CARRIERS} carriers, "
          f"{N_CARRIERS * blocks * n / st.tail_seconds / 1e6:.2f} "
          f"Msamples/s")

    # device-resident step: min and mean over 3 batches of 10 reps
    dev_in, hints = st.last_debug["dev_in"], st.last_debug["hints"]
    out = st.step(dev_in, hints)
    assert bool((out["ber"] < 0.05).all()), out["ber"]
    time_step(torch, lambda x: st.step(x, hints), dev_in, "DVB-S bank step",
              f"{N_CARRIERS * st.step.B} Viterbi segments", smi)
    return launches, lambda: st.step(dev_in, hints)


def phase_pilots(torch, dev, smi, mc, label, sigs, sents):
    """One step of bench.py's pilots bank at MODCOD mc (bench_hiord_bank):
    every frame decodes, no BCH flag, every carrier's TS one byte-exact
    contiguous run, kernels A and B launched; then the step is timed."""
    import bench
    from dvbs_tpu.io.native import NativeTSParser
    from dvbs_tpu.spec import modcod
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.parallel.mesh import (bank_block_symbols,
                                              build_carrier_bank)
    cfg = modcod.get_config(mc, short=False, pilots=True)
    block = bank_block_symbols(N_CARRIERS, mc=mc, pilots=True)
    n = 2 * block
    step, _ = build_carrier_bank(N_CARRIERS, mc=mc, short=False, pilots=True,
                                 block_symbols=block, fec="int8",
                                 ingest="cs4", n_iters=12, device=dev)
    dev_in = torch.from_numpy(np.stack([s[:n] for s in sigs])).to(dev)
    backend.reset_launches()
    h = {k: v.cpu().numpy() for k, v in step(dev_in).items()}
    launches = dict(backend.LAUNCHES)
    F = h["quality"].shape[1]
    tr = h["trials"]
    print(f"{label} pilots bank (MODCOD {mc}, LDPC {cfg.ldpc_table}, "
          f"L {cfg.plframe_len}, {N_CARRIERS} x {block} symbols): "
          f"ldpc_ok {int(h['ldpc_ok'].sum())}/{len(tr)}, bch_bad "
          f"{int(h['bch_bad'].sum())}, trials {tr.min()}..{tr.max()} "
          f"(mean {tr.mean():.2f}); launches {launches}")
    assert h["ldpc_ok"].all(), f"{label} pilots bank must decode"
    assert not h["bch_bad"].any(), f"{label}: BCH flags"
    assert (h["pls"] == cfg.pls_code).all(), f"{label}: PLS"
    kb = cfg.kbch // 8
    kbb = np.ascontiguousarray(h["kbch_bytes"].reshape(N_CARRIERS, F, kb))
    npk = [bench.contiguous_packets(NativeTSParser(cfg.kbch).feed(kbb[c]),
                                    sents[c], f"{label} c{c}")
           for c in range(N_CARRIERS)]
    print(f"{label} TS: every carrier one byte-exact contiguous run "
          f"({min(npk)}..{max(npk)} packets)")
    for name in ("ldpc_layered", "resample_farrow"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the {label} pilots bank"
    time_step(torch, step, dev_in, f"{label} pilots bank step",
              f"{N_CARRIERS * F} frames", smi)
    return launches, lambda: step(dev_in)


def phase_pilots_stream(torch, dev, sigs, sents):
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    st = DVBS2BankStream(N_CARRIERS, mc=STREAM_MC, short=False, pilots=True,
                         fec="int8", ingest="cs4", device=dev)
    return stream_bank(torch, st, sigs, sents, STREAM_BLOCKS,
                       "8PSK 3/4 pilots stream")


LAYERS_S2 = ("frontend", "timing", "plsync", "phase", "demap", "ldpc",
             "bch_pack")
LAYERS_DVBS = ("frontend", "timing", "carrier", "viterbi", "ber_pack")


def phase_profile(torch, step, trace: str, layers: tuple, label: str,
                  reps: int = 5):
    """Where a bank step's time goes, from a torch.profiler trace of
    `reps` calls of step(): kernel time per layer (kernels that start inside the
    layer's record_function range on the device timeline), the device's
    busy and idle share, the top kernels, and the host's enqueue time
    for one step (started on an idle device, without the profiler).
    The Chrome trace goes to `trace`."""
    import collections
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enq.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    trace = Path(trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [e for e in events if e.get("ph") == "X" and
             e.get("cat") == "gpu_user_annotation" and e["name"] in layers]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3 / reps
    per_layer = collections.Counter()
    for k in kernels:
        for sp in spans:
            if sp["ts"] <= k["ts"] < sp["ts"] + sp["dur"]:
                per_layer[sp["name"]] += k["dur"]
                break
        else:
            per_layer["(outside)"] += k["dur"]
    print(f"profile of the {label} step ({reps} steps): host enqueue of one step "
          f"{min(enq):.3f} ms (min of 5, no profiler); with the profiler "
          f"on: wall {wall_ms:.3f} ms/step, kernels {busy_ms:.3f} ms/step, "
          f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for name in layers + ("(outside)",):
        print(f"  layer {name:9s} kernels {per_layer[name] / 1e3 / reps:7.3f}"
              f" ms/step")
    by_name = collections.Counter()
    counts = collections.Counter()
    for k in kernels:
        by_name[k["name"]] += k["dur"]
        counts[k["name"]] += 1
    for name, us in by_name.most_common(12):
        print(f"  kernel {us / 1e3 / reps:7.3f} ms/step x{counts[name] // reps:<4d}"
              f" {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TRACE.json",
                    help="profile the QPSK, DVB-S and 32APSK bank steps; "
                    "write the first trace here and the others beside it")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dvbs_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    smi = phase_card(torch)
    sigs = phase_signals_and_build()
    trace = args.profile[:-5] if args.profile and \
        args.profile.endswith(".json") else args.profile
    rows = [phase_ldpc(torch, dev), phase_resample(torch, dev),
            phase_viterbi(torch, dev)]
    runs = []                       # launch counts of every main-path run
    launches, step = phase_main_path(torch, dev, smi, *sigs["s2"])
    runs.append(launches)
    if args.profile:
        phase_profile(torch, step, args.profile, LAYERS_S2, "DVB-S2")
    launches, step = phase_dvbs(torch, dev, smi, *sigs["dvbs"])
    runs.append(launches)
    if args.profile:
        phase_profile(torch, step, trace + "_dvbs.json", LAYERS_DVBS,
                      "DVB-S")
    for mc, _, label in PILOTS_BANKS:
        launches, step = phase_pilots(torch, dev, smi, mc, label, *sigs[mc])
        runs.append(launches)
        if mc == STREAM_MC:
            runs.append(phase_pilots_stream(torch, dev, *sigs[mc]))
    if args.profile:                 # the last bank: 32APSK 3/4
        phase_profile(torch, step, trace + "_32apsk.json", LAYERS_S2,
                      "32APSK 3/4 pilots")
    for r in rows:
        r["launches"] = sum(run[r["name"]] for run in runs)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
