#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvbs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: name and power limit (nvidia-smi), TF32 off;
2. build the CUDA kernels from dvbs_tpu_torch/csrc (nvcc, cached in
   build/kernels/ by a hash of the sources);
3. kernel A (int8 layered LDPC) against its plain PyTorch version at
   [128, 64800] (LDPC table B4): one fixed sweep on random int8 LLRs,
   and 12 sweeps with early exit on noisy codewords. hard, n_bad and
   trials must be equal;
4. kernel B (barrel+Farrow resampler) against its plain version at
   C=8, S=552960 with drifting positions of both signs: max abs error
   <= 1e-5;
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
   events.

With --profile TRACE.json, a torch.profiler breakdown of each bank step
by layer and kernel follows its phase; the DVB-S2 step's Chrome trace is
written to TRACE.json and the DVB-S step's beside it (TRACE_dvbs.json).

Prints the kernels' JSON line (launches: the count of the main paths'
streamed runs, each run with the counts set to 0 just before it), then
as its last line {"ok": true, "device": {...}}. Needs one CUDA device.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_CARRIERS = 8
MC, SHORT = 4, False            # QPSK 1/2, normal frames (LDPC table B4)
E2E_BLOCKS = 4
RESAMPLE_TOL = 1e-5
DVBS_BLOCK = 2 * (1 << 18)      # bench.py's DVB-S block, samples per carrier
DVBS_BLOCKS = 5                 # streamed: (DVBS_BLOCKS + 1) blocks' worth


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


def phase_ldpc(torch, dev):
    from dvbs_tpu.spec import ldpc_spec
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import ldpc_kernel
    table = "B4"
    kt = tables.kernel_tables(table)
    B, N = ldpc_kernel.CALL_FRAMES, kt["N"]
    rng = np.random.default_rng(1)
    rand = torch.from_numpy(rng.integers(-25, 26, (B, N)).astype(np.int8)
                            ).to(dev)
    code = ldpc_spec.get_code(table)
    cw = code.encode(rng.integers(0, 2, (B, code.K)).astype(np.uint8))
    sigma = np.sqrt(10 ** (-2.5 / 10))
    y = 1.0 - 2.0 * cw.astype(np.float32) + \
        rng.normal(0, sigma, cw.shape).astype(np.float32)
    noisy = ldpc_kernel.quantize_llrs(
        torch.from_numpy(2.0 * y / sigma ** 2).to(dev))
    row = None
    for label, llr, n_iters, ee in (("random, 1 sweep", rand, 1, False),
                                    ("noisy, 12 sweeps, early exit", noisy,
                                     12, True)):
        got = ldpc_kernel.decode_cuda(llr, kt, n_iters, early_exit=ee)
        ref = ldpc_kernel.decode_plain(llr, kt, n_iters, early_exit=ee)
        torch.cuda.synchronize()
        for name, a, b in zip(("hard", "n_bad", "trials"), got, ref):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"kernel A {label}: {name} differs from the plain "
                    f"version in {int((a != b).sum())} places")
        ms = cuda_ms(lambda: ldpc_kernel.decode_cuda(llr, kt, n_iters,
                                                     early_exit=ee), 10)
        plain_ms = cuda_ms(lambda: ldpc_kernel.decode_plain(
            llr, kt, n_iters, early_exit=ee), 1)
        err = max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                  for a, b in zip(got, ref))
        tr = got[2].cpu().numpy()
        n_ok = int((got[1] == 0).sum())
        print(f"kernel A [{B}, {N}] {label}: bit-exact; trials "
              f"{tr.min()}..{tr.max()}, {n_ok}/{B} frames clean; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
        if ee:
            row = dict(name="ldpc_layered", route="cuda",
                       source="dvbs_tpu_torch/csrc/ldpc_layered.cu",
                       replaces="dvbs_tpu/ops/ldpc_pallas.py:478",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return row


def phase_resample(torch, dev):
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import resample_kernel as rk
    C, S = N_CARRIERS, 552960
    n2 = 2 * S
    rng = np.random.default_rng(2)
    y = torch.from_numpy((rng.normal(size=(C, n2)) + 1j * rng.normal(
        size=(C, n2))).astype(np.complex64)).to(dev)
    k = np.arange(S)
    t = np.stack([2.0 * k + 0.3 + 0.17 * c +
                  (1 if c % 2 == 0 else -1) * (1 + 0.2 * c) * 1e-5 * k
                  for c in range(C)]).astype(np.float32)
    t = torch.from_numpy(t).to(dev)
    coef_np, fmid, fhalf = tables.farrow_coeffs()
    coef = torch.from_numpy(coef_np).to(dev)
    rb, u, bias = rk.shifts_and_band(t, (fmid, fhalf))
    got = rk.resample_cuda(y, u, rb, bias, coef, S)
    ref = rk.resample_plain(y, u, rb, bias, coef, S)
    err = float(torch.max(torch.abs(got - ref)))
    if not err <= RESAMPLE_TOL:
        raise AssertionError(f"kernel B: max abs error {err} > "
                             f"{RESAMPLE_TOL}")
    ms = cuda_ms(lambda: rk.resample_cuda(y, u, rb, bias, coef, S), 20)
    plain_ms = cuda_ms(lambda: rk.resample_plain(y, u, rb, bias, coef, S), 3)
    print(f"kernel B [{C}, {S}]: max abs err {err:.3g} (tol "
          f"{RESAMPLE_TOL}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(name="resample_farrow", route="cuda",
                source="dvbs_tpu_torch/csrc/resample_farrow.cu",
                replaces="dvbs_tpu/ops/resample_pallas.py:202",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def phase_main_path(torch, dev, smi):
    import bench
    from dvbs_tpu.spec import modcod
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    from dvbs_tpu_torch.ops import frontend
    cfg = modcod.get_config(MC, short=SHORT)
    t0 = time.perf_counter()
    sigs, sents = [], []
    for c in range(N_CARRIERS):
        y, sent = bench.s2_carrier_signal(cfg, 2000, 10 + 3 * c,
                                          (0.008 + 0.002 * c) * np.pi,
                                          0.2 + 0.1 * c)
        sigs.append(frontend.pack_cs4(y))
        sents.append(sent)
    slen = min(len(s) for s in sigs)
    sigs = [s[:slen] for s in sigs]
    print(f"signals: {N_CARRIERS} x {slen} cs4 samples "
          f"({time.perf_counter() - t0:.1f} s)")

    st = DVBS2BankStream(N_CARRIERS, mc=MC, short=SHORT, fec="int8",
                         ingest="cs4", device=dev)
    n = 2 * st.block_symbols
    F = st.F
    kb = cfg.kbch // 8
    need = n + E2E_BLOCKS * 2 * (F * cfg.plframe_len) + 2 * cfg.plframe_len
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
    print(f"main path: {N_CARRIERS} carriers x {fed} samples streamed in "
          f"{dt:.1f} s; frames ok {st.frames_ok.tolist()} of "
          f"{st.frames_seen.tolist()}; launches {launches}")
    assert (st.frames_seen >= (E2E_BLOCKS + 1) * F).all(), st.frames_seen
    assert (st.frames_ok == st.frames_seen).all(), \
        f"frames lost: {st.frames_ok} of {st.frames_seen}"
    for c in range(N_CARRIERS):
        npk = bench.contiguous_packets(bytes(outs[c]), sents[c], f"c{c}")
        want = (E2E_BLOCKS + 1) * F * (kb // 188) - 2
        assert npk >= want, f"c{c}: {npk} packets < {want}"
    print(f"TS: every carrier one byte-exact contiguous run "
          f"(>= {(E2E_BLOCKS + 1) * F * (kb // 188) - 2} packets each)")
    for name in ("ldpc_layered", "resample_farrow"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the DVB-S2 main path"

    # device-resident step: min and mean over 3 batches of 10 reps
    dev_in = torch.from_numpy(np.stack([s[:n] for s in sigs])).to(dev)
    out = st.step_fn(dev_in)
    assert bool(out["ldpc_ok"].all()) and not bool(out["bch_bad"].any())
    batches = [cuda_ms(lambda: st.step_fn(dev_in), 10) for _ in range(3)]
    ms_min, ms_mean = min(batches), sum(batches) / len(batches)
    msps = N_CARRIERS * n / (ms_min * 1e-3) / 1e6
    print(f"bank step [{N_CARRIERS} x {n} cs4 samples, {N_CARRIERS * F} "
          f"frames]: min {ms_min:.3f} ms, mean {ms_mean:.3f} ms per block "
          f"(3 batches x 10), {msps:.2f} Msamples/s at the min; card {smi}")
    return launches, lambda: st.step_fn(dev_in)


def dvbs_signals():
    """bench.py's DVB-S signals (bench_dvbs): 8 distinct seam-free
    rate-1/2 streams at 8 dB, packed to cs4, and their TS packets."""
    from dvbs_tpu.tx import channel, dvbs_mod
    from dvbs_tpu_torch.ops import frontend
    need = (DVBS_BLOCKS + 1) * DVBS_BLOCK
    # 16 samples per framed byte; a group is 8 x 204 framed bytes
    n_groups = -(-need // (16 * 1632)) + 2
    sigs, sents = [], []
    for c in range(N_CARRIERS):
        ts = dvbs_mod.random_ts_groups(n_groups, seed=40 + c)
        tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
        x = channel.shape(tx, sps=2)
        y = channel.impair(x, snr_db=8.0, cfo=(0.004 + 0.002 * c) * np.pi,
                           delay_samples=0.2 + 0.1 * c, sco_ppm=10.0,
                           seed=50 + c)
        assert len(y) >= need, (len(y), need)
        sigs.append(frontend.pack_cs4(y[:need]))
        sents.append(ts.reshape(-1, 188))
    return sigs, sents, need


def phase_dvbs(torch, dev, smi):
    import bench
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.parallel.dvbs_bank import DVBSBankStream
    n = DVBS_BLOCK
    t0 = time.perf_counter()
    sigs, sents, need = dvbs_signals()
    print(f"DVB-S signals: {N_CARRIERS} x {need} cs4 samples "
          f"({time.perf_counter() - t0:.1f} s)")
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
    batches = [cuda_ms(lambda: st.step(dev_in, hints), 10) for _ in range(3)]
    ms_min, ms_mean = min(batches), sum(batches) / len(batches)
    msps = N_CARRIERS * n / (ms_min * 1e-3) / 1e6
    print(f"DVB-S bank step [{N_CARRIERS} x {n} cs4 samples, "
          f"{N_CARRIERS * st.step.B} Viterbi segments]: min {ms_min:.3f} "
          f"ms, mean {ms_mean:.3f} ms per block (3 batches x 10), "
          f"{msps:.2f} Msamples/s at the min; card {smi}")
    return launches, lambda: st.step(dev_in, hints)


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
                    help="profile the bank steps; write the DVB-S2 trace "
                    "here and the DVB-S trace beside it")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dvbs_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    smi = phase_card(torch)
    phase_build()
    rows = [phase_ldpc(torch, dev), phase_resample(torch, dev),
            phase_viterbi(torch, dev)]
    launches_s2, step = phase_main_path(torch, dev, smi)
    if args.profile:
        phase_profile(torch, step, args.profile, LAYERS_S2, "DVB-S2")
    launches_s, step = phase_dvbs(torch, dev, smi)
    if args.profile:
        trace = args.profile[:-5] if args.profile.endswith(".json") \
            else args.profile
        phase_profile(torch, step, trace + "_dvbs.json", LAYERS_DVBS,
                      "DVB-S")
    for r in rows:
        r["launches"] = launches_s2[r["name"]] + launches_s[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
