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
5. the main path: DVBS2BankStream with 8 carriers of DVB-S2 QPSK 1/2
   normal frames, cs4 ingest, fed bench.py's headline signals for >= 4
   blocks plus flush. Every carrier's TS must be one byte-exact
   contiguous run of its own packets, every frame must decode, and both
   kernels must have been launched. Then the device-resident bank step
   is timed with CUDA events.

With --profile TRACE.json, a torch.profiler breakdown of the bank step
by layer and kernel follows phase 5, and its Chrome trace is written to
TRACE.json.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {...}}. Needs one CUDA device.
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
    for name, cnt in launches.items():
        assert cnt > 0, f"kernel {name} was not launched on the main path"

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
    return launches, st.step_fn, dev_in


LAYERS = ("frontend", "timing", "plsync", "phase", "demap", "ldpc",
          "bch_pack")


def phase_profile(torch, step, dev_in, trace: str, reps: int = 5):
    """Where the bank step's time goes, from a torch.profiler trace of
    `reps` steps: kernel time per layer (kernels that start inside the
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
        step(dev_in)
        enq.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    trace = Path(trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step(dev_in)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [e for e in events if e.get("ph") == "X" and
             e.get("cat") == "gpu_user_annotation" and e["name"] in LAYERS]
    busy_ms = sum(e["dur"] for e in kernels) / 1e3 / reps
    per_layer = collections.Counter()
    for k in kernels:
        for sp in spans:
            if sp["ts"] <= k["ts"] < sp["ts"] + sp["dur"]:
                per_layer[sp["name"]] += k["dur"]
                break
        else:
            per_layer["(outside)"] += k["dur"]
    print(f"profile ({reps} steps): host enqueue of one step "
          f"{min(enq):.3f} ms (min of 5, no profiler); with the profiler "
          f"on: wall {wall_ms:.3f} ms/step, kernels {busy_ms:.3f} ms/step, "
          f"device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for name in LAYERS + ("(outside)",):
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
                    help="profile the bank step; write the trace here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dvbs_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    smi = phase_card(torch)
    phase_build()
    rows = [phase_ldpc(torch, dev), phase_resample(torch, dev)]
    launches, step, dev_in = phase_main_path(torch, dev, smi)
    if args.profile:
        phase_profile(torch, step, dev_in, args.profile)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
