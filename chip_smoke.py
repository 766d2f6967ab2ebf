#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvbs_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: name and power limit (nvidia-smi), TF32 off;
2. every phase's signals (dvbs_tpu_torch/tx/signals.py: the seeds and
   parameters of the JAX package's bench.py), made in worker processes
   (one per CPU core but one, up to 8) while this process builds the
   CUDA kernels from dvbs_tpu_torch/csrc (one nvcc per source, cached
   in build/kernels/ by a hash of the sources) and runs phases 3 to 6,
   which need none of the signals;
3. kernel A (int8 layered LDPC) against its plain PyTorch version at
   [128, 64800] on the LDPC tables B4, B7 and B6 (one fixed sweep on
   random int8 LLRs, and 12 sweeps with early exit on noisy codewords
   near each code's threshold), and at the single-carrier receiver's
   batches: F = 3 and 8 frames on B4, 3, 5 and 8 on B7 and 7 on B6;
   then on every table B1..B11 and C1..C10 (3 frames, two fixed sweeps
   of random int8 LLRs: every Dmax specialisation, every barrier flag
   and every padding entry), at F = 1 and 130 frames through
   decode_calls, and timed at 0, 3, 5, 8 and 10 fixed sweeps. hard, n_bad
   and trials must be equal;
4. kernel B (barrel+Farrow resampler, positions in, symbols out)
   against its plain version (shifts_and_band, then resample_plain) at
   C=8 and each bank's symbols per block (552960 for QPSK 1/2; 377920,
   284288 and 227392 for the pilots banks; 262144 for DVB-S; 65536 for
   the first-block DVB-S bank; 32768 for the multi-carrier step), at
   [1, 131072], the single-carrier block, and at [1, 32768], the
   short-frame receiver's and time shard's; at the later phases' [4,
   1072832] (the wideband CLI's bank), [3, 98112] (3 carriers x 2
   frames), [2, 131072] and [2, 65536] (the DVB-S stream banks of 2
   carriers), [1, 65536] (their lock) and [1, 262144] (the DVB-S
   bank's lock), with drifting positions of both signs: the shifts rb
   and band coordinates u the kernel derives equal to
   shifts_and_band's bit for bit, the output within 1e-5; each
   timed eagerly and by CUDA-graph replay against its bound, beside
   shifts_and_band alone (the glue the kernel absorbed) and a launch
   floor (torch.mul over the output's bytes); the kernel's SASS has no
   shared-memory load;
5. kernel C (radix-8 Viterbi ACS + traceback) against its plain version,
   bit for bit on every output bit: noisy codewords at the DVB-S bank's
   shape [4096, 704, 2] with every third Y erased (whose segment cores
   must also equal the bits sent), [4097, 704, 2] (a ragged last CTA),
   a ragged [130, 151, 2], the single-carrier DVB-S receiver's segments
   [8, 2240, 2] and its blocks at rates 1/2 and 7/8, [64, 2240, 2] and
   [112, 2240, 2], the first-block bank's [1024, 704, 2] and the 2-carrier
   DVB-S stream banks' [512, 704, 2] and [256, 704, 2] (these five timed
   against their bounds), T = 1..5, and one all-erasure segment; then
   the soft demapper (csrc/soft_demap.cu) against its plain version at
   the 32APSK 3/4 pilots bank's [128 x 12960, 32] and the QPSK 1/2
   bank's [128 x 32400, 4] (demap.against_plain's tolerance), each
   timed eagerly and by CUDA-graph replay against its bound, beside the
   plain version's time;
6. every stage of the resampler probe (csrc/resample_probe.cu: v0..v8,
   dma, rows, rb, barrel, swap, full, split) against its plain version
   at the TPU probes' shape and at the bank's, max abs error 0; then
   the probe's entry point (kernels/probe_resample.main), which prints
   each stage's time;
7. the DVB-S2 bank path: DVBS2BankStream with 8 carriers of DVB-S2 QPSK
   1/2 normal frames, cs4 ingest, >= 4 blocks plus flush. Every
   carrier's TS must be one byte-exact contiguous run of its own
   packets, every frame must decode, and kernels A and B must have been
   launched. Then the device-resident bank step is timed with CUDA
   events;
8. the DVB-S bank path: DVBSBankStream with 8 carriers of DVB-S rate
   1/2, cs4 ingest, 2^19 samples per block, 6 blocks' worth. Every
   carrier must stay locked with a re-encode BER < 0.05, its TS must be
   one byte-exact contiguous run of >= 100 of its own packets, and
   kernels B and C must have been launched;
9. the pilots banks: 8 carriers of 8PSK 3/4, 16APSK 2/3 and 32APSK 3/4
   normal frames with pilots, cs4, 128 frames per block: one bank step
   each decodes all 128 frames with no BCH flag and contiguous TS;
   8PSK 3/4 is also streamed for >= 2 blocks plus flush. Then the
   32APSK bank's step as CUDA graphs (dvbs_tpu_torch/graphs.py): three
   blocks through a fresh bank (eager, captured, replayed) equal to the
   eager step bit for bit, the host ms of a step eager and replayed,
   and under the profiler every range the benchmark reads (frontend ...
   bch_pack, resample, bank.step) owning as many replayed operations
   as eager ones (rxbench/trace.py's rule);
10. the single-carrier slice, at block_symbols 2^17 and >= 6 blocks:
   the port's cli.main run in-process on cf32 files in a temporary
   directory, default device, `--fec pallas`, for QPSK 1/2, 8PSK 3/4
   and 16APSK 2/3 without pilots and 32APSK 3/4 with pilots; QPSK 1/2
   again with `--fec xla`; QPSK 1/2 in two runs joined by a
   `--state-file`; and 8PSK 3/4 with a dummy PLFRAME after every third
   data frame through DVBS2Stream(dummy_aware=True). Every output must
   be one byte-exact contiguous run of the packets sent, every frame
   after the first block must decode (dummy slots skipped without a
   gap), and kernels A and B must have been launched (B alone with
   `--fec xla`). For each configuration one block is then timed: ms per
   block, launches of kernels A and B per block, and dd_phase_track's
   share;
11. the single-carrier DVB-S receiver, at block_symbols 2^17 and >= 6
   blocks: the port's cli.main in-process on a cf32 file, default
   device, `--mode s` without `--rate`, one carrier for each code rate
   (1/2, 2/3, 3/4, 5/6, 7/8). The rate found must be the rate sent, every
   block's re-encode BER < 0.05 with the carrier locked at the end, the
   TS one byte-exact contiguous run of the packets sent, and kernels B
   and C launched (C once a locked block). Then rate 1/2 in two runs
   joined by a `--state-file`, equal to the uninterrupted run; and for
   each rate one locked block timed (min and mean of 3, host clock
   around process_block ending in a synchronise) with its count of
   CUDA kernels and kernel C's share from a torch.profiler pass;
12. the first-block DVB-S bank: build_dvbs_bank with the DVB-S bank's 8
   carriers (rate 1/2, cs4), 2^17 samples, one step: every carrier's
   re-encode BER < 0.02, its bits through the host tail one byte-exact
   contiguous run of its own packets, kernels B and C launched; then
   the step is timed with CUDA events;
13. the LMS equalizer: DVBS2Receiver(equalize=True, fec="pallas") on a
   QPSK 1/2 carrier through a static 2-ray echo (0.18 - 0.1j at 2
   symbols, 9 dB, seed 6) at 2^15 symbols of short frames and at 2^17 of
   normal frames: every frame decodes, the equalizer's output on the
   card is within 1e-4 max abs of lms_equalize on the CPU on the same
   symbols, kernel B launched; each block is timed with and without the
   equalizer (ms per block, CUDA kernels per block), and the equalizer
   alone;
14. the sharded builds at world size 1 over NCCL (a FileStore in a
   temporary directory, the group destroyed at the end):
   build_multi_carrier with 8 distinct carriers (2^15 symbols, short
   frames): every frame decodes, locked == C*F; DVBS2BankStream over
   build_carrier_bank_sharded at the main path's geometry and signals
   (8 carriers of QPSK 1/2 normal frames, cs4, >= 4 blocks plus flush):
   every frame decodes and every carrier's TS is one byte-exact
   contiguous run, its step timed beside the unsharded
   build_carrier_bank(fec="xla"), replayed as CUDA graphs (its capture
   timed apart) and eager, and the gather alone;
   build_time_sharded at 2^15 short and 2^17 normal frames: every
   output equal to the receiver's symbol program and full-budget FEC on
   the same wrapped window; entry() once. Kernel B launched on each;
15. the wideband CLI: cli.main in-process on one cf32 capture at 6
   samples a symbol (Es/N0 15 dB a carrier, 10 ppm) of four DVB-S2 QPSK
   1/2 normal-frame carriers at offsets -2.1, -0.7, 0.7 and 2.1 (--fec
   pallas, the CLI's default cs8 ingest: the channelizer, then the fused
   bank of 4 x 32 frames for two blocks plus flush): every frame decodes,
   each carrier's file is one byte-exact contiguous run of its packets,
   kernels A and B launched once a block; then --mode s --rate 1/2 on
   two DVB-S carriers at -1.4 and 1.4 (the fused DVB-S bank, 2^17
   symbols a block, >= 6 blocks): locked, contiguous, B and C launched;
16. live ingest: cli.main on udp://127.0.0.1 (a QPSK 1/2 normal-frame
   carrier at 2.7 samples a symbol, 0.2 off centre, >= 6 blocks of 2^17
   symbols, cf32 datagrams of 4096 samples sent by a thread once the
   CLI has bound): free-running at one block's samples per 50 ms (the
   datagrams lost and SO_RCVBUF printed; every packet out was sent, and
   with none lost the output is contiguous), then never more datagrams
   ahead than a quarter of the socket's buffer, with --control commands written
   to a stdin pipe as it streams (metrics, symbolrate, the UDP sink on,
   off, save, an unknown command): none lost, every command applied,
   and the file's and the second socket's TS together one contiguous run;
17. GSE -> GRE: the main path's bank program on 8 seam-free GSE carriers
   (cs4, two blocks plus flush) and DVBS2Stream at 2^17 symbols: every
   frame decodes and each output is exactly the reference parser's GRE
   output on the sent frames of the decoded span, the sent PDUs i..j in
   order;
18. the failure paths: DVBS2Stream at 2^17 symbols across signal loss
   (then the signal at delay 7.35 and CFO -0.015 pi) and across a
   3.3-sample timing step; the 8-carrier QPSK 1/2 bank (f16 ingest, that
   is cs8; fec pallas) with a dead carrier, a starved first pass
   (n_iters=1, two carriers at 3.8 dB: the escalation recovers every
   frame that clears the sync gate) and a carrier on MODCOD 6 (the bank does not switch;
   detected_pls shows it); fec pallas at 3 carriers (kernel A at 6
   frames against its plain version); the cs8 bank on the main path's
   signals (the same TS as the cs4 main path); a 2-carrier DVB-S bank at
   2^17 samples a block with carrier 1 noise for 23 blocks (the
   watchdog unlocks it, it relocks, carrier 0 stays contiguous);
19. the examples: dvbs_tpu_torch.examples.loopback_demo and
   carrier_bank_demo --bench-shape in-process;
20. every shape at which phases 7 to 19 launched kernel A, B or C or the
   soft demapper (backend.SHAPES) against the kernel's plain version:
   those the kernels' phases did not compare are compared here.

Phases 15 to 19 take their signals from workers that run on while
phases 7 to 14 run.

With --profile TRACE.json, a torch.profiler breakdown of the QPSK,
DVB-S and 32APSK bank steps by layer and kernel follows their phases,
and each single-carrier block (DVB-S2 and DVB-S) gains its count of
CUDA kernels, their device time and a per-layer breakdown; the Chrome
traces go to TRACE.json, TRACE_dvbs.json, TRACE_32apsk.json and
TRACE_<name>.json.

Prints the kernels' JSON line (launches: the sum over the main paths'
runs, each run with the counts set to 0 just before it; bound_ms: the
larger of the bytes each kernel must move over 3.35 TB/s and its
operations over the card's rate for their type, from this run's inputs),
then as its last line {"ok": true, "device": {...}}. Needs one CUDA
device. With --kernels it drives no main path but the probe's: it stops
after phase 6 and the kernels' line, the other kernels' launches 0 (a
quick check of the kernels alone; no "ok" line).
"""
import argparse
import contextlib
import io
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

N_CARRIERS = 8
MC, SHORT = 4, False            # QPSK 1/2, normal frames (LDPC table B4)
E2E_BLOCKS = 4
RESAMPLE_TOL = 1e-5
DVBS_BLOCK = 2 * (1 << 18)      # the DVB-S bank's block, samples per carrier
DVBS_BLOCKS = 5                 # streamed: (DVBS_BLOCKS + 1) blocks' worth
# kernel A's noisy checks: (table, code rate, Eb/N0 dB near the int8
# decoder's threshold, where the trials spread over sweeps 7..10)
LDPC_CASES = (("B4", 1 / 2, 2.5), ("B7", 3 / 4, 3.0), ("B6", 2 / 3, 2.6))
# kernel A's small batches, (table, frames per call): what the
# single-carrier receiver gives it at 2^17 symbols a block (3 frames of
# QPSK 1/2 on B4, 5 of 8PSK 3/4 and 8 of 32APSK 3/4 on B7, 7 of 16APSK
# 2/3 on B6), and 3 and 8 on both B4 and B7
SMALL_BATCHES = (("B4", (3, 8)), ("B7", (3, 5, 8)), ("B6", (7,)))
ALL_TABLES = tuple(f"B{i}" for i in range(1, 12)) + \
    tuple(f"C{i}" for i in range(1, 11))
# kernel A timed at these fixed sweep counts (0: the call's set-up alone)
SWEEP_COUNTS = (0, 3, 5, 8, 10)
# integer operations per edge and sweep of the layered decoder, as the
# kernel does them. Pass 1 (7): subtract the message, take the
# magnitude, two xors for the two running parities, and max, min, min
# for the two minima (no arg-min is kept). Pass 2 (13): compare the
# magnitude with the first minimum and select the message's magnitude,
# form the sign (xor, shift) and apply it (xor, subtract), damp a sign
# flip (test the old message, xor, test the sign, select), add to the
# posterior and saturate (min, max). Left out: the two offset-and-clip
# magnitudes of a layer (6 operations a layer, under 1 an edge), the
# address arithmetic and the packing of messages four to a word
LDPC_OPS_PER_EDGE = 7 + 13
# float operations per trellis step of the radix-8 Viterbi kernel: per
# 3 steps, 64 states x 8 predecessors x (add, compare, select) plus 32
# branch sums of 5 adds (the other 32 are their negations, and the sign
# rides in the path metric's add); none is a fused multiply-add, so
# they are counted at F32_ADD_OPS
VITERBI_OPS_PER_STEP = (64 * 8 * 3 + 32 * 5) / 3
# the soft demapper at the banks' shapes: (symbols, points, Es/N0 dB,
# label); each constellation's MODCOD for the points and the ring ratios
DEMAP_SHAPES = ((128 * 12960, 32, 14.5, "32APSK 3/4 pilots bank"),
                (128 * 32400, 4, 5.0, "QPSK 1/2 bank"))
DEMAP_MODCOD = {4: 4, 8: 14, 16: 18, 32: 24}
# the pilots banks: MODCOD, SNR dB, label
PILOTS_BANKS = ((14, 9.5, "8psk34"), (18, 11.0, "16apsk23"),
                (24, 14.5, "32apsk34"))
PILOTS_PKTS = 700               # packets per carrier of a pilots bank
STREAM_MC = 14                  # the pilots bank also streamed
STREAM_BLOCKS = 2               # streamed: >= 2 blocks plus flush
GRAPH_MC = 24                   # the pilots bank stepped as CUDA graphs
GRAPH_REPS, GRAPH_TRACED = 20, 5    # steps timed, steps traced, each way
# the ranges whose device operations the benchmark reads
GRAPH_RANGES = ("frontend", "timing", "resample", "plsync", "phase",
                "demap", "ldpc", "bch_pack", "bank.step")
# the single-carrier slice: name -> MODCOD, pilots, SNR dB (those at which
# the JAX package's tests and bench decode these MODCODs), dummy PLFRAMEs
# (one after every n-th data frame) or None
SLICE_BLOCK = 1 << 17           # the CLI's default block, symbols
SLICE_BLOCKS = 6
SLICE = {"qpsk12": (4, False, 5.0, None), "8psk34": (14, False, 11.0, None),
         "16apsk23": (18, False, 14.0, None),
         "32apsk34p": (24, True, 14.5, None),
         "8psk34_dummies": (14, False, 11.0, 3)}
# the single-carrier DVB-S phase: code rate -> Es/N0 dB, about 3 dB
# above where each rate's TS comes out clean after RS(204,188)
DVBS_SINGLE = {"1/2": 8.0, "2/3": 9.0, "3/4": 10.0, "5/6": 11.0,
               "7/8": 12.0}
FIRST_BANK_BLOCK = 1 << 17      # build_dvbs_bank's block, samples
# the equalizer phase: name -> short frames, block symbols, packets (QPSK
# 1/2 through the JAX package's test echo)
EQ = {"eq_short": (True, 1 << 15, 120), "eq_normal": (False, 1 << 17, 200)}
EQ_TOL = 1e-4                   # card against CPU, max abs, equalized
# the wideband CLI phase: one capture at WIDE_RATE (symbol rate 1.0) of
# four DVB-S2 QPSK 1/2 normal-frame carriers (the bank of 4 x 32 frames:
# one launch of kernel A a block) for the first block and WIDE_S2_BLOCKS
# more plus flush, then of two DVB-S rate-1/2 carriers for the first
# block and WIDE_DVBS_BLOCKS more; Es/N0 per carrier, 10 ppm clock
WIDE_RATE, WIDE_SNR = 6, 15.0
WIDE_S2 = (-2.1, -0.7, 0.7, 2.1)
WIDE_S2_BLOCKS = 1
WIDE_DVBS = (-1.4, 1.4)
WIDE_DVBS_BLOCK, WIDE_DVBS_BLOCKS = 1 << 17, 6
# live ingest: one QPSK 1/2 normal-frame carrier at UDP_SPS samples a
# symbol, UDP_OFFSET off centre, UDP_SNR dB, for the first block and
# UDP_BLOCKS more, sent as cf32 datagrams of UDP_DATAGRAM samples at no
# more than one block's samples per UDP_PACE seconds
UDP_SPS, UDP_OFFSET, UDP_SNR = 2.7, 0.2, 10.0
UDP_BLOCKS, UDP_DATAGRAM, UDP_PACE = 6, 4096, 0.05
# GSE: the QPSK 1/2 bank's first block and GSE_BLOCKS more plus flush
GSE_BLOCKS = 1
# the failure paths: DVBS2Stream blocks of SLICE_BLOCK symbols (signal
# loss and a timing step, the JAX package's tests/test_reacquire.py at
# normal frames); the banks run FAIL_BLOCKS after the first plus flush;
# the DVB-S watchdog: 2 carriers, WATCH_BLOCKS blocks of WATCH_BLOCK
# samples, carrier 1 noise for blocks WATCH_DEAD
FAIL_BLOCKS = 2
WATCH_BLOCK, WATCH_BLOCKS, WATCH_DEAD = 1 << 17, 32, (3, 26)


def dvbs_key(rate: str) -> str:
    """The signal key (and file name) of DVBS_SINGLE[rate]."""
    return "dvbs" + rate.replace("/", "")


# the card's published peaks (H100 SXM): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, which count a fused multiply-add as two;
# float32 adds, compares and selects, none of them fused (67e12 / 2);
# and integer ALU operations/s (Hopper has half as many INT32 as FP32
# lanes: 67e12 / 2 / 2)
HBM_BPS, F32_OPS, F32_ADD_OPS, I32_OPS = 3.35e12, 67e12, 33.5e12, 16.75e12


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time the card could take: bytes over the memory rate
    against operations over their peak rate, the larger, in ms."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def cuda_ms(fn, reps: int, batches: int = 1) -> float:
    """Mean ms per call of fn() over reps calls, by CUDA events; the
    least such mean of `batches` batches (a kernel shorter than the
    host's launch reads high whenever the host is held up, and the
    kernels' checks share the host with the signals' workers)."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def cuda_once(fn):
    """(fn(), its ms by CUDA events): one call, nothing run before it."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


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
    # per kernel: its (mangled) name, then registers, shared memory, spills
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            print("  ptxas: " + line.split("'")[1][:70])
        elif "registers" in line or "spill" in line:
            print(f"  ptxas:   {line.replace('ptxas info    :', '').strip()}")


# ---------------------------------------------------------------------------
# signals, made in worker processes (numpy only; they never touch the card)
# ---------------------------------------------------------------------------

def s2_carrier(mc: int, pilots: bool, n_pkts: int, seed: int, cfo: float,
               delay: float, snr_db: float, keep: bool = False):
    """One carrier of signals.s2_carrier_signal, cs4-packed, and its TS
    packets; with `keep`, the complex64 samples too."""
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.ops.frontend import pack_cs4
    from dvbs_tpu_torch.tx import signals
    cfg = modcod.get_config(mc, short=False, pilots=pilots)
    y, sent = signals.s2_carrier_signal(cfg, n_pkts, seed, cfo, delay,
                                        snr_db=snr_db)
    return (pack_cs4(y), sent) + ((y,) if keep else ())


def s2_stream(mc: int, symbols: int, seed: int):
    """(TS packets [n, 188], PL symbols) of MODCOD mc normal frames,
    at least `symbols` long."""
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.tx import dvbs2_mod
    cfg = modcod.get_config(mc, short=False)
    n_frames = symbols // cfg.plframe_len + 3
    pkts = dvbs2_mod.random_ts_packets(
        int(n_frames * (cfg.kbch - 80) / 8 / 188) + 1, seed=seed)
    tx = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
    assert len(tx) >= symbols, (len(tx), symbols)
    return pkts.reshape(-1, 188), tx


def wide_symbols(kind: str) -> int:
    """Symbols a carrier of the wideband capture `kind` ("s2", "dvbs")
    must hold: the blocks the CLI's bank consumes, and 4 frames (or 8192
    symbols) more for the channelizer's delay and the flush."""
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.parallel.mesh import bank_block_symbols
    if kind == "dvbs":
        return (WIDE_DVBS_BLOCKS + 1) * WIDE_DVBS_BLOCK + 8192
    cfg = modcod.get_config(MC, short=False)
    block = bank_block_symbols(len(WIDE_S2), mc=MC)
    F = (block - 2 * 256 - 90) // cfg.plframe_len - 1
    return stream_need(cfg, block, F, WIDE_S2_BLOCKS) // 2 + \
        4 * cfg.plframe_len


def wide_carrier(kind: str, c: int):
    """Carrier c of the wideband capture `kind`, at WIDE_RATE samples a
    symbol and mixed to its offset: (complex64 samples, packets sent)."""
    from dvbs_tpu_torch.tx import channel, dvbs_mod
    n = wide_symbols(kind)
    if kind == "s2":
        sent, tx = s2_stream(MC, n + 64, 300 + c)
        offset = WIDE_S2[c]
    else:
        ts = dvbs_mod.random_ts_groups(n // 13056 + 3, seed=320 + c)
        tx = dvbs_mod.DVBSModulator(rate="1/2").ts_to_symbols(ts)
        sent, offset = ts.reshape(-1, 188), WIDE_DVBS[c]
    # mixed to its offset plus a CFO of 0.004 + 0.003 c symbol rates
    y = channel.impair(channel.shape(tx, sps=WIDE_RATE),
                       cfo=2 * np.pi * (offset + 0.004 + 0.003 * c)
                       / WIDE_RATE,
                       delay_samples=(0.1 + 0.075 * c) * WIDE_RATE,
                       sco_ppm=10.0)
    return y[:n * WIDE_RATE], sent


def wide_noise(kind: str):
    """The wideband capture's noise: Es/N0 WIDE_SNR for each carrier."""
    from dvbs_tpu_torch.tx import channel
    return channel.impair(np.zeros(wide_symbols(kind) * WIDE_RATE,
                                   np.complex64),
                          snr_db=WIDE_SNR - 10 * np.log10(WIDE_RATE),
                          seed=340 + len(kind))


def udp_signal():
    """The live-ingest carrier: complex64 samples at UDP_SPS, and the
    packets sent."""
    from dvbs_tpu_torch.tx import channel
    n = (UDP_BLOCKS + 2) * SLICE_BLOCK
    sent, tx = s2_stream(MC, n + 64, 330)
    # 27 samples a symbol, every tenth kept; mixed to UDP_OFFSET plus a
    # CFO of 0.004 symbol rates
    y = channel.impair(channel.shape(tx, sps=27)[::10],
                       snr_db=UDP_SNR - 10 * np.log10(UDP_SPS),
                       cfo=2 * np.pi * (UDP_OFFSET + 0.004) / UDP_SPS,
                       delay_samples=0.4, sco_ppm=10.0, seed=331)
    return y[:int(n * UDP_SPS)], sent


def gse_carrier(c: int, need: int, cs4: bool):
    """A seam-free GSE carrier of the bench's GSE gate (its seeds, CFOs,
    delays and 6 dB) holding `need` samples: (samples, cs4-packed when
    `cs4`, the PDUs sent, their scrambled BBFRAMEs)."""
    from dvbs_tpu_torch.ops.frontend import pack_cs4
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.tx import signals
    cfg = modcod.get_config(MC, short=False)
    frames = need // (2 * cfg.plframe_len) + 3
    n = 10
    while len(signals.gse_bbframes([b"\0" * (300 + 13 * i)
                                    for i in range(n)], cfg.kbch)) < frames:
        n += 10
    y, pdus = signals.s2_carrier_signal(cfg, n, 210 + 3 * c,
                                        (0.006 + 0.002 * c) * np.pi,
                                        0.3 + 0.07 * c, payload="gse",
                                        snr_db=6.0)
    assert len(y) >= need, (len(y), need)
    return (pack_cs4(y) if cs4 else y), pdus, \
        signals.gse_bbframes(pdus, cfg.kbch)


def reacq_signal(seed: int, samples: int, cfo: float, delay: float):
    """tests/test_reacquire.py's signal at normal frames: QPSK 1/2, 8 dB,
    10 ppm; complex64 samples and the packets sent."""
    from dvbs_tpu_torch.tx import channel
    sent, tx = s2_stream(MC, samples // 2 + 64, seed)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=8.0, cfo=cfo,
                       delay_samples=delay, sco_ppm=10.0, seed=seed + 1)
    return y[:samples], sent


def timing_step_signal(samples: int, step_at: int):
    """tests/test_reacquire.py's timing step at normal frames: the same
    stream at a delay of 0.2 samples, then from `step_at` on at 3.5.
    channel.impair keeps the samples from t = 8 on (sample j is the
    signal at j + 8.2, and at j + 8.5 for 3.5), so the second part is
    read 3 samples on: a step of 3.3 samples (the JAX package's test
    steps by 0.3)."""
    from dvbs_tpu_torch.tx import channel
    sent, tx = s2_stream(MC, samples // 2 + 64, 8)
    x = channel.shape(tx, sps=2)
    y1, y2 = (channel.impair(x, snr_db=8.0, cfo=0.006 * np.pi,
                             delay_samples=d, seed=9) for d in (0.2, 3.5))
    return np.concatenate([y1[:step_at], y2[step_at + 3:samples + 3]]), \
        sent


def watch_carrier(c: int):
    """Carrier c of the DVB-S bank's signals, WATCH_BLOCKS blocks long,
    complex64, and its packets."""
    from dvbs_tpu_torch.tx import signals
    return signals.dvbs_carrier_signal(c, WATCH_BLOCKS * WATCH_BLOCK)


def dvbs_carrier(c: int):
    """One of the DVB-S bank's signals: a seam-free rate-1/2 stream at
    8 dB, cs4-packed, and its TS packets."""
    from dvbs_tpu_torch.ops.frontend import pack_cs4
    from dvbs_tpu_torch.tx import signals
    y, sent = signals.dvbs_carrier_signal(c, (DVBS_BLOCKS + 1) * DVBS_BLOCK)
    return pack_cs4(y), sent


def slice_frames(cfg) -> int:
    """Frames per block of the single-carrier receiver at SLICE_BLOCK."""
    return (SLICE_BLOCK - 2 * 256 - 90) // cfg.plframe_len - 1


def slice_signal(name: str):
    """The single-carrier signal of SLICE[name]: complex64 samples for
    the first block and SLICE_BLOCKS more, and the packets sent. Normal
    frames, CFO 0.008 pi, delay 0.2 samples, 10 ppm clock offset."""
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.tx import channel, dvbs2_mod
    mc, pilots, snr_db, dummy_every = SLICE[name]
    cfg = modcod.get_config(mc, short=False, pilots=pilots)
    L = cfg.plframe_len
    need = 2 * SLICE_BLOCK + SLICE_BLOCKS * 2 * slice_frames(cfg) * L + 2 * L
    n_frames = need // (2 * L) + 3
    n_pkts = int(n_frames * (cfg.kbch - 80) / 8 / 188) + 1
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=70 + mc)
    frames = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg)
    tx = frames.reshape(-1) if dummy_every is None else \
        dvbs2_mod.interleave_dummies(frames, every=dummy_every)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=snr_db,
                       cfo=0.008 * np.pi, delay_samples=0.2, sco_ppm=10.0,
                       seed=71 + mc)
    assert len(y) >= need, (name, len(y), need)
    return y.astype(np.complex64), pkts.reshape(-1, 188)


def dvbs_single_signal(rate: str):
    """One DVB-S carrier at `rate` (DVBS_SINGLE's Es/N0) for the first
    block and SLICE_BLOCKS more at SLICE_BLOCK symbols a block, with a
    margin for the timing drift: complex64 samples and the packets sent.
    CFO 0.004 pi, phase 0.4 rad, delay 0.3 samples, 10 ppm."""
    from dvbs_tpu_torch.spec import dvbs_fec
    from dvbs_tpu_torch.tx import channel, dvbs_mod
    i = dvbs_fec.RATES.index(rate)
    px, py = dvbs_fec.PUNCTURE[rate]
    # a group is 8 x 204 bytes, n_kept coded bits for every p of them;
    # a symbol carries 2 coded bits in 2 samples
    per_group = 8 * 204 * 8 * int(px.sum() + py.sum()) // len(px)
    need = (SLICE_BLOCKS + 1) * 2 * SLICE_BLOCK
    ts = dvbs_mod.random_ts_groups(-(-need // per_group) + 3, seed=80 + i)
    tx = dvbs_mod.DVBSModulator(rate=rate).ts_to_symbols(ts)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=DVBS_SINGLE[rate],
                       cfo=0.004 * np.pi, phase=0.4, delay_samples=0.3,
                       sco_ppm=10.0, seed=90 + i)
    assert len(y) >= need + 2 * per_group, (rate, len(y), need)
    return y.astype(np.complex64), ts.reshape(-1, 188)


def eq_signal(name: str):
    """The equalizer phase's carrier EQ[name]: QPSK 1/2 through a static
    2-ray echo at 2 symbols (0.18 - 0.1j), 9 dB, CFO 0.004 pi, seed 6,
    as the JAX package's tests/test_equalizer.py; complex64 samples and
    the packets sent."""
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.tx import channel, dvbs2_mod
    short, _, n_pkts = EQ[name]
    cfg = modcod.get_config(4, short=short)
    pkts = dvbs2_mod.random_ts_packets(n_pkts, seed=5)
    tx = dvbs2_mod.bbframes_to_plframes(
        dvbs2_mod.ts_to_bbframes(pkts, cfg), cfg).reshape(-1)
    x = channel.shape(tx, sps=2)
    echo = np.zeros(3, np.complex64)
    echo[0], echo[2] = 1.0, 0.18 - 0.1j
    y = channel.impair(np.convolve(x, echo)[:len(x)], snr_db=9.0,
                       cfo=0.004 * np.pi, seed=6)
    return y.astype(np.complex64), pkts.reshape(-1, 188)


def stream_need(cfg, block: int, F: int, blocks: int) -> int:
    """Samples per carrier that a stream of `blocks` blocks after the
    first, plus flush, consumes (2 samples per symbol)."""
    return 2 * block + blocks * 2 * F * cfg.plframe_len + \
        2 * cfg.plframe_len


def stream_pkts(mc: int) -> int:
    """Packets per carrier that cover the streamed pilots run."""
    from dvbs_tpu_torch.spec import modcod
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
                               5.0, True) for c in cs]}
    for mc, snr, _ in PILOTS_BANKS:
        n_pkts = stream_pkts(mc) if mc == STREAM_MC else PILOTS_PKTS
        jobs[mc] = [pool.submit(s2_carrier, mc, True, n_pkts, 110 + 3 * c,
                                (0.006 + 0.002 * c) * np.pi, 0.25 + 0.1 * c,
                                snr) for c in cs]
    jobs["dvbs"] = [pool.submit(dvbs_carrier, c) for c in cs]
    for name in SLICE:
        jobs[name] = [pool.submit(slice_signal, name)]
    for rate in DVBS_SINGLE:
        jobs[dvbs_key(rate)] = [pool.submit(dvbs_single_signal, rate)]
    for name in EQ:
        jobs[name] = [pool.submit(eq_signal, name)]
    return jobs


def gse_need(bank: bool) -> int:
    """Samples a GSE carrier holds: the bank's first block and
    GSE_BLOCKS more plus flush, or 6 single-carrier blocks."""
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.parallel.mesh import bank_block_symbols
    cfg = modcod.get_config(MC, short=False)
    if not bank:
        return 6 * 2 * SLICE_BLOCK
    block = bank_block_symbols(N_CARRIERS, mc=MC)
    F = (block - 2 * 256 - 90) // cfg.plframe_len - 1
    return stream_need(cfg, block, F, GSE_BLOCKS)


def start_late_signals(pool) -> dict:
    """Submit the signals of the phases after the sharded builds (they
    are made while the earlier phases run): {phase: [futures]}."""
    from dvbs_tpu_torch.spec import modcod
    n = 2 * SLICE_BLOCK
    cfg6 = modcod.get_config(6, short=False)
    need6 = stream_need(cfg6, 552960, 16, FAIL_BLOCKS)
    pkts6 = int((need6 // (2 * cfg6.plframe_len) + 3) *
                (cfg6.kbch - 80) / 8 / 188) + 1
    jobs = {}
    for kind, offsets in (("s2", WIDE_S2), ("dvbs", WIDE_DVBS)):
        jobs["wide_" + kind] = [pool.submit(wide_carrier, kind, c)
                                for c in range(len(offsets))]
        jobs[f"wide_{kind}_noise"] = [pool.submit(wide_noise, kind)]
    jobs["udp"] = [pool.submit(udp_signal)]
    jobs["gse"] = [pool.submit(gse_carrier, c, gse_need(True), True)
                   for c in range(N_CARRIERS)]
    jobs["gse1"] = [pool.submit(gse_carrier, N_CARRIERS, gse_need(False),
                                False)]
    jobs["reacq_a"] = [pool.submit(reacq_signal, 31, 3 * n, 0.008 * np.pi,
                                   0.2)]
    jobs["reacq_b"] = [pool.submit(reacq_signal, 47, 5 * n, -0.015 * np.pi,
                                   7.35)]
    jobs["timing"] = [pool.submit(timing_step_signal, 9 * n, 3 * n + n // 3)]
    jobs["mc6"] = [pool.submit(s2_carrier, 6, False, pkts6, 17,
                               0.005 * np.pi, 0.45, 6.0, True)]
    jobs["watch"] = [pool.submit(watch_carrier, c) for c in range(2)]
    return jobs


def take(jobs: dict, key: str) -> list:
    """The results of a late phase's signal jobs, in order."""
    return [f.result() for f in jobs[key]]


def collect_signals(jobs: dict, t0: float, workers: int) -> dict:
    """Wait for every phase's signals: {phase: ([cs4 per carrier],
    [packets per carrier])}, or (samples, packets) for a slice signal."""
    sigs = {k: [f.result() for f in v] for k, v in jobs.items()}
    single = set(SLICE) | set(EQ) | {dvbs_key(r) for r in DVBS_SINGLE}
    out = {}
    for k, v in sigs.items():
        if k in single:                 # one carrier: (samples, packets)
            out[k] = v[0]
            continue
        cs4 = [r[0] for r in v]
        if k != "dvbs":                 # equal lengths
            n = min(len(s) for s in cs4)
            cs4 = [s[:n] for s in cs4]
        out[k] = (cs4, [r[1] for r in v])
        if k == "s2":                   # the main path's, complex64
            out["s2c"] = [r[2][:n] for r in v]
    print(f"signals: {sum(len(v) for v in sigs.values())} carriers in "
          f"{workers} worker processes ({time.perf_counter() - t0:.1f} s "
          f"since they were started, the build and the kernels' checks "
          f"included): " + ", ".join(
              f"{k} {len(v[0] if k in single else v[0][0])} samples"
              for k, v in out.items() if k != "s2c"))
    return out


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def noisy_llrs(torch, dev, table: str, rate: float, ebno: float, F: int,
               rng):
    """(int8 LLRs [F, N] on the card, the codewords sent) at Eb/N0 dB."""
    from dvbs_tpu_torch.spec import ldpc_spec
    from dvbs_tpu_torch.ops import ldpc_kernel
    code = ldpc_spec.get_code(table)
    cw = code.encode(rng.integers(0, 2, (F, code.K)).astype(np.uint8))
    sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebno / 10)))
    y = 1.0 - 2.0 * cw.astype(np.float32) + \
        rng.normal(0, sigma, cw.shape).astype(np.float32)
    return ldpc_kernel.quantize_llrs(
        torch.from_numpy(2.0 * y / sigma ** 2).to(dev)), cw


# the shapes each kernel was held against its plain version at (kernel
# A [frames, N], kernel B [C, S], kernel C [B, T], the soft demapper
# [symbols, points]); phase_coverage holds every other shape the main
# paths launched
COMPARED = {"ldpc_layered": set(), "resample_farrow": set(),
            "viterbi_acs": set(), "soft_demap": set()}


def same_decode(torch, label: str, got, ref) -> int:
    """Raise unless kernel A's (hard, n_bad, trials) equal the plain
    version's; returns the largest difference (0)."""
    torch.cuda.synchronize()
    COMPARED["ldpc_layered"].add(tuple(got[0].shape))
    for name, a, b in zip(("hard", "n_bad", "trials"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(
                f"kernel A {label}: {name} differs from the plain version "
                f"in {int((a != b).sum())} places")
    return max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
               for a, b in zip(got, ref))


def phase_ldpc(torch, dev):
    """Kernel A against its plain version on each table of LDPC_CASES.
    The kernels row reports B4's noisy case (the headline bank's)."""
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import ldpc_kernel
    row, errs = None, []
    for k, (table, rate, ebno) in enumerate(LDPC_CASES):
        kt = tables.kernel_tables(table)
        B, N = ldpc_kernel.CALL_FRAMES, kt["N"]
        rng = np.random.default_rng(1 + k)
        rand = torch.from_numpy(rng.integers(-25, 26, (B, N))
                                .astype(np.int8)).to(dev)
        noisy, cw = noisy_llrs(torch, dev, table, rate, ebno, B, rng)
        for label, llr, n_iters, ee in (
                ("random, 1 sweep", rand, 1, False),
                (f"Eb/N0 {ebno} dB, 12 sweeps, early exit", noisy, 12, True)):
            got = ldpc_kernel.decode_cuda(llr, kt, n_iters, early_exit=ee)
            # the plain version runs once: the reference and its time
            ref, plain_ms = cuda_once(lambda: ldpc_kernel.decode_plain(
                llr, kt, n_iters, early_exit=ee))
            errs.append(same_decode(torch, f"{table} {label}", got, ref))
            ms = cuda_ms(lambda: ldpc_kernel.decode_cuda(
                llr, kt, n_iters, early_exit=ee), 10, batches=3)
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
            if ee and row is None:
                # bytes: int8 LLRs in, hard bits out, two int32 per
                # frame. Operations: the sweeps this batch ran (every
                # frame is swept until the last one is clean) x edges x
                # LDPC_OPS_PER_EDGE integer operations
                edges = int((kt["f_tab"] & tables.F_VALID).sum()) * 360
                ops = B * edges * int(tr.max()) * LDPC_OPS_PER_EDGE
                row = dict(name="ldpc_layered", route="cuda",
                           source="dvbs_tpu_torch/csrc/ldpc_layered.cu",
                           replaces="dvbs_tpu/ops/ldpc_pallas.py:478",
                           ms=ms, plain_ms=plain_ms, library_ms=None,
                           **bound(2 * B * N + 8 * B, ops, I32_OPS))
                print(f"kernel A bound: {edges} edges a frame x {B} frames "
                      f"x {int(tr.max())} sweeps x {LDPC_OPS_PER_EDGE} int "
                      f"ops = {ops:.3g} ops -> {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}); bytes {2 * B * N + 8 * B}")
                # a fixed number of sweeps, no early exit: the time a sweep
                for F in (B, 3):
                    ts = [cuda_ms(lambda: ldpc_kernel.decode_cuda(
                        noisy[:F], kt, n, early_exit=False), 10)
                        for n in SWEEP_COUNTS]
                    per = (ts[-1] - ts[1]) / (SWEEP_COUNTS[-1] -
                                              SWEEP_COUNTS[1])
                    print(f"kernel A {table} [{F}, {N}] at "
                          f"{SWEEP_COUNTS} sweeps run, no early exit: "
                          f"{', '.join(f'{t:.3f}' for t in ts)} ms a call; "
                          f"{per:.4f} ms for each further sweep")
    # the single-carrier receiver's calls: its F frames as they are
    cases = {table: (rate, ebno) for table, rate, ebno in LDPC_CASES}
    for table, Fs in SMALL_BATCHES:
        rate, ebno = cases[table]
        kt = tables.kernel_tables(table)
        for F in Fs:
            llr, _ = noisy_llrs(torch, dev, table, rate, ebno, F,
                                np.random.default_rng(10 + F))
            got = ldpc_kernel.decode_cuda(llr, kt, 12)
            ref = ldpc_kernel.decode_plain(llr, kt, 12)
            errs.append(same_decode(torch, f"{table} F={F}", got, ref))
            ms = cuda_ms(lambda: ldpc_kernel.decode_cuda(llr, kt, 12), 10)
            print(f"kernel A {table} [{F}, {kt['N']}] Eb/N0 {ebno} dB, 12 "
                  f"sweeps, early exit: bit-exact; trials "
                  f"{got[2].tolist()}, n_bad {got[1].tolist()}; kernel "
                  f"{ms:.3f} ms")
    # every table: each Dmax specialisation, barrier flag and padding
    # entry. Two fixed sweeps, so that the second meets messages
    t0 = time.perf_counter()
    for k, table in enumerate(ALL_TABLES):
        kt = tables.kernel_tables(table)
        llr = torch.from_numpy(np.random.default_rng(30 + k).integers(
            -40, 41, (3, kt["N"])).astype(np.int8)).to(dev)
        ref = ldpc_kernel.decode_plain(llr, kt, 2, early_exit=False)
        # random LLRs never come clean, so the early exit's cooperative
        # launch must give the same
        for ee in (False, True):
            got = ldpc_kernel.decode_cuda(llr, kt, 2, early_exit=ee)
            errs.append(same_decode(
                torch, f"{table} random, 2 sweeps, early_exit={ee}", got,
                ref))
    print(f"kernel A on all {len(ALL_TABLES)} tables ({', '.join(ALL_TABLES)})"
          f" [3, N], random int8, 2 sweeps, both launch kinds: bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")
    # one frame, and more than a call holds (decode_calls: 128 + 2), a
    # decibel above the threshold so that the plain version ends early
    table, rate, ebno = LDPC_CASES[0]
    kt = tables.kernel_tables(table)
    for F in (1, ldpc_kernel.CALL_FRAMES + 2):
        llr, cw = noisy_llrs(torch, dev, table, rate, ebno + 1.0, F,
                             np.random.default_rng(50 + F))
        got = ldpc_kernel.decode_calls(llr, table, 12)
        calls = [ldpc_kernel.decode_plain(
            llr[lo:lo + ldpc_kernel.CALL_FRAMES], kt, 12)
            for lo in range(0, F, ldpc_kernel.CALL_FRAMES)]
        ref = tuple(torch.cat([c[i] for c in calls]) for i in range(3))
        errs.append(same_decode(torch, f"{table} F={F}", got, ref))
        assert (got[0].cpu().numpy() == cw).all(), (table, F)
        print(f"kernel A {table} [{F}, {kt['N']}] Eb/N0 {ebno + 1.0} dB "
              f"through decode_calls ({len(calls)} calls): bit-exact; "
              f"trials {int(got[2].min())}..{int(got[2].max())}")
    row["max_abs_err"] = max(errs)
    return row


def resample_case(torch, dev, C: int, S: int):
    """Kernel B's inputs at [C, S] (noise, a timing path per carrier at
    +-1e-5 of clock offset) and its output against the plain version:
    (y, t, coef, band, max abs err). Raises above RESAMPLE_TOL, or where
    the shifts rb and band coordinates u the kernel derived differ from
    shifts_and_band's in a bit."""
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import resample_kernel as rk
    coef_np, fmid, fhalf = tables.farrow_coeffs()
    coef = torch.from_numpy(coef_np).to(dev)
    band = (fmid, fhalf)
    n2 = 2 * S
    rng = np.random.default_rng(2)
    y = torch.from_numpy((rng.normal(size=(C, n2)) + 1j * rng.normal(
        size=(C, n2))).astype(np.complex64)).to(dev)
    k = np.arange(S)
    t = np.stack([2.0 * k + 0.3 + 0.17 * c +
                  (1 if c % 2 == 0 else -1) * (1 + 0.2 * c) * 1e-5 * k
                  for c in range(C)]).astype(np.float32)
    t = torch.from_numpy(t).to(dev)
    u, rb, bias = rk.shifts_and_band(t, band)
    ku, krb = torch.empty_like(u), torch.empty_like(rb)
    got = rk.resample_cuda(y, t, coef, band, band_out=(ku, krb))
    ref = rk.resample_plain(y, u, rb, bias, coef, S)
    if not torch.equal(krb, rb):
        raise AssertionError(f"kernel B [{C}, {S}]: the kernel's shifts rb "
                             f"differ from shifts_and_band's at "
                             f"{int((krb != rb).sum())} tiles")
    if not torch.equal(ku.view(torch.int32), u.view(torch.int32)):
        raise AssertionError(f"kernel B [{C}, {S}]: the kernel's band "
                             f"coordinates u differ from shifts_and_band's "
                             f"at {int((ku != u).sum())} symbols")
    if not torch.equal(rk.resample_cuda(y, t, coef, band), got):
        raise AssertionError(f"kernel B [{C}, {S}]: the output differs "
                             f"with and without band_out")
    err = float(torch.max(torch.abs(got - ref)))
    if not err <= RESAMPLE_TOL:
        raise AssertionError(f"kernel B [{C}, {S}]: max abs error {err} > "
                             f"{RESAMPLE_TOL}")
    COMPARED["resample_farrow"].add((C, S))
    return y, t, coef, band, err


def resample_shapes() -> tuple:
    """Kernel B's [C, S] on the main paths: the QPSK 1/2 bank, the three
    pilots banks (shift bits 10, 9, 9, 8), the DVB-S bank, the single
    carrier, the first-block bank, short frames; the wideband CLI's 4
    DVB-S2 carriers, 3 carriers x 2 frames, the DVB-S stream banks of 2
    carriers (the wideband CLI's and the watchdog's) with their
    one-carrier locks, and the DVB-S bank's lock."""
    from dvbs_tpu_torch.parallel.mesh import bank_block_symbols
    return ((8, 552960), (8, 377920), (8, 284288), (8, 227392),
            (8, DVBS_BLOCK // 2), (1, SLICE_BLOCK),
            (8, FIRST_BANK_BLOCK // 2), (8, 1 << 15), (1, 1 << 15),
            (len(WIDE_S2), bank_block_symbols(len(WIDE_S2), mc=MC)),
            (3, bank_block_symbols(3, mc=MC, frames_total=6)),
            (len(WIDE_DVBS), WIDE_DVBS_BLOCK), (2, WATCH_BLOCK // 2),
            (1, WATCH_BLOCK // 2), (1, DVBS_BLOCK // 2))


def sass_counts(so: str, kernel: str) -> dict:
    """Instruction counts by opcode in the SASS of the one function of the
    built library whose name holds `kernel` (cuobjdump -sass)."""
    from dvbs_tpu_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if re.search(r"(?<![A-Za-z_])" + kernel, f.split("\n", 1)[0])]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} functions named {kernel} in "
                             f"{so}")
    # opcodes of the instructions that can run (not those under @!PT,
    # the never-true predicate of the compiler's padding)
    ops = [op for pred, op in re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", funcs[0])
        if pred.strip() != "@!PT"]
    return {op: ops.count(op) for op in sorted(set(ops))}


def phase_resample(torch, dev):
    """Kernel B against its plain version at each of resample_shapes(),
    its SASS free of shared-memory loads. The kernels row reports the
    first shape (the headline bank's)."""
    from dvbs_tpu_torch.kernels import build
    from dvbs_tpu_torch.kernels import probe_resample as pr
    from dvbs_tpu_torch.ops import resample_kernel as rk
    ops = sass_counts(str(build.library_path()), "farrow_kernel")
    print(f"kernel B SASS: {sum(ops.values())} instructions, FFMA "
          f"{ops.get('FFMA', 0)}, LDG {ops.get('LDG', 0)}, LDS "
          f"{ops.get('LDS', 0)}, STG {ops.get('STG', 0)}")
    if any(op.startswith("LDS") for op in ops):
        raise AssertionError(f"kernel B loads from shared memory: {ops}")
    row = None
    for C, S in resample_shapes():
        y, t, coef, band, err = resample_case(torch, dev, C, S)
        ms = cuda_ms(lambda: rk.resample_cuda(y, t, coef, band), 20,
                     batches=3)
        plain_ms = cuda_ms(lambda: rk.resample_plain(
            y, *rk.shifts_and_band(t, band), coef, S), 3)
        # device times alone, launches replayed from a CUDA graph: the
        # kernel; shifts_and_band, the glue the kernel absorbed; and a
        # launch floor, torch.mul over as many bytes as the output's
        out = rk.resample_cuda(y, t, coef, band)
        g_ms = pr.graph_ms(lambda: rk.resample_cuda(y, t, coef, band))
        glue_ms = pr.graph_ms(lambda: rk.shifts_and_band(t, band))
        floor_ms = pr.graph_ms(lambda: torch.mul(out, 2.0))
        # bytes: y, t, coef in, out written. Operations: 10 taps x (9
        # multiply-adds of Horner's rule + 2 for re and im)
        nbytes = y.numel() * 8 + t.numel() * 4 + coef.numel() * 4 + \
            C * S * 8
        b = bound(nbytes, C * S * 10 * 22, F32_OPS)
        print(f"kernel B [{C}, {S}]: max abs err {err:.3g} (tol "
              f"{RESAMPLE_TOL}), rb and u equal to shifts_and_band's; "
              f"kernel {ms:.4f} ms eager, graph-replayed {g_ms:.4f} ms = "
              f"{b['bound_ms'] / g_ms:.2f} of its bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); shifts_and_band "
              f"alone {glue_ms:.4f} ms graph-replayed; launch floor "
              f"(torch.mul over the output) {floor_ms:.4f} ms "
              f"graph-replayed; plain {plain_ms:.3f} ms")
        if row is None:
            row = dict(name="resample_farrow", route="cuda",
                       source="dvbs_tpu_torch/csrc/resample_farrow.cu",
                       replaces="dvbs_tpu/ops/resample_pallas.py:202",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=None, **b)
            print(f"kernel B bound: {nbytes} bytes -> "
                  f"{nbytes / HBM_BPS * 1e3:.4f} ms; {C * S * 220} flops -> "
                  f"{C * S * 220 / F32_OPS * 1e3:.4f} ms "
                  f"({row['bound_by']})")
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return row


def demap_case(torch, dev, n: int, M: int, snr_db: float):
    """The soft demapper's inputs at [n, M]: n noisy points of the bank's
    constellation of M points (the MODCOD of DEMAP_MODCOD) at snr_db Es/N0,
    and its output against the plain version: (syms, kind, pts, mask0,
    and demap.against_plain's max abs err, share of the tolerance and
    LLRs at a halving step). Raises beyond the tolerance."""
    from dvbs_tpu_torch import tables
    from dvbs_tpu_torch.ops import demap
    from dvbs_tpu_torch.spec import modcod
    cfg = modcod.get_config(DEMAP_MODCOD[M])
    p, m0 = tables.demap_tables(cfg.constellation, cfg.g1, cfg.g2)
    rng = np.random.default_rng(3)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    x = p[rng.integers(0, M, n)] + sigma * (rng.normal(size=n) +
                                            1j * rng.normal(size=n))
    syms = torch.from_numpy(x.astype(np.complex64)).to(dev)
    pts, mask0 = torch.from_numpy(p).to(dev), torch.from_numpy(m0).to(dev)
    got = demap.soft_demap_cuda(syms, cfg.constellation, pts, mask0)
    torch.cuda.synchronize()
    share, err, at_step = demap.against_plain(got, syms, cfg.constellation,
                                              pts, mask0)
    if not share <= 1:
        raise AssertionError(f"soft demapper [{n}, {M}]: an LLR at {share:.3g}"
                             f" of its tolerance from the plain version's")
    COMPARED["soft_demap"].add((n, M))
    return syms, cfg.constellation, pts, mask0, err, share, at_step


def phase_demap(torch, dev):
    """The soft demapper against its plain version at the banks' shapes
    (DEMAP_SHAPES), each timed eagerly and by CUDA-graph replay against
    its bound, beside the plain version's time. The kernels row reports
    the first shape (the 32APSK bank's)."""
    from dvbs_tpu_torch.kernels import probe_resample as pr
    from dvbs_tpu_torch.ops import demap
    row = None
    for n, M, snr_db, label in DEMAP_SHAPES:
        syms, kind, pts, mask0, err, share, at_step = demap_case(
            torch, dev, n, M, snr_db)
        ms = cuda_ms(lambda: demap.soft_demap_cuda(syms, kind, pts, mask0),
                     20, batches=3)
        g_ms = pr.graph_ms(lambda: demap.soft_demap_cuda(syms, kind, pts,
                                                         mask0))
        plain_ms = cuda_ms(lambda: demap.soft_demap_plain(syms, kind, pts,
                                                          mask0), 3)
        m = M.bit_length() - 1
        # bytes: the symbols in, the LLRs out. Operations: as the benchmark
        # counts the algorithm's (rxbench/work/demap.py), an exp or a log
        # one operation: 6 M for the distances, 4 M + 2 a bit
        nbytes = n * 8 + n * m * 4
        b = bound(nbytes, n * (6 * M + m * (4 * M + 2)), F32_OPS)
        print(f"soft demapper [{n}, {M}] ({label}): max abs err {err:.3g} "
              f"({share:.3g} of the tolerance; {at_step} LLRs at a halving "
              f"step); kernel {ms:.4f} ms eager, graph-replayed "
              f"{g_ms:.4f} ms = {b['bound_ms'] / g_ms:.3f} of its bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); plain "
              f"{plain_ms:.3f} ms")
        if row is None:
            row = dict(name="soft_demap", route="cuda",
                       source="dvbs_tpu_torch/csrc/soft_demap.cu",
                       replaces="none: dvbs_tpu/ops/demap.py is plain jnp",
                       max_abs_err=err, ms=ms, graph_ms=g_ms,
                       plain_ms=plain_ms, library_ms=None, **b)
    return row


def viterbi_case(torch, label: str, xt) -> tuple:
    """Kernel C on llrs xt [B, T, 2] against its plain version, bit for
    bit: (bits, largest difference, 0); raises where a bit differs."""
    from dvbs_tpu_torch.ops import viterbi_kernel as vk
    got = vk.decode_cuda(xt)
    ref = vk.decode_plain(xt)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(
            f"kernel C {label}: {int((got != ref).sum())} bits differ from "
            f"the plain version")
    COMPARED["viterbi_acs"].add(tuple(xt.shape[:2]))
    return got, int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())


def dvbs_bank_segments(C: int, block_samples: int) -> int:
    """Kernel C's segments a step of the DVB-S stream bank decodes: C
    carriers of rate 1/2 at block_samples, 512-pair cores."""
    from dvbs_tpu_torch.parallel.dvbs_bank import stream_bank_geometry
    win = stream_bank_geometry("1/2", block_samples)["win_soft"]
    return C * -(-(win // 2) // 512)


def phase_viterbi(torch, dev):
    """Kernel C against its plain version, bit-exact on every output bit
    (wings included), on three inputs."""
    from dvbs_tpu_torch.spec import dvbs_fec
    from dvbs_tpu_torch.ops import viterbi_kernel as vk
    rng = np.random.default_rng(3)
    wide_b = dvbs_bank_segments(len(WIDE_DVBS), 2 * WIDE_DVBS_BLOCK)
    watch_b = dvbs_bank_segments(2, WATCH_BLOCK)
    B, T, wing = 4096, 704, 96           # the DVB-S bank's segments
    truth = rng.integers(0, 2, (B, T))
    bp = np.concatenate([np.zeros((B, 6), np.int64), truth], axis=1)
    xy = np.stack([sum(bp[:, j:j + T] for j in range(7) if (g >> j) & 1) % 2
                   for g in (dvbs_fec.G1, dvbs_fec.G2)], axis=2)
    bank = (1.0 - 2.0 * xy) * 2.0 + rng.normal(0, 0.8, (B, T, 2))
    bank[:, ::3, 1] = 0.0                # depuncture-style erasures
    ragged = rng.normal(0, 1.5, (130, 151, 2))
    ragged[:, ::3, 1] = 0.0
    more = np.concatenate([bank, bank[:1]])       # a ragged last CTA
    long = rng.normal(0, 1.5, (8, 2240, 2))
    long[:, ::3, 1] = 0.0
    longer = rng.normal(0, 1.5, (3, 4000, 2))
    longer[:, ::3, 1] = 0.0
    # the single-carrier receiver's blocks at 2^17 symbols: B segments of
    # 2048 + 2 x 96 pairs, 64 at rate 1/2 and 112 at rate 7/8
    receiver = rng.normal(0, 1.5, (112, 2240, 2))
    receiver[:, ::3, 1] = 0.0
    cases = (("noisy codewords [4096, 704, 2], every third Y erased", bank),
             ("[4097, 704, 2]", more),
             ("ragged [130, 151, 2]", ragged),
             ("the single-carrier segments [8, 2240, 2]", long),
             ("the receiver's rate-1/2 block [64, 2240, 2]", receiver[:64]),
             ("the receiver's rate-7/8 block [112, 2240, 2]", receiver),
             ("the first-block bank's step [1024, 704, 2]", bank[:1024]),
             (f"the wideband CLI's DVB-S bank [{wide_b}, 704, 2]",
              bank[:wide_b]),
             (f"the watchdog's DVB-S bank [{watch_b}, 704, 2]",
              bank[:watch_b]),
             ("one segment a CTA [3, 4000, 2]", longer),
             ("all-erasure [1, 704, 2]", np.zeros((1, T, 2)))) + tuple(
                 (f"[130, {t}, 2]", ragged[:, :t]) for t in range(1, 6))
    err = 0
    for label, x in cases:
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        got, e = viterbi_case(torch, label, xt)
        err = max(err, e)
        if x.shape[:2] not in ((64, 2240), (112, 2240), (1024, 704),
                               (wide_b, T), (watch_b, T)):
            print(f"kernel C {label}: bit-exact on all {got.numel()} bits; "
                  f"kernel {cuda_ms(lambda: vk.decode_cuda(xt), 5):.3f} ms")
            continue
        # the main paths' shapes below the bank's: a single partial wave
        # (CTAs of four segments: 16-28 on 132 SMs at T = 2240, 256 of the
        # 528 that fit at once at T = 704), so the time is the serial
        # chain's, ceil(T / 3) dependent ACS steps, against the bound of
        # its operations
        nseg, nsteps = x.shape[0], -(-x.shape[1] // vk.K)
        ms = cuda_ms(lambda: vk.decode_cuda(xt), 20, batches=3)
        plain_ms = cuda_ms(lambda: vk.decode_plain(xt), 2)
        b = bound(xt.numel() * 4 + got.numel(),
                  got.numel() * VITERBI_OPS_PER_STEP, F32_ADD_OPS)
        print(f"kernel C {label}: bit-exact on all {got.numel()} bits; "
              f"kernel {ms:.4f} ms (least of 3 batches of 20), plain "
              f"{plain_ms:.1f} ms; {-(-nseg // vk.CTA_SEGMENTS)} CTAs; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); a chain of "
              f"{nsteps} ACS steps: {ms * 1e6 / nsteps:.0f} ns a step with "
              f"the traceback")
    big = torch.from_numpy(bank.astype(np.float32)).to(dev)
    core = vk.decode_cuda(big)[:, wing:T - wing].cpu().numpy()
    n_bad = int((core != truth[:, wing:T - wing]).sum())
    if n_bad:
        raise AssertionError(f"kernel C: {n_bad} core bits differ from the "
                             f"bits sent")
    ms = cuda_ms(lambda: vk.decode_cuda(big), 20, batches=3)
    plain_ms = cuda_ms(lambda: vk.decode_plain(big), 2)
    print(f"kernel C [{B}, {T}, 2]: cores equal the bits sent; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
    nbytes = big.numel() * 4 + B * T
    ops = B * T * VITERBI_OPS_PER_STEP
    row = dict(name="viterbi_acs", route="cuda",
               source="dvbs_tpu_torch/csrc/viterbi_acs.cu",
               replaces="dvbs_tpu/ops/viterbi_pallas.py:247",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(nbytes, ops, F32_ADD_OPS))
    print(f"kernel C bound: {nbytes} bytes -> {nbytes / HBM_BPS * 1e3:.4f} "
          f"ms; {B} x {T} steps x {VITERBI_OPS_PER_STEP:.0f} adds, compares "
          f"and selects = {ops:.3g} at {F32_ADD_OPS:.3g} a second -> "
          f"{ops / F32_ADD_OPS * 1e3:.4f} ms ({row['bound_by']})")
    return row


def phase_probe(torch, dev):
    """Every probe stage against its plain version at the TPU probes'
    shape (C=2, 4 chunks of 8 tiles) and at the bank's ([8, 2160, 256];
    split at [8, 552960]), max abs error 0; then the probe's entry
    point with the counts set to 0 just before. The kernels row reports
    the `full` stage at the bank's shape."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.kernels import probe_resample as pr
    rows = pr.run_all(dev)
    worst = 0.0
    for r in rows:
        if r["max_abs_err"] != 0:
            raise AssertionError(f"probe stage {r['stage']} {r['shape']}: max "
                                 f"abs error {r['max_abs_err']} against its "
                                 f"plain version")
        worst = max(worst, r["max_abs_err"])
    print(f"probe: {len(rows)} stage runs ({', '.join(pr.ALL_STAGES)}) "
          f"equal to their plain versions (max abs err 0)")
    backend.reset_launches()
    assert pr.main() == 0
    launches = dict(backend.LAUNCHES)
    assert launches["resample_probe"] > 0
    full = [r for r in rows if r["stage"] == "full"][-1]
    C, ntp, TS = full["shape"]
    # bytes: two planes of ntp + 4 rows, u and out of ntp rows, rb.
    # Operations: 9 multiply-adds of the polynomial + 10 taps' per value
    nbytes = C * TS * 4 * (2 * (ntp + pr.EXTRA) + 2 * ntp) + C * ntp * 4
    row = dict(name="resample_probe", route="cuda",
               source="dvbs_tpu_torch/csrc/resample_probe.cu",
               replaces="tools/bisect_resample_kernel.py:102",
               max_abs_err=worst, ms=full["device_ms"],
               plain_ms=full["plain_ms"],
               library_ms=None,
               **bound(nbytes, C * ntp * TS * (18 + 20), F32_OPS))
    return row, launches


def stream_bank(torch, st, sigs, sents, blocks: int, label: str,
                kernels=("ldpc_layered", "resample_farrow", "soft_demap"),
                keep: list | None = None) -> dict:
    """Feed a DVBS2BankStream `blocks` blocks after the first, plus flush,
    with the counts set to 0 just before; every frame must decode, every
    carrier's TS must be one byte-exact contiguous run of its own
    packets, and each of `kernels` must have been launched. Returns the
    launch counts of the run; the TS of each carrier goes to `keep`."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.tx import signals
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
        npk = signals.contiguous_packets(bytes(outs[c]), sents[c],
                                       f"{label} c{c}")
        assert npk >= want, f"c{c}: {npk} packets < {want}"
    print(f"{label} TS: every carrier one byte-exact contiguous run "
          f"(>= {want} packets each)")
    for name in kernels:
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the {label}"
    if keep is not None:
        keep.extend(bytes(o) for o in outs)
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
    ts = []
    launches = stream_bank(torch, st, sigs, sents, E2E_BLOCKS, "main path",
                           keep=ts)
    # device-resident step: min and mean over 3 batches of 10 reps
    n = 2 * st.block_symbols
    dev_in = torch.from_numpy(np.stack([s[:n] for s in sigs])).to(dev)
    out = st.step_fn(dev_in)
    assert bool(out["ldpc_ok"].all()) and not bool(out["bch_bad"].any())
    time_step(torch, st.step_fn, dev_in, "bank step",
              f"{N_CARRIERS * st.F} frames", smi)
    return launches, lambda: st.step_fn(dev_in), st.program, ts


def phase_dvbs(torch, dev, smi, sigs, sents):
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.parallel.dvbs_bank import DVBSBankStream
    from dvbs_tpu_torch.tx import signals
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
    npk = [signals.contiguous_packets(bytes(outs[c]), sents[c], f"dvbs c{c}")
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
    """One step of the pilots bank at MODCOD mc:
    every frame decodes, no BCH flag, every carrier's TS one byte-exact
    contiguous run, kernels A and B launched; then the step is timed."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.io.native import NativeTSParser
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.tx import signals
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
    npk = [signals.contiguous_packets(NativeTSParser(cfg.kbch).feed(kbb[c]),
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


def graph_range_ops(tr) -> dict:
    """range -> (device operations launched inside its spans, their
    device ms), a step each, for the GRAPH_RANGES of trace `tr`
    (rxbench/trace.Trace) of GRAPH_TRACED steps: the benchmark's rule."""
    out = {}
    for name in GRAPH_RANGES:
        spans = tr.spans.get(name, ())
        n = sum(1 for t in tr.launch
                if t is not None and any(a <= t < b for a, b in spans))
        out[name] = (n / GRAPH_TRACED,
                     (tr.range_s(name) or 0.0) * 1e3 / GRAPH_TRACED)
    return out


def phase_graphs(torch, dev, smi, sigs):
    """The 32APSK 3/4 pilots bank's step as CUDA graphs (graphs.py):
    consecutive blocks through the bank (eager, captured, replayed)
    equal to the eager enqueue bit for bit; the host ms of a step eager
    and replayed, and the device ms; then GRAPH_TRACED steps of each
    under profiling.device_trace, read by rxbench/trace.Trace: every
    range the benchmark reads owns device operations of the replayed
    segments, as many as eagerly (`bank.step` also the input's copy and
    the outputs' clones)."""
    from rxbench.trace import Trace
    from dvbs_tpu_torch import profiling
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.parallel.mesh import (bank_block_symbols,
                                              build_carrier_bank)
    mc = GRAPH_MC
    L2 = 2 * modcod.get_config(mc, pilots=True).plframe_len
    block = bank_block_symbols(N_CARRIERS, mc=mc, pilots=True)
    n = 2 * block
    assert len(sigs[0]) >= n + 2 * L2, (len(sigs[0]), n + 2 * L2)
    xs = [torch.from_numpy(np.stack([s[k * L2:k * L2 + n] for s in sigs])
                           ).to(dev) for k in range(3)]
    bank, _, _ = build_carrier_bank(N_CARRIERS, mc=mc, pilots=True,
                                    block_symbols=block, fec="int8",
                                    ingest="cs4", stream_outputs=True,
                                    device=dev)
    with torch.no_grad():
        ref = [bank.enqueue(x) for x in xs]
        got = [bank(xs[0])]                          # eager
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        got.append(bank(xs[1]))                      # captured
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        mem1 = torch.cuda.memory_reserved()
        got += [bank(xs[2]), bank(xs[0])]            # replayed
    assert bank.counts == dict(graph_captures=1, graph_replays=3,
                               eager_steps=1), bank.counts
    assert bool(ref[0]["ldpc_ok"].all()), "the 32APSK bank must decode"
    for k, (g, r) in enumerate(zip(got, ref + ref[:1])):
        for name in r:
            assert torch.equal(g[name], r[name]), f"step {k}: {name}"
    print(f"graphs: the 32APSK bank's step captured in "
          f"{bank._graph.segments} segments in {capture_s:.3f} s (the call "
          f"and its first replay; reserved memory +"
          f"{(mem1 - mem0) / 2 ** 20:.0f} MiB); eager, captured and "
          f"replayed steps equal to the eager enqueue on every output")

    def host_ms(fn) -> list:
        out = []
        for _ in range(GRAPH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out)

    def eager():
        with profiling.span("bank.step"):
            return bank.enqueue(xs[0])

    def replayed():
        return bank(xs[0])
    with torch.no_grad():
        for label, fn in (("eager", eager), ("replayed", replayed)):
            h = host_ms(fn)
            d = cuda_ms(fn, 10, 3)
            print(f"graphs: {label} step, host ms to enqueue (started on an "
                  f"idle card, {GRAPH_REPS} steps): min {h[0]:.3f} median "
                  f"{h[len(h) // 2]:.3f}; {d:.3f} ms a step by CUDA events "
                  f"(3 batches x 10); card {smi}")
        ops = {}
        with tempfile.TemporaryDirectory() as tmp:
            for label, fn in (("eager", eager), ("replayed", replayed)):
                path = os.path.join(tmp, f"graphs_{label}.json")
                torch.cuda.synchronize()
                with profiling.device_trace(path):
                    for _ in range(GRAPH_TRACED):
                        fn()
                ops[label] = graph_range_ops(Trace(path))
                print(f"graphs: {label}, traced ({GRAPH_TRACED} steps): " +
                      ", ".join(f"{r} {n:g} ops {ms:.4f} ms"
                                for r, (n, ms) in ops[label].items()))
    for r in GRAPH_RANGES:
        n_eager, n_rep = ops["eager"][r][0], ops["replayed"][r][0]
        assert n_rep > 0, f"range {r} owns no device operation replayed"
        if r != "bank.step":
            assert n_rep == n_eager, (r, n_eager, n_rep)
    extra = ops["replayed"]["bank.step"][0] - ops["eager"]["bank.step"][0]
    assert extra == 1 + len(ref[0]), extra      # the copy in, the clones
    print("graphs: every range the benchmark reads owns the replayed "
          "segments' operations, as many as eagerly")


def phase_pilots_stream(torch, dev, sigs, sents):
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    st = DVBS2BankStream(N_CARRIERS, mc=STREAM_MC, short=False, pilots=True,
                         fec="int8", ingest="cs4", device=dev)
    return stream_bank(torch, st, sigs, sents, STREAM_BLOCKS,
                       "8PSK 3/4 pilots stream")


def measure_block(torch, rx, blk, label: str, count_kernels: bool) -> None:
    """One block through a single-carrier receiver on the card: ms per
    block (dispatch + finalize, min of 3), launches of kernels A and B,
    and the time inside plphase.dd_phase_track (synchronised before and
    after). With count_kernels, a torch.profiler pass adds the CUDA
    kernels per block and their device time."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.ops import plphase
    rx.process_symbols_block(blk)                     # warm up
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        res = rx.process_symbols_block(blk)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ours = dict(backend.LAUNCHES)
    orig, dd = plphase.dd_phase_track, [0.0]

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        dd[0] += (time.perf_counter() - t0) * 1e3
        return out
    plphase.dd_phase_track = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx.process_symbols_block(blk)
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3
    finally:
        plphase.dd_phase_track = orig
    counted = ""
    if count_kernels:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rx.process_symbols_block(blk)
            torch.cuda.synchronize()
        # device events that are kernels or copies, not the layers' ranges
        evs = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation]
        dev_ms = sum(e.device_time for e in evs) / 1e3
        counted = (f"{len(evs)} CUDA kernels a block ({dev_ms:.3f} ms of "
                   f"device time, idle share "
                   f"{max(0.0, 1 - dev_ms / min(ms)):.3f}); ")
    print(f"{label} block [{len(blk)} samples, {rx.n_frames} frames, fec "
          f"{rx.fec}]: min {min(ms):.3f} ms, mean {sum(ms) / 3:.3f} ms per "
          f"block; {counted}launches per block: kernel A "
          f"{ours['ldpc_layered']}, kernel B {ours['resample_farrow']}; "
          f"dd_phase_track {dd[0]:.3f} ms of {whole:.3f} ms = share "
          f"{dd[0] / whole:.3f}; trials {res.ldpc_trials.tolist()}")


def slice_gate(cfg, ts: bytes, sent, ok: int, seen: int, label: str):
    """The slice's gates on one run's output."""
    from dvbs_tpu_torch.tx import signals
    F = slice_frames(cfg)
    per = (cfg.kbch - 80) // 8 // 188
    npk = signals.contiguous_packets(ts, sent, label)
    assert seen >= SLICE_BLOCKS * F, f"{label}: only {seen} frames seen"
    assert ok >= seen - F, f"{label}: frames lost: {ok} of {seen}"
    assert npk >= (seen - F - 2) * per, f"{label}: {npk} packets"
    print(f"{label}: frames ok {ok}/{seen}; TS one byte-exact contiguous "
          f"run of {npk} packets")


def cli_stderr(args: list) -> str:
    """The port's CLI in-process on the card; returns its standard
    error, which holds its progress lines."""
    from dvbs_tpu_torch import cli
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(args)
    except SystemExit as e:          # argparse's error exit
        raise AssertionError(err.getvalue()[-2000:]) from e
    assert rc == 0, err.getvalue()[-2000:]
    return err.getvalue()


def run_cli(args: list) -> tuple:
    """The port's CLI in-process; returns (frames ok, frames seen) from
    its last progress line."""
    err = cli_stderr(args)
    m = re.findall(r" ok=(\d+)/(\d+)", err)
    assert m, err[-2000:]
    return int(m[-1][0]), int(m[-1][1])


def phase_slice(torch, sigs, trace=None) -> list:
    """The single-carrier DVB-S2 slice (phase 10 of the module
    docstring). Returns the launch counts of every run. With `trace`, a
    per-layer profile of one block of each configuration follows its
    timing (traces to <trace>_<name>.json)."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.io import source
    from dvbs_tpu_torch.models.driver import DVBS2Stream
    from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver
    from dvbs_tpu_torch.spec import modcod
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        def cli_run(name, label, extra, y=None, out="out.ts"):
            mc, pilots, _, _ = SLICE[name]
            y = sigs[name][0] if y is None else y
            iq = os.path.join(tmp, f"{label}.cf32")
            source.write_iq_file(iq, y)
            args = ["--iq", iq, "--mode", "s2", "--modcod", str(mc),
                    "--framesize", "normal", "--out", os.path.join(tmp, out)]
            backend.reset_launches()
            t0 = time.perf_counter()
            ok, seen = run_cli(args + (["--pilots"] if pilots else []) + extra)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(backend.LAUNCHES)
            runs.append(launches)
            F = slice_frames(modcod.get_config(mc, short=False, pilots=pilots))
            blocks = seen // F
            print(f"cli {label} ({' '.join(extra)}): {len(y)} samples, "
                  f"{blocks} blocks in {dt:.2f} s = {dt / blocks * 1e3:.1f} "
                  f"ms a block, reading and writing the files included; "
                  f"launches {launches} = kernel A "
                  f"{launches['ldpc_layered'] / blocks:.1f}, kernel B "
                  f"{launches['resample_farrow'] / blocks:.1f} a block")
            with open(os.path.join(tmp, out), "rb") as f:
                return f.read(), ok, seen, launches

        for name, (mc, pilots, snr, dummy) in SLICE.items():
            cfg = modcod.get_config(mc, short=False, pilots=pilots)
            y, sent = sigs[name]
            label = f"slice {name} ({snr} dB)"
            if dummy is None:
                ts, ok, seen, launches = cli_run(name, name,
                                                 ["--fec", "pallas"])
                slice_gate(cfg, ts, sent, ok, seen, label)
            else:
                st = DVBS2Stream(mc=mc, short=False, pilots=pilots,
                                 block_symbols=SLICE_BLOCK, fec="pallas",
                                 dummy_aware=True)
                out = bytearray()
                backend.reset_launches()
                for lo in range(0, len(y), 4 * SLICE_BLOCK):
                    out.extend(st.feed(y[lo:lo + 4 * SLICE_BLOCK]))
                torch.cuda.synchronize()
                launches = dict(backend.LAUNCHES)
                runs.append(launches)
                from dvbs_tpu_torch.tx import signals
                npk = signals.contiguous_packets(bytes(out), sent, label)
                m = st.metrics
                # one dummy after every `dummy` data frames: the slots
                # that are not ok are the dummies, skipped without a gap
                per = (cfg.kbch - 80) // 8 // 188
                assert st.stats.blocks >= SLICE_BLOCKS - 1, st.stats.blocks
                assert npk >= (m.frames_ok - 2) * per, (npk, m.frames_ok)
                assert m.frames_ok >= 0.7 * m.frames_seen, \
                    (m.frames_ok, m.frames_seen)
                print(f"{label}, DVBS2Stream(dummy_aware=True): "
                      f"{st.stats.blocks} blocks, slots ok {m.frames_ok}/"
                      f"{m.frames_seen} (the rest dummy PLFRAMEs, skipped "
                      f"without a gap); TS one byte-exact contiguous run of "
                      f"{npk} packets; launches {launches}")
            for k in ("ldpc_layered", "resample_farrow"):
                assert launches[k] > 0, f"{label}: kernel {k} not launched"
            rx = DVBS2Receiver(mc=mc, short=False, pilots=pilots,
                               block_symbols=SLICE_BLOCK, fec="pallas",
                               dummy_aware=dummy is not None)
            measure_block(torch, rx, y[:2 * SLICE_BLOCK], label, bool(trace))
            if trace:
                blk = y[:2 * SLICE_BLOCK]
                phase_profile(torch, lambda: rx.process_symbols_block(blk),
                              f"{trace}_{name}.json", LAYERS_SLICE, label,
                              reps=2)

        # the float decoder (the CLI's default) on the QPSK 1/2 signal
        cfg = modcod.get_config(4, short=False)
        y, sent = sigs["qpsk12"]
        ts, ok, seen, launches = cli_run("qpsk12", "qpsk12_xla",
                                         ["--fec", "xla"])
        slice_gate(cfg, ts, sent, ok, seen, "slice qpsk12 --fec xla")
        assert launches["resample_farrow"] > 0 and \
            launches["ldpc_layered"] == 0, launches
        rx = DVBS2Receiver(mc=4, short=False, block_symbols=SLICE_BLOCK,
                           fec="xla")
        measure_block(torch, rx, y[:2 * SLICE_BLOCK], "slice qpsk12 --fec xla",
                      bool(trace))

        # two runs joined by a state file
        state = os.path.join(tmp, "rx.state")
        half = (len(y) // 2) // (4 * SLICE_BLOCK) * (4 * SLICE_BLOCK)
        extra = ["--fec", "pallas", "--state-file", state]
        ts_a, _, _, _ = cli_run("qpsk12", "qpsk12_a", extra, y[:half], "a.ts")
        assert os.path.exists(state)
        ts_b, ok, seen, _ = cli_run("qpsk12", "qpsk12_b", extra, y[half:],
                                    "b.ts")
        from dvbs_tpu_torch.tx import signals
        npk = signals.contiguous_packets(ts_a + ts_b, sent, "state-file")
        per = (cfg.kbch - 80) // 8 // 188
        assert len(ts_a) > 0 and len(ts_b) > 0
        assert npk >= (SLICE_BLOCKS - 1) * slice_frames(cfg) * per, npk
        print(f"slice qpsk12 state-file resume: {len(ts_a) // 188} + "
              f"{len(ts_b) // 188} packets, joined one byte-exact "
              f"contiguous run of {npk}")
    return runs


@contextlib.contextmanager
def made_streams(cls):
    """Yields a list that collects every instance of cls made inside."""
    made, init = [], cls.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    cls.__init__ = spy
    try:
        yield made
    finally:
        cls.__init__ = init


def measure_dvbs_block(torch, y, label: str, trace=None) -> None:
    """Locked blocks of the single-carrier DVB-S receiver on the card:
    the lock block and the locked chain's first block, then ms per block
    (min and mean of 3 successive blocks, process_block ending in a
    synchronise, the host tail included), launches per block, and from a
    torch.profiler pass over one more block its CUDA kernels, their
    device time and kernel C's share."""
    from torch.profiler import ProfilerActivity, profile
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.models.dvbs import DVBSReceiver
    rx = DVBSReceiver(block_symbols=SLICE_BLOCK)
    n, pos = 2 * SLICE_BLOCK, [0]

    def block():
        rx.process_block(y[pos[0]:pos[0] + n])
        pos[0] += rx.last_consumed
    block()
    block()
    assert rx.locked and rx.drop == 0, label
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        block()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    ours = dict(backend.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if str(e.device_type).endswith("CUDA")
           and not e.is_user_annotation]
    dev_ms = sum(e.device_time for e in evs) / 1e3
    vit_ms = sum(e.device_time for e in evs if "viterbi" in e.name) / 1e3
    vit_share = vit_ms / dev_ms if dev_ms else float("nan")
    assert rx.locked and rx.ber < 0.05, (label, rx.ber)
    segs = sorted({c.B for c in rx._locked_cache.values()})
    print(f"{label} block [{n} samples, {segs} segments of 2240 pairs]: "
          f"min {min(ms):.3f} ms, mean {sum(ms) / 3:.3f} ms per block (real "
          f"time at 30 Mbaud: {SLICE_BLOCK / 30e3:.2f} ms); {len(evs)} CUDA "
          f"kernels a block, {dev_ms:.3f} ms of device time (idle share "
          f"{max(0.0, 1 - dev_ms / min(ms)):.3f}); kernel C {vit_ms:.4f} ms "
          f"= {vit_ms / min(ms):.4f} of the block, {vit_share:.3f} of "
          f"its device time; launches per block: kernel B "
          f"{ours['resample_farrow']}, kernel C {ours['viterbi_acs']}")
    if trace:
        blk = y[pos[0]:pos[0] + n]
        phase_profile(torch, lambda: rx.process_block(blk), trace,
                      LAYERS_DVBS, label, reps=2)


def phase_dvbs_single(torch, sigs, trace=None) -> list:
    """The single-carrier DVB-S receiver (phase 11 of the module
    docstring). Returns the launch counts of every run."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.io import source
    from dvbs_tpu_torch.models.dvbs import DVBSStream
    from dvbs_tpu_torch.spec import dvbs_fec
    from dvbs_tpu_torch.tx import signals
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        def cli_run(label, y, extra=()):
            iq = os.path.join(tmp, f"{label}.cf32")
            out = os.path.join(tmp, f"{label}.ts")
            source.write_iq_file(iq, y)
            backend.reset_launches()
            t0 = time.perf_counter()
            with made_streams(DVBSStream) as made:
                run_cli(["--iq", iq, "--mode", "s", "--block-symbols",
                         str(SLICE_BLOCK), "--out", out] + list(extra))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(backend.LAUNCHES)
            runs.append(launches)
            with open(out, "rb") as f:
                return f.read(), made[0], launches, dt

        whole = {}
        for rate, snr in DVBS_SINGLE.items():
            key = dvbs_key(rate)
            y, sent = sigs[key]
            label = f"DVB-S {rate} ({snr} dB)"
            ts, st, launches, dt = cli_run(key, y)
            bers = list(st._ber_ring)
            blocks = len(bers)
            px, py = dvbs_fec.PUNCTURE[rate]
            per = SLICE_BLOCK * 2 * len(px) / int(px.sum() + py.sum()) \
                / 8 / 204
            npk = signals.contiguous_packets(ts, sent, label)
            print(f"cli {label}: {len(y)} samples, {blocks} blocks in "
                  f"{dt:.2f} s = {dt / blocks * 1e3:.1f} ms a block, reading "
                  f"and writing the files included; rate found "
                  f"{st.metrics.viterbi_rate}; re-encode BER per block "
                  f"{[round(b, 4) for b in bers]}; TS one byte-exact "
                  f"contiguous run of {npk} packets; launches {launches}")
            assert st.metrics.viterbi_rate == rate == st.rx.rate, label
            assert st.rx.locked and max(bers) < 0.05, (label, bers)
            assert blocks >= SLICE_BLOCKS, (label, blocks)
            assert npk >= (blocks - 2) * per, (label, npk, per)
            assert launches["viterbi_acs"] >= blocks - 1, (label, launches)
            assert launches["resample_farrow"] >= blocks, (label, launches)
            whole[rate] = ts
            measure_dvbs_block(torch, y, label,
                               trace and f"{trace}_{key}.json")

        # two runs joined by a state file
        y, sent = sigs[dvbs_key("1/2")]
        half = (len(y) // 2) // (4 * SLICE_BLOCK) * (4 * SLICE_BLOCK)
        state = os.path.join(tmp, "rx.state")
        ts_a = cli_run("dvbs12_a", y[:half], ["--state-file", state])[0]
        assert os.path.exists(state)
        ts_b = cli_run("dvbs12_b", y[half:], ["--state-file", state])[0]
        assert len(ts_a) > 0 and len(ts_b) > 0
        assert ts_a + ts_b == whole["1/2"], "state-file resume differs"
        print(f"DVB-S 1/2 state-file resume: {len(ts_a) // 188} + "
              f"{len(ts_b) // 188} packets, equal to the uninterrupted run")
    return runs


def phase_first_bank(torch, dev, smi, sigs, sents):
    """The first-block DVB-S bank (phase 12 of the module docstring)."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.models.dvbs import DVBSReceiver
    from dvbs_tpu_torch.parallel.dvbs_bank import build_dvbs_bank
    from dvbs_tpu_torch.tx import signals
    n = FIRST_BANK_BLOCK
    dev_in = torch.from_numpy(np.stack([s[:n] for s in sigs])).to(dev)
    step, example = build_dvbs_bank(N_CARRIERS, rate="1/2", block_samples=n,
                                    ingest="cs4", device=dev)
    assert tuple(dev_in.shape) == example.shape
    backend.reset_launches()
    out = step(dev_in)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    ber = out["ber"].cpu().numpy()
    bits = np.unpackbits(out["bits"].cpu().numpy(), axis=1)[:, :out["n_pairs"]]
    npk = []
    for c in range(N_CARRIERS):
        rx = DVBSReceiver(rate="1/2", block_symbols=n // 2, device=dev)
        ts = rx._host_tail(np.ascontiguousarray(bits[c]), None, n // 2)
        npk.append(signals.contiguous_packets(ts.ts_packets.tobytes(),
                                              sents[c], f"first bank c{c}"))
    print(f"first-block DVB-S bank: {N_CARRIERS} carriers x {n} cs4 samples, "
          f"{out['n_pairs']} pairs each; re-encode BER {ber.tolist()}; TS "
          f"one byte-exact contiguous run per carrier ({min(npk)}..{max(npk)}"
          f" packets); launches {launches}")
    assert (ber < 0.02).all(), ber
    assert min(npk) >= 8, npk
    for name in ("viterbi_acs", "resample_farrow"):
        assert launches[name] > 0, \
            f"kernel {name} was not launched on the first-block bank"
    B = -(-out["n_pairs"] // 512)
    time_step(torch, step, dev_in, "first-block DVB-S bank step",
              f"{N_CARRIERS * B} Viterbi segments of 704 pairs", smi)
    return launches


def phase_equalizer(torch, sigs) -> list:
    """DVBS2Receiver(equalize=True) on the card (phase 13 of the module
    docstring). Returns the launch counts of each block's run."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver
    from dvbs_tpu_torch.ops import equalizer
    runs = []
    orig = equalizer.lms_equalize
    for name, (short, block, _) in EQ.items():
        blk = sigs[name][0][:2 * block]
        kw = dict(mc=4, short=short, block_symbols=block, fec="pallas")
        rx = DVBS2Receiver(equalize=True, **kw)
        seen = []

        def spy(z):
            out = orig(z)
            seen.append((z, out))
            return out
        equalizer.lms_equalize = spy
        try:
            backend.reset_launches()
            res = rx.process_symbols_block(blk)
            torch.cuda.synchronize()
        finally:
            equalizer.lms_equalize = orig
        launches = dict(backend.LAUNCHES)
        runs.append(launches)
        assert len(seen) == 1, len(seen)
        z, got = seen[0]
        err = float((got.cpu() - orig(z.cpu())).abs().max())
        eq_ms = cuda_ms(lambda: orig(z), 10, batches=3)
        label = f"equalizer {name} ({'short' if short else 'normal'} " \
            f"frames, {block} symbols)"
        print(f"{label}: frame_ok {res.frame_ok.tolist()}, trials "
              f"{res.ldpc_trials.tolist()}; equalized symbols {tuple(z.shape)} "
              f"against lms_equalize on the CPU: max abs err {err:.3g} (tol "
              f"{EQ_TOL}); lms_equalize alone {eq_ms:.3f} ms (CUDA events, "
              f"least of 3 batches of 10); launches {launches}")
        assert res.frame_ok.all(), f"{label}: frames lost {res.frame_ok}"
        assert err <= EQ_TOL, f"{label}: {err} > {EQ_TOL}"
        assert launches["resample_farrow"] > 0, label
        measure_block(torch, rx, blk, f"{label} on", True)
        measure_block(torch, DVBS2Receiver(**kw), blk, f"{label} off", True)
    return runs


def step_ms(torch, fn) -> tuple:
    """(min, mean) ms of fn() over 3 batches of 2 calls, CUDA events."""
    batches = [cuda_ms(fn, 2) for _ in range(3)]
    return min(batches), sum(batches) / len(batches)


def phase_sharded(torch, dev, smi, sigs) -> list:
    """The sharded builds at world size 1 over NCCL (phase 14 of the
    module docstring). Returns the launch counts of each run."""
    from dvbs_tpu_torch import backend, entry
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    from dvbs_tpu_torch.models.dvbs2 import DVBS2Receiver, run_fec
    from dvbs_tpu_torch.parallel import collectives
    from dvbs_tpu_torch.parallel.mesh import (build_carrier_bank,
                                              build_carrier_bank_sharded,
                                              build_multi_carrier)
    from dvbs_tpu_torch.parallel.timeshard import build_time_sharded
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        collectives.init_mesh(1, 0, dev, os.path.join(tmp, "store"))
        try:
            # the multi-carrier step: 8 distinct carriers on one rank
            samples = entry.multi_carrier_signals(N_CARRIERS, 2 * entry.BLOCK)
            step, example, mesh = build_multi_carrier(
                1, carriers_per_device=N_CARRIERS)
            assert example.shape == samples.shape
            backend.reset_launches()
            with torch.no_grad():
                out = step(samples)
            torch.cuda.synchronize()
            launches = dict(backend.LAUNCHES)
            runs.append(launches)
            ok = out["ldpc_ok"].cpu().numpy()
            locked = int(out["locked"][0])
            ms = step_ms(torch, lambda: step(samples))
            print(f"build_multi_carrier(1, 8) over NCCL, mesh {mesh.shape} "
                  f"on {mesh.device}: ldpc_ok {int(ok.sum())}/{ok.size}, "
                  f"locked {locked}; step from the host {ms[0]:.3f} ms min, "
                  f"{ms[1]:.3f} mean; launches {launches}")
            assert ok.all() and locked == ok.size, (ok, locked)
            assert launches["resample_farrow"] > 0

            # the main path's bank, sharded, streamed
            cs4, sents = sigs["s2"]
            program = build_carrier_bank_sharded(
                1, carriers_per_device=N_CARRIERS, mc=MC, short=SHORT,
                ingest="cs4")
            st = DVBS2BankStream(N_CARRIERS, mc=MC, short=SHORT,
                                 ingest="cs4", program=program, device=dev)
            runs.append(stream_bank(torch, st, cs4, sents, E2E_BLOCKS,
                                    "sharded bank stream",
                                    kernels=("resample_farrow",
                                             "soft_demap")))
            n = 2 * st.block_symbols
            host_in = torch.from_numpy(np.stack([s[:n] for s in cs4]))
            dev_in = host_in.to(dev)
            sharded = program[0]
            bank, _ = build_carrier_bank(N_CARRIERS, mc=MC, short=SHORT,
                                         block_symbols=st.block_symbols,
                                         fec="xla", ingest="cs4",
                                         device=dev)
            with torch.no_grad():
                a, b = bank(dev_in), sharded(dev_in)     # a: eager
                for k in a:
                    assert torch.equal(a[k], b[k]), f"sharded bank: {k}"
                # the capture, outside the timed turns
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                c = bank(dev_in)
                torch.cuda.synchronize()
                capture_s = time.perf_counter() - t0
                assert bank.counts["graph_captures"] == 1, bank.counts
                for k in a:
                    assert torch.equal(a[k], c[k]), f"replayed bank: {k}"
                local = sharded.bank(dev_in)
                local.pop("llrs")               # the step keeps them local
                # in turns, the order reversed every other turn, so that a
                # drift of the host's speed falls on all; per call also the
                # host's enqueue time and the allocator's cudaMalloc and
                # cudaFree calls
                variants = (("unsharded, replayed", lambda: bank(dev_in)),
                            ("unsharded, eager",
                             lambda: bank.enqueue(dev_in)),
                            ("sharded", lambda: sharded(dev_in)),
                            ("sharded from the host",
                             lambda: sharded(host_in)))
                times = {k: [] for k, _ in variants}
                enq = {k: [] for k, _ in variants}
                mallocs = {k: 0 for k, _ in variants}
                for turn in range(3):
                    for label, fn in variants[::1 - 2 * (turn % 2)]:
                        torch.cuda.synchronize()
                        m0 = torch.cuda.memory_stats()
                        t0 = time.perf_counter()
                        fn()
                        enq[label].append((time.perf_counter() - t0) * 1e3)
                        times[label].append(cuda_ms(fn, 2))
                        m1 = torch.cuda.memory_stats()
                        mallocs[label] += sum(
                            m1.get(k, 0) - m0.get(k, 0)
                            for k in ("num_device_alloc", "num_device_free"))
                gather = cuda_ms(lambda: collectives.gather_dict(local), 10,
                                 batches=3)
            print(f"sharded bank step [{N_CARRIERS} x {n} cs4 samples, "
                  f"{N_CARRIERS * st.F} frames, decode_qc 12 sweeps], 3 "
                  f"turns (order reversed every other turn): " + "; ".join(
                      f"{k}: ms {[round(t, 3) for t in times[k]]} (min "
                      f"{min(times[k]):.3f}), host enqueue ms "
                      f"{[round(t, 1) for t in enq[k]]}, cudaMalloc + "
                      f"cudaFree calls {mallocs[k]}" for k in times)
                  + f"; the unsharded bank's capture (the call and its "
                  f"first replay) {capture_s:.3f} s; the gather of its "
                  f"{len(local)} outputs alone {gather:.4f} ms; outputs "
                  f"equal the unsharded bank's, eager and replayed; "
                  f"card {smi}")

            # the time-sharded step: one rank, its ring the identity
            for short, block, y in (
                    (True, entry.BLOCK, samples[0, 0] + 1j * samples[0, 1]),
                    (False, SLICE_BLOCK, sigs["qpsk12"][0])):
                step, example, mesh, A = build_time_sharded(
                    1, mc=4, short=short, block_symbols=block)
                shard = np.stack([y[:A].real, y[:A].imag]
                                 ).astype(np.float32)[None]
                assert shard.shape == example.shape
                backend.reset_launches()
                with torch.no_grad():
                    out = step(shard)
                torch.cuda.synchronize()
                launches = dict(backend.LAUNCHES)
                runs.append(launches)
                rx = DVBS2Receiver(mc=4, short=short, block_symbols=block)
                window = np.concatenate([shard[0]] * (step.hops + 1),
                                        axis=-1)[:, :2 * block]
                with torch.no_grad():
                    ref = {k: v[0] for k, v in rx.program(
                        torch.from_numpy(window)[None].to(dev)).items()}
                    ref.pop("scatter")
                    ref.update(run_fec(rx.program, ref.pop("llrs"),
                                       rx.max_ldpc_trials, "xla"))
                assert out.keys() == ref.keys(), (out.keys(), ref.keys())
                for k in ref:
                    assert torch.equal(out[k][0], ref[k]), \
                        f"time-sharded {block}: {k} differs from the serial"
                ms = step_ms(torch, lambda: step(shard))
                print(f"build_time_sharded(1) at {block} symbols "
                      f"({'short' if short else 'normal'} frames, A {A}, "
                      f"{step.hops} hops): every output equal to the serial "
                      f"program + full-budget FEC on the wrapped window; "
                      f"ldpc_ok {out['ldpc_ok'][0].tolist()}; step from the "
                      f"host {ms[0]:.3f} ms min, {ms[1]:.3f} mean; launches "
                      f"{launches}")
                assert launches["resample_farrow"] > 0

            program, (example,) = entry.entry()
            with torch.no_grad():
                out = program(example)
            torch.cuda.synchronize()
            assert out["llrs"].shape == (1, 2, 16200) and \
                bool(torch.isfinite(out["llrs"]).all())
            print(f"entry(): program on {example.device}, llrs "
                  f"{tuple(out['llrs'].shape)} finite")
        finally:
            collectives.close_mesh()
    return runs


# ---------------------------------------------------------------------------
# the paths added after the sharded builds: the wideband CLI, live UDP
# ingest with --control, GSE -> GRE, the failure paths, the examples
# ---------------------------------------------------------------------------

def phase_wideband(torch, sigs_s2, noise_s2, sigs_dvbs, noise_dvbs) -> list:
    """The CLI's multi-carrier routes on one wideband capture each: four
    DVB-S2 carriers through the channelizer and the fused DVB-S2 bank
    (the CLI's default cs8 ingest, --fec pallas: 4 x 32 frames, one
    launch of kernel A a block), then two DVB-S carriers through the
    fused DVB-S bank. Returns the launch counts of both runs."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.io import source
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    from dvbs_tpu_torch.parallel.dvbs_bank import DVBSBankStream
    from dvbs_tpu_torch.tx import signals
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        def run(label, sigs, noise, offsets, cls, extra):
            n = min(min(len(y) for y, _ in sigs), len(noise))
            wide = noise[:n].copy()
            for y, _ in sigs:
                wide += y[:n]
            iq, out = os.path.join(tmp, "wide.cf32"), os.path.join(tmp, "o")
            source.write_iq_file(iq, wide)
            del wide
            args = ["--iq", iq, "--samplerate", str(WIDE_RATE),
                    "--symbolrate", "1.0", f"--offset={offsets[0]}",
                    "--out", out] + [f"--carrier={o}:1.0"
                                     for o in offsets[1:]] + extra
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backend.reset_launches()
            t0 = time.perf_counter()
            with made_streams(cls) as made:
                err = cli_stderr(args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(backend.LAUNCHES)
            runs.append(launches)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            st = made[0]
            outs = []
            for c in range(len(offsets)):
                with open(out + (f".c{c}" if c else ""), "rb") as f:
                    outs.append(f.read())
            state = (f"frames ok {st.frames_ok.tolist()} of "
                     f"{st.frames_seen.tolist()}" if cls is DVBS2BankStream
                     else f"locked {st.locked.tolist()}, ber "
                     f"{st.ber.tolist()}")
            print(f"{label} CLI: {state}; bytes out "
                  f"{[len(o) for o in outs]}; its last lines: "
                  f"{err.strip().splitlines()[-3:]}")
            npk = [signals.contiguous_packets(o, sent, f"{label} c{c}")
                   for c, (o, (_, sent)) in enumerate(zip(outs, sigs))]
            print(f"{label} CLI: {len(offsets)} carriers at offsets "
                  f"{list(offsets)} in {n} samples at {WIDE_RATE} samples "
                  f"a symbol, Es/N0 {WIDE_SNR} dB; TS one byte-exact "
                  f"contiguous run per carrier ({npk} packets); {dt:.2f} s "
                  f"in all, reading the capture and the channelizer "
                  f"included; peak memory {peak:.2f} GiB "
                  f"(max_memory_allocated); launches {launches}")
            return st, npk, launches, dt

        st, npk, launches, dt = run(
            "wideband DVB-S2", sigs_s2, noise_s2, WIDE_S2, DVBS2BankStream,
            ["--mode", "s2", "--modcod", str(MC), "--framesize", "normal",
             "--fec", "pallas"])
        F, per = st.F, st.cfg.kbch // 8 // 188
        blocks = int(st.frames_seen[0]) // F
        assert st.ingest == "f16" and len(st.frames_seen) == len(WIDE_S2)
        assert (st.frames_ok == st.frames_seen).all() and \
            blocks >= WIDE_S2_BLOCKS + 1, (st.frames_ok, st.frames_seen)
        for c, k in enumerate(npk):
            assert k >= (int(st.frames_seen[c]) - F) * per, (c, k)
        assert launches["ldpc_layered"] == blocks and \
            launches["resample_farrow"] == blocks, (launches, blocks)
        print(f"wideband DVB-S2 bank: {len(WIDE_S2)} x {F} = "
              f"{len(WIDE_S2) * F} frames a block from cs8, {blocks} "
              f"blocks, frames ok {st.frames_ok.tolist()} of "
              f"{st.frames_seen.tolist()}; {dt / blocks * 1e3:.1f} ms a "
              f"block; launches a block: kernel A "
              f"{launches['ldpc_layered'] / blocks:.1f}, kernel B "
              f"{launches['resample_farrow'] / blocks:.1f}")

        st, npk, launches, dt = run(
            "wideband DVB-S", sigs_dvbs, noise_dvbs, WIDE_DVBS,
            DVBSBankStream, ["--mode", "s", "--rate", "1/2",
                             "--block-symbols", str(WIDE_DVBS_BLOCK)])
        blocks = st.steps_run
        per = st.geom["emit"][1] // 8 // 204    # packets a step emits
        assert st.locked.all() and (st.ber < 0.05).all(), st.ber
        # all but the lock search's step and the deframer's sync emit
        assert blocks >= WIDE_DVBS_BLOCKS and \
            min(npk) >= (blocks - 3) * per, (blocks, npk)
        for k in ("viterbi_acs", "resample_farrow"):
            assert launches[k] >= blocks, (k, launches)
        print(f"wideband DVB-S bank: {blocks} steps of "
              f"{2 * WIDE_DVBS_BLOCK} samples a carrier ({per} packets "
              f"each), locked "
              f"{st.locked.tolist()}, ber {st.ber.tolist()}; "
              f"{dt / blocks * 1e3:.1f} ms a block; launches a block: "
              f"kernel B {launches['resample_farrow'] / blocks:.1f}, kernel "
              f"C {launches['viterbi_acs'] / blocks:.1f}")
    return runs


@contextlib.contextmanager
def udp_collector():
    """A localhost UDP socket drained by a thread: yields (port, the
    datagrams received so far)."""
    import socket
    import threading
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.05)
    got, stop = [], threading.Event()

    def drain():
        while not stop.is_set():
            try:
                got.append(sock.recv(65536))
            except socket.timeout:
                pass
    th = threading.Thread(target=drain, daemon=True)
    th.start()
    try:
        yield sock.getsockname()[1], got
    finally:
        time.sleep(0.2)
        stop.set()
        th.join(timeout=5)
        sock.close()


def phase_udp(torch, y, sent) -> list:
    """Live ingest: the port's CLI reads cf32 datagrams from
    udp://127.0.0.1 (the carrier at UDP_SPS, UDP_OFFSET off centre,
    through the channelizer), sent by a thread that starts once the CLI
    has bound its socket. First free-running at one block's samples per
    UDP_PACE seconds (the datagrams lost are counted); then with
    --control, the sender never more datagrams ahead of the CLI than a
    quarter of its socket buffer (a datagram takes about twice its
    bytes there; none lost) nor than 16, and the commands written to the
    CLI's stdin pipe as the stream goes: metrics and symbolrate before
    the first block, the UDP sink switched on from 30% of the datagrams
    on once a frame has decoded (so the file has TS), off (then save and
    an unknown command) from 60% on once the second socket has received
    TS. Returns the launch counts of both runs."""
    import socket
    import threading
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.io import source
    from dvbs_tpu_torch.models.driver import DVBS2Stream
    from dvbs_tpu_torch.tx import signals
    raw = np.empty(2 * len(y), np.float32)
    raw[0::2], raw[1::2] = y.real, y.imag
    data, step = raw.tobytes(), UDP_DATAGRAM * 8
    n_dgrams = -(-len(data) // step)
    interval = UDP_PACE * UDP_DATAGRAM / (SLICE_BLOCK * UDP_SPS)
    sent_set = set(p.tobytes() for p in sent)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        def run(label, credit, script=None, extra=()):
            probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            probe.bind(("127.0.0.1", 0))
            port = probe.getsockname()[1]
            probe.close()
            out = os.path.join(tmp, label + ".ts")
            count = [0]

            def sender(made, streams):
                t0 = time.monotonic()
                while not made and time.monotonic() - t0 < 120:
                    time.sleep(0.005)
                src = made[0]
                # a datagram takes about twice its bytes of the buffer;
                # at most 16 ahead, so that the CLI's progress follows
                # the sender's
                window = max(1, min(16, src.rcvbuf // (4 * step)))
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                t0 = time.perf_counter()
                for i in range(n_dgrams):
                    if script:
                        script(i, streams)
                    while credit and count[0] - src.datagrams >= window:
                        time.sleep(0.0005)
                    wait = t0 + i * interval - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                    s.sendto(data[i * step:(i + 1) * step],
                             ("127.0.0.1", port))
                    count[0] += 1
                s.close()
            backend.reset_launches()
            t0 = time.perf_counter()
            with made_streams(source.UDPSource) as made, \
                    made_streams(DVBS2Stream) as streams:
                th = threading.Thread(target=sender, args=(made, streams),
                                      daemon=True)
                th.start()
                try:
                    err = cli_stderr(
                        ["--iq", f"udp://127.0.0.1:{port}", "--mode", "s2",
                         "--modcod", str(MC), "--framesize", "normal",
                         "--fec", "pallas", "--samplerate", str(UDP_SPS),
                         "--symbolrate", "1.0", "--offset", str(UDP_OFFSET),
                         "--block-symbols", str(SLICE_BLOCK),
                         "--udp-idle-timeout", "2", "--out", out]
                        + list(extra))
                finally:
                    th.join(timeout=120)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert not th.is_alive(), f"{label}: the sender hangs"
            runs.append(dict(backend.LAUNCHES))
            src = made[0]
            with open(out, "rb") as f:
                ts = f.read()
            m = re.findall(r" ok=(\d+)/(\d+)", err)
            print(f"udp {label}: {count[0]} datagrams of {UDP_DATAGRAM} "
                  f"samples sent ({len(y)} samples at {UDP_SPS} a symbol, "
                  f"offset {UDP_OFFSET}), {src.datagrams} received, "
                  f"{count[0] - src.datagrams} lost; SO_RCVBUF "
                  f"{src.rcvbuf} bytes (getsockopt); frames ok "
                  f"{m[-1] if m else None}; {dt:.2f} s in all with the "
                  f"2 s idle timeout; launches {runs[-1]}")
            return ts, src, err, count[0]

        ts, src, _, n = run("free-running", False)
        assert n == n_dgrams
        g = np.frombuffer(ts, np.uint8).reshape(-1, 188)
        assert len(g) > 0 and all(p.tobytes() in sent_set for p in g), \
            "udp free-running: a packet that was not sent"
        if src.datagrams == n:
            npk = signals.contiguous_packets(ts, sent, "udp free-running")
            print(f"udp free-running: nothing lost; TS one byte-exact "
                  f"contiguous run of {npk} packets")
        else:
            print(f"udp free-running: {n - src.datagrams} of {n} datagrams "
                  f"lost at this pace; every one of the {len(g)} packets "
                  f"out was sent")

        with udp_collector() as (port2, got):
            r, w = os.pipe()
            os.write(w, b"metrics\nsymbolrate 1.0\n")
            k_on, k_off = n_dgrams * 3 // 10, n_dgrams * 6 // 10
            done = []

            def script(i, streams):
                # the sink to UDP once the file has TS, off once the
                # second socket has (or at the last datagram)
                last = i == n_dgrams - 1
                if not done and i >= k_on and (
                        last or streams[0].metrics.frames_ok > 0):
                    os.write(w, f"udp 127.0.0.1:{port2}\n".encode())
                    done.append(i)
                elif len(done) == 1 and i >= k_off and (got or last):
                    os.write(w, b"udp off\nsave\nbogus\n")
                    done.append(i)
            state = os.path.join(tmp, "udp.state")
            stdin = sys.stdin
            sys.stdin = os.fdopen(r, "r")
            try:
                ts, src, err, n = run("with --control", True, script,
                                      ["--control", "--state-file", state])
            finally:
                sys.stdin.close()
                sys.stdin = stdin
                os.close(w)
        udp = b"".join(got)
        assert src.datagrams == n == n_dgrams, (src.datagrams, n)
        for line in ("control: rates -> samplerate=2.7 symbolrate=1.0",
                     f"control: udp -> 127.0.0.1:{port2}",
                     "control: udp -> off", "control: state saved",
                     "control: unknown command 'bogus'",
                     "control: Metrics("):
            assert line in err, f"udp --control: no {line!r}"
        assert os.path.exists(state)
        assert len(ts) > 0 and len(udp) > 0 and \
            all(len(d) == 1880 for d in got), (len(ts), len(udp))
        npk = signals.contiguous_packets(ts + udp, sent, "udp --control")
        print(f"udp with --control: every command applied (metrics, "
              f"symbolrate, udp on, udp off, save, an unknown one); "
              f"{len(ts) // 188} packets to the file, then {len(got)} "
              f"datagrams ({len(udp) // 188} packets) to the second socket "
              f"while its sink was on: together one byte-exact contiguous "
              f"run of {npk} packets")
    return runs


def gse_gate(label: str, out: bytes, pdus: list, bb, frames_ok: int,
             frames_seen: int) -> str:
    """GSE -> GRE gate: every frame decoded, and the GRE output is, for
    some first decoded frame f0, exactly what a fresh reference parser
    gives on the sent BBFRAMEs f0 .. f0 + frames_ok - 1 (it resyncs on
    the first, whose SYNCD points at its padding, and parses every later
    one whole): the sent PDUs i..j in order, each `00 00 08 00` + PDU.
    Returns "found/sent"."""
    from dvbs_tpu_torch.io.bbframe_parser import BBFrameParser
    from dvbs_tpu_torch.spec import scrambling
    assert frames_ok == frames_seen > 2, (label, frames_ok, frames_seen)
    plain = scrambling.bb_scramble_bytes(bb)
    kbch = plain.shape[1] * 8
    for f0 in range(4):
        if BBFrameParser(kbch).feed(plain[f0:f0 + frames_ok]) == out:
            break
    else:
        raise AssertionError(f"{label}: the GRE output is not the parse of "
                             f"{frames_ok} consecutive sent frames")
    hdr = b"\x00\x00\x08\x00"
    i = next(k for k, p in enumerate(pdus) if out.startswith(hdr + p))
    pos, j = 0, i
    while pos < len(out):
        assert out[pos:pos + 4 + len(pdus[j])] == hdr + pdus[j], (label, j)
        pos += 4 + len(pdus[j])
        j += 1
    return f"{j - i}/{len(pdus)} (PDUs {i}..{j - 1}, frames {f0}.." \
        f"{f0 + frames_ok - 1})"


def phase_gse(torch, dev, program, carriers, single) -> list:
    """GSE -> GRE through the main path's bank program on 8 seam-free
    GSE carriers (cs4, kernel A), and through DVBS2Stream at 2^17
    symbols. Returns the launch counts of both runs."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    from dvbs_tpu_torch.models.driver import DVBS2Stream
    runs = []
    st = DVBS2BankStream(N_CARRIERS, mc=MC, short=SHORT, fec="int8",
                         ingest="cs4", program=program, device=dev)
    need = gse_need(True)
    outs = [bytearray() for _ in range(N_CARRIERS)]
    backend.reset_launches()
    for lo in range(0, need, st.block_symbols):
        for c, o in zip(st.feed([s[lo:min(lo + st.block_symbols, need)]
                                 for s, _, _ in carriers]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    torch.cuda.synchronize()
    runs.append(dict(backend.LAUNCHES))
    oks = [gse_gate(f"GSE bank c{c}", bytes(o), pdus, bb,
                    int(st.frames_ok[c]), int(st.frames_seen[c]))
           for c, (o, (_, pdus, bb)) in enumerate(zip(outs, carriers))]
    found = sum(int(k.split("/")[0]) for k in oks)
    total = sum(len(p) for _, p, _ in carriers)
    print(f"GSE bank ({N_CARRIERS} carriers, cs4, {need} samples each, "
          f"frames ok {st.frames_ok.tolist()}): gse_gre_pdus_ok "
          f"{found}/{total}; per carrier {oks}; launches {runs[-1]}")
    assert runs[-1]["ldpc_layered"] > 0 and runs[-1]["resample_farrow"] > 0
    y, pdus, bb = single
    rx = DVBS2Stream(mc=MC, short=False, block_symbols=SLICE_BLOCK,
                     fec="pallas")
    out = bytearray()
    backend.reset_launches()
    for lo in range(0, len(y), 2 * SLICE_BLOCK):
        out.extend(rx.feed(y[lo:lo + 2 * SLICE_BLOCK]))
    torch.cuda.synchronize()
    runs.append(dict(backend.LAUNCHES))
    m = rx.metrics
    ok = gse_gate("GSE DVBS2Stream", bytes(out), pdus, bb, m.frames_ok,
                  m.frames_seen)
    print(f"GSE DVBS2Stream (2^17 symbols, normal frames, fec pallas): "
          f"gse_gre_pdus_ok {ok}; launches {runs[-1]}")
    assert runs[-1]["ldpc_layered"] > 0 and runs[-1]["resample_farrow"] > 0
    return runs


def contig_tail(got: bytes, sent: np.ndarray) -> int:
    """Longest contiguous run of sent's packets ending the output (the
    JAX package's tests/test_reacquire.py)."""
    g = np.frombuffer(got, np.uint8)
    g = g[:len(g) // 188 * 188].reshape(-1, 188)
    sb = sent.tobytes()
    idx = [sb.find(p.tobytes()) for p in g]
    idx = [k // 188 if k >= 0 else -1 for k in idx]
    run = 0
    for i in range(len(g) - 1, -1, -1):
        if idx[i] < 0 or (run and idx[i] != idx[i + 1] - 1):
            break
        run += 1
    return run


def packet_runs(got: bytes, sent: np.ndarray, label: str) -> int:
    """The number of contiguous runs of sent's packets that make up the
    output; every packet out must be one that was sent."""
    g = np.frombuffer(got, np.uint8).reshape(-1, 188)
    where = {p.tobytes(): i for i, p in enumerate(sent)}
    idx = [where.get(p.tobytes(), -1) for p in g]
    assert len(idx) > 0 and min(idx) >= 0, f"{label}: a packet not sent"
    return 1 + sum(b != a + 1 for a, b in zip(idx, idx[1:]))


def bank_run(torch, st, sigs, blocks: int) -> tuple:
    """Feed a DVBS2BankStream the first block and `blocks` more, then
    flush: (TS per carrier, launch counts)."""
    from dvbs_tpu_torch import backend
    n = 2 * st.block_symbols
    need = stream_need(st.cfg, st.block_symbols, st.F, blocks)
    assert min(len(s) for s in sigs) >= need
    outs = [bytearray() for _ in sigs]
    backend.reset_launches()
    for lo in range(0, need, n // 2):
        for c, o in zip(st.feed([s[lo:min(lo + n // 2, need)]
                                 for s in sigs]), outs):
            o.extend(c)
    for c, o in zip(st.flush(), outs):
        o.extend(c)
    torch.cuda.synchronize()
    return [bytes(o) for o in outs], dict(backend.LAUNCHES)


def phase_failures(torch, dev, sigs, late, main_ts) -> list:
    """The failure paths of the JAX package's tests, at the card's
    shapes: DVBS2Stream reacquisition after signal loss and across a
    timing step; the 8-carrier QPSK 1/2 bank (default f16 ingest, that
    is cs8, fec pallas) with a dead carrier, a starved first pass and a
    diverging carrier; fec pallas at 3 carriers; the cs8 bank against
    the main path's cs4 TS; the DVB-S watchdog. Returns the launch
    counts of every run."""
    from dvbs_tpu_torch import backend, tables
    from dvbs_tpu_torch.io.native import NativeTSParser
    from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
    from dvbs_tpu_torch.models.driver import DVBS2Stream
    from dvbs_tpu_torch.ops import ldpc_kernel
    from dvbs_tpu_torch.parallel.dvbs_bank import DVBSBankStream
    from dvbs_tpu_torch.parallel.mesh import (bank_block_symbols,
                                              build_carrier_bank)
    from dvbs_tpu_torch.spec import modcod
    from dvbs_tpu_torch.tx import signals
    runs = []
    n = 2 * SLICE_BLOCK

    # signal, 1.5 blocks of noise, then another signal at a new delay
    # and CFO; and a 3.3-sample timing step mid-block 4
    (yA, _), = take(late, "reacq_a")
    (yB, pB), = take(late, "reacq_b")
    rng = np.random.default_rng(3)
    noise = 0.9 * (rng.standard_normal(3 * n // 2) + 1j * rng.standard_normal(
        3 * n // 2)).astype(np.complex64)
    st = DVBS2Stream(mc=MC, short=False, block_symbols=SLICE_BLOCK,
                     fec="pallas")
    F = st.rx.n_frames
    per = st.cfg.kbch // 8 // 188
    backend.reset_launches()
    st.feed(yA)
    okA = st.metrics.frames_ok
    st.feed(noise)
    ok_mid = st.metrics.frames_ok
    outB = bytearray()
    for lo in range(0, len(yB), n):
        outB.extend(st.feed(yB[lo:lo + n]))
    torch.cuda.synchronize()
    runs.append(dict(backend.LAUNCHES))
    okB = st.metrics.frames_ok - ok_mid
    tail = contig_tail(bytes(outB), pB)
    print(f"reacquisition (DVBS2Stream, {SLICE_BLOCK} symbols, F {F}): "
          f"{okA} frames ok before the loss, {ok_mid - okA} in the noise, "
          f"{okB} after the signal came back at delay 7.35 and CFO "
          f"-0.015 pi; the output ends in a contiguous run of {tail} "
          f"packets; launches {runs[-1]}")
    assert okA >= 2 * F and okB >= 3 * F, (okA, okB)
    assert tail >= (okB - F) * per, (tail, okB)

    (y, sent), = take(late, "timing")
    st = DVBS2Stream(mc=MC, short=False, block_symbols=SLICE_BLOCK,
                     fec="pallas")
    out = bytearray()
    backend.reset_launches()
    for lo in range(0, len(y), n):
        out.extend(st.feed(y[lo:lo + n]))
    torch.cuda.synchronize()
    runs.append(dict(backend.LAUNCHES))
    lost = st.metrics.frames_seen - st.metrics.frames_ok
    tail = contig_tail(bytes(out), sent)
    print(f"timing step of 3.3 samples mid-block 4 (DVBS2Stream): "
          f"{st.stats.blocks} blocks, {lost} of {st.metrics.frames_seen} "
          f"frames lost; the output ends in a contiguous run of {tail} "
          f"packets; launches {runs[-1]}")
    assert lost <= F + 1 and tail >= 2 * F * per, (lost, tail)

    # the bank at the main path's geometry, default ingest (cs8)
    ys, sents = sigs["s2c"], sigs["s2"][1]
    kw = dict(mc=MC, short=SHORT, fec="pallas", device=dev)

    rng = np.random.default_rng(7)
    dead = [y.copy() for y in ys]
    dead[-1] = 0.8 * (rng.standard_normal(len(ys[-1])) + 1j *
                      rng.standard_normal(len(ys[-1]))).astype(np.complex64)
    # (the noise carrier's FIFO advances by its located frames, which
    # are noise too: a block more is fed for as many blocks to run)
    st = DVBS2BankStream(N_CARRIERS, **kw)
    outs, launches = bank_run(torch, st, dead, FAIL_BLOCKS + 1)
    runs.append(launches)
    print(f"dead carrier (bank, cs8, carrier {N_CARRIERS - 1} noise): frames "
          f"ok {st.frames_ok.tolist()} of {st.frames_seen.tolist()}, bytes "
          f"out {[len(o) for o in outs]}; launches {launches}")
    assert (st.frames_ok[:-1] == st.frames_seen[:-1]).all() and \
        st.frames_seen[0] >= FAIL_BLOCKS * st.F
    assert st.frames_ok[-1] == 0 and len(outs[-1]) == 0
    for c in range(N_CARRIERS - 1):
        assert signals.contiguous_packets(outs[c], sents[c], f"dead c{c}") \
            >= FAIL_BLOCKS * st.F * per

    # a starved first pass (one sweep), two carriers at 3.8 dB: noise
    # added to the 5 dB signals up to 10^-0.38 per sample
    starved = [y.copy() for y in ys]
    extra = np.sqrt((10 ** -0.38 - 10 ** -0.5) / 2)
    for c in (0, 1):
        starved[c] = starved[c] + (rng.normal(0, extra, len(ys[c])) + 1j *
                                   rng.normal(0, extra, len(ys[c]))
                                   ).astype(np.complex64)
    st = DVBS2BankStream(N_CARRIERS, n_iters=1, max_ldpc_trials=40, **kw)
    # per block, before the stream finalizes it: the frames that clear
    # the sync gate (quality >= sof_threshold) and those the one-sweep
    # first pass decoded
    gate = np.zeros(N_CARRIERS, np.int64)
    first = np.zeros(N_CARRIERS, np.int64)
    finalize = st._finalize

    def spy(dev, outs):
        gate[:] += (dev["quality"].cpu().numpy() >= st.sof_threshold
                    ).sum(axis=1)
        first[:] += dev["ldpc_ok"].cpu().numpy().reshape(
            N_CARRIERS, -1).sum(axis=1)
        return finalize(dev, outs)
    st._finalize = spy
    outs, launches = bank_run(torch, st, starved, FAIL_BLOCKS)
    runs.append(launches)
    print(f"escalation (bank, n_iters=1, carriers 0-1 at 3.8 dB): first "
          f"pass ok {first.tolist()}, frames through the sync gate "
          f"{gate.tolist()}, frames ok {st.frames_ok.tolist()} of "
          f"{st.frames_seen.tolist()}, last block's trials "
          f"{st.ldpc_trials.tolist()}; launches {launches} (kernel A twice "
          f"a block: the first pass and the rerun)")
    # every frame the sync gate lets through is recovered by the rerun;
    # a frame under the gate (quality < 0.6 at 3.8 dB) is no frame to the
    # receiver, and its TS has a gap there
    assert (st.frames_ok == gate).all() and (st.ldpc_trials > 1).any()
    assert (first < st.frames_ok).all(), first
    assert launches["ldpc_layered"] > (FAIL_BLOCKS + 1)
    for c in range(N_CARRIERS):
        k = packet_runs(outs[c], sents[c], f"escalation c{c}")
        assert k <= 1 + st.frames_seen[c] - gate[c], (c, k)

    # one carrier on MODCOD 6 (QPSK 2/3) under auto_modcod
    (_, _, y6), = take(late, "mc6")
    mixed6 = ys[:-1] + [y6]
    st = DVBS2BankStream(N_CARRIERS, vote_frames=6, **kw)
    outs, launches = bank_run(torch, st, mixed6, FAIL_BLOCKS)
    runs.append(launches)
    pls6 = modcod.get_config(6, short=False).pls_code
    print(f"diverging carrier (bank, carrier {N_CARRIERS - 1} on MODCOD 6): "
          f"bank MODCOD {st.cfg.modcod}, detected_pls "
          f"{st.detected_pls.tolist()} (MODCOD 6: {pls6}), frames ok "
          f"{st.frames_ok.tolist()}; launches {launches}")
    assert st.cfg.modcod == MC and st.detected_pls[-1] == pls6
    assert all(p in (-1, st.cfg.pls_code) for p in st.detected_pls[:-1])
    for c in range(N_CARRIERS - 1):
        assert signals.contiguous_packets(outs[c], sents[c], f"div c{c}") \
            >= FAIL_BLOCKS * st.F * per

    # fec pallas at 3 carriers: a frame total of 6, kernel A as it is
    block = bank_block_symbols(3, mc=MC, frames_total=6)
    step, _, _ = build_carrier_bank(3, mc=MC, short=SHORT,
                                    block_symbols=block, fec="pallas",
                                    ingest="cs4", stream_outputs=True,
                                    device=dev)
    dev_in = torch.from_numpy(np.stack([s[:2 * block]
                                        for s in sigs["s2"][0][:3]])).to(dev)
    backend.reset_launches()
    with torch.no_grad():
        out = step(dev_in)
    torch.cuda.synchronize()
    runs.append(dict(backend.LAUNCHES))
    # the step's own int8 frames through the kernel and its plain version
    q = ldpc_kernel.quantize_llrs(out["llrs"])
    kt = tables.kernel_tables(st.cfg.ldpc_table)
    same_decode(torch, "the 3-carrier bank's frames",
                ldpc_kernel.decode_cuda(q, kt, 12),
                ldpc_kernel.decode_plain(q, kt, 12))
    h = {k: v.cpu().numpy() for k, v in out.items()
         if k not in ("llrs", "hard")}
    F3 = h["quality"].shape[1]
    kb = np.ascontiguousarray(h["kbch_bytes"].reshape(3, F3, -1))
    npk = [signals.contiguous_packets(NativeTSParser(st.cfg.kbch).feed(
        kb[c]), sents[c], f"3-carrier c{c}") for c in range(3)]
    print(f"fec pallas at 3 carriers x {F3} frames: ldpc_ok "
          f"{h['ldpc_ok'].tolist()}, trials {h['trials'].tolist()}; kernel "
          f"A on the step's {3 * F3} int8 frames equals its plain version "
          f"(hard, n_bad, trials); TS contiguous ({npk} packets); launches "
          f"{runs[-1]}")
    assert h["ldpc_ok"].all() and not h["bch_bad"].any()
    assert runs[-1]["ldpc_layered"] == 1

    # the main path's signals through the cs8 ingest: the same TS as cs4
    st = DVBS2BankStream(N_CARRIERS, **kw)
    outs, launches = bank_run(torch, st, ys, E2E_BLOCKS)
    runs.append(launches)
    assert (st.frames_ok == st.frames_seen).all(), st.frames_ok
    for c in range(N_CARRIERS):
        assert outs[c] == main_ts[c], f"cs8 c{c}: TS differs from cs4's"
    print(f"cs8 bank on the main path's signals: frames ok "
          f"{st.frames_ok.tolist()}, every carrier's TS equal to the cs4 "
          f"main path's ({[len(o) // 188 for o in outs]} packets); launches "
          f"{launches}")

    # DVB-S watchdog: carrier 1 dead for 23 blocks, then back
    (y0, s0), (y1, _) = take(late, "watch")
    y1 = y1.copy()
    lo_d, hi_d = WATCH_DEAD
    nk = (hi_d - lo_d) * WATCH_BLOCK
    y1[lo_d * WATCH_BLOCK:hi_d * WATCH_BLOCK] = (
        rng.standard_normal(nk) + 1j * rng.standard_normal(nk)).astype(
            np.complex64)
    st = DVBSBankStream(2, rate="1/2", block_samples=WATCH_BLOCK, device=dev)
    out0, flags = bytearray(), []
    backend.reset_launches()
    for lo in range(0, WATCH_BLOCKS * WATCH_BLOCK, WATCH_BLOCK):
        o = st.feed([y0[lo:lo + WATCH_BLOCK], y1[lo:lo + WATCH_BLOCK]])
        out0.extend(o[0])
        flags.append((bool(st.locked[0]), bool(st.locked[1]),
                      float(st.ber[1])))
    torch.cuda.synchronize()
    runs.append(dict(backend.LAUNCHES))
    unlocked = [i for i, f in enumerate(flags) if not f[1]]
    relocked = bool(unlocked) and any(
        f[1] and f[2] < 0.05 for f in flags[unlocked[0]:])
    npk = signals.contiguous_packets(bytes(out0), s0, "watchdog c0")
    print(f"DVB-S watchdog (2 carriers, {WATCH_BLOCK} samples a block, "
          f"carrier 1 noise in blocks {lo_d}..{hi_d - 1}): carrier 1 "
          f"unlocked in blocks {unlocked[:1]}..{unlocked[-1:]}, relocked "
          f"{relocked}; carrier 0 always locked "
          f"{all(f[0] for f in flags)}, one contiguous run of {npk} "
          f"packets; launches {runs[-1]}")
    assert all(f[0] for f in flags) and unlocked and relocked
    return runs


def phase_coverage(torch, dev) -> None:
    """Every shape at which the main paths launched kernel A, B or C or
    the soft demapper (backend.SHAPES since the main path began) held
    against the plain version: the kernels' phases compared most; each
    other one is compared here (A on noisy int8 frames of a table of its
    length, 12 sweeps; B on noise; C on noisy codewords; the demapper on
    points of its constellation at 10 dB)."""
    from dvbs_tpu_torch import backend, tables
    from dvbs_tpu_torch.spec import ldpc_spec
    rng = np.random.default_rng(60)
    for name, label in (("ldpc_layered", "A"), ("resample_farrow", "B"),
                        ("viterbi_acs", "C"), ("soft_demap", "demap")):
        launched = sorted(backend.SHAPES[name])
        late = [s for s in launched if s not in COMPARED[name]]
        for s in late:
            if name == "resample_farrow":
                resample_case(torch, dev, *s)
            elif name == "soft_demap":
                demap_case(torch, dev, *s, 10.0)
            elif name == "viterbi_acs":
                x = rng.normal(0, 1.5, s + (2,))
                x[:, ::3, 1] = 0.0
                viterbi_case(torch, f"[{s[0]}, {s[1]}, 2]", torch.from_numpy(
                    x.astype(np.float32)).to(dev))
            else:
                from dvbs_tpu_torch.ops import ldpc_kernel
                table, rate, ebno = next(
                    c for c in LDPC_CASES
                    if ldpc_spec.get_code(c[0]).N == s[1]) if s[1] == 64800 \
                    else ("C1", 1 / 4, 1.5)
                kt = tables.kernel_tables(table)
                llr, _ = noisy_llrs(torch, dev, table, rate, ebno, s[0], rng)
                same_decode(torch, f"{table} [{s[0]}, {s[1]}]",
                            ldpc_kernel.decode_cuda(llr, kt, 12),
                            ldpc_kernel.decode_plain(llr, kt, 12))
        print(f"kernel {label}: each of the {len(launched)} shapes the main "
              f"paths launched it at equals its plain version; "
              f"{len(launched) - len(late)} compared in the kernels' "
              f"phases, {len(late)} here {late}")


def phase_examples(torch) -> list:
    """The port's two examples in-process on the card: loopback_demo and
    carrier_bank_demo --bench-shape; each must return 0. Returns the
    launch counts of both."""
    from dvbs_tpu_torch import backend
    from dvbs_tpu_torch.examples import carrier_bank_demo, loopback_demo
    runs = []
    for demo, argv in ((loopback_demo, []),
                       (carrier_bank_demo, ["--bench-shape"])):
        name = demo.__name__.rsplit(".", 1)[1]
        out = io.StringIO()
        backend.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = demo.main(argv)
        torch.cuda.synchronize()
        runs.append(dict(backend.LAUNCHES))
        for line in out.getvalue().splitlines():
            print(f"  {name}: {line}")
        print(f"example {' '.join([name] + argv)}: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s with its signals; "
              f"launches {runs[-1]}")
        assert rc == 0, name
    return runs


LAYERS_S2 = ("frontend", "timing", "plsync", "phase", "demap", "ldpc",
             "bch_pack")
LAYERS_DVBS = ("frontend", "timing", "carrier", "viterbi", "ber_pack")
LAYERS_SLICE = LAYERS_S2 + ("dd_phase_track",)


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
        # the innermost range that holds the kernel's start
        inside = [sp for sp in spans
                  if sp["ts"] <= k["ts"] < sp["ts"] + sp["dur"]]
        name = min(inside, key=lambda sp: sp["dur"])["name"] if inside \
            else "(outside)"
        per_layer[name] += k["dur"]
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


def main_phases(torch, dev, smi, sigs, late, stamp, profile, trace
                ) -> list:
    """Every phase from the main path on (7 to 19 of the module
    docstring); `late` holds the futures of the signals of phases 15 to
    19. Returns the launch counts of every main-path run."""
    runs = []
    launches, step, program, main_ts = phase_main_path(
        torch, dev, smi, *sigs["s2"])
    runs.append(launches)
    stamp("DVB-S2 QPSK 1/2 bank")
    if profile:
        phase_profile(torch, step, profile, LAYERS_S2, "DVB-S2")
    launches, step = phase_dvbs(torch, dev, smi, *sigs["dvbs"])
    runs.append(launches)
    stamp("DVB-S bank")
    if profile:
        phase_profile(torch, step, trace + "_dvbs.json", LAYERS_DVBS,
                      "DVB-S")
    for mc, _, label in PILOTS_BANKS:
        launches, step = phase_pilots(torch, dev, smi, mc, label, *sigs[mc])
        runs.append(launches)
        if mc == STREAM_MC:
            runs.append(phase_pilots_stream(torch, dev, *sigs[mc]))
    if profile:                 # the last bank: 32APSK 3/4
        phase_profile(torch, step, trace + "_32apsk.json", LAYERS_S2,
                      "32APSK 3/4 pilots")
    stamp("pilots banks")
    phase_graphs(torch, dev, smi, sigs[GRAPH_MC][0])
    stamp("32APSK bank step as CUDA graphs")
    runs += phase_slice(torch, sigs, trace if profile else None)
    stamp("single-carrier slice")
    runs += phase_dvbs_single(torch, sigs, trace if profile else None)
    stamp("single-carrier DVB-S")
    runs.append(phase_first_bank(torch, dev, smi, *sigs["dvbs"]))
    stamp("first-block DVB-S bank")
    runs += phase_equalizer(torch, sigs)
    stamp("equalizer")
    runs += phase_sharded(torch, dev, smi, sigs)
    stamp("sharded builds at world size 1")
    runs += phase_wideband(torch, take(late, "wide_s2"),
                           take(late, "wide_s2_noise")[0],
                           take(late, "wide_dvbs"),
                           take(late, "wide_dvbs_noise")[0])
    stamp("wideband CLI")
    runs += phase_udp(torch, *take(late, "udp")[0])
    stamp("live UDP ingest with --control")
    runs += phase_gse(torch, dev, program, take(late, "gse"),
                      take(late, "gse1")[0])
    stamp("GSE -> GRE")
    runs += phase_failures(torch, dev, sigs, late, main_ts)
    stamp("failure paths")
    runs += phase_examples(torch)
    stamp("examples")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="TRACE.json",
                    help="profile the QPSK, DVB-S and 32APSK bank steps; "
                    "write the first trace here and the others beside it")
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernels' checks (phases 1 to 6)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dvbs_tpu_torch import backend  # (fails outside a checkout)
    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        print(f"[{time.perf_counter() - t_start:6.1f} s] {phase} done",
              flush=True)
    dev = torch.device("cuda", 0)
    smi = phase_card(torch)
    trace = args.profile[:-5] if args.profile and \
        args.profile.endswith(".json") else args.profile
    runs = []                       # launch counts of every main-path run

    def kernel_phases() -> list:
        phase_build()
        stamp("build")
        rows = [phase_ldpc(torch, dev), phase_resample(torch, dev),
                phase_viterbi(torch, dev), phase_demap(torch, dev)]
        stamp("kernels A, B, C and the soft demapper against their plain "
              "versions")
        probe_row, probe_launches = phase_probe(torch, dev)
        runs.append(probe_launches)
        stamp("probe stages")
        return rows + [probe_row]

    def kernels_line(rows) -> None:
        for r in rows:
            r["launches"] = sum(run[r["name"]] for run in runs)
        print(json.dumps({"kernels": rows}))
    if args.kernels:
        kernels_line(kernel_phases())
        return 0
    # the workers make every phase's signals while this process builds
    # the kernels and holds each against its plain version; the later
    # phases' signals are made while the earlier phases run
    workers = max(1, min(8, len(os.sched_getaffinity(0)) - 1))
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        jobs = start_signals(pool)
        late = start_late_signals(pool)
        rows = kernel_phases()
        sigs = collect_signals(jobs, t0, workers)
        stamp("signals")
        for shapes in backend.SHAPES.values():
            shapes.clear()
        runs += main_phases(torch, dev, smi, sigs, late, stamp,
                            args.profile, trace)
        phase_coverage(torch, dev)
        stamp("every launched shape against the plain versions")
    except BaseException:
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    pool.shutdown()
    kernels_line(rows)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
