"""Command-line receiver: IQ in -> TS/GRE out, on the GPU.

PyTorch port of dvbs_tpu/cli.py with the same flags and values, plus
--device (default: the card; `--device cpu` runs the kernels' plain
versions). `--fec pallas` selects the int8 layered LDPC kernel, `--fec
xla` the float decoder.

Examples:
  python -m dvbs_tpu_torch.cli --iq capture.cf32 --mode s2 --modcod 4 \
      --framesize normal --fec pallas --out stream.ts
  python -m dvbs_tpu_torch.cli --iq capture.cf32 --mode s --out stream.ts
  python -m dvbs_tpu_torch.cli --iq capture.cf32 --mode s2 --auto-modcod \
      --udp 127.0.0.1:5000
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from . import backend
from .io import source, sink
from .io.config import Config
from .spec import modcod
from .models.driver import DVBS2Stream
from .models.dvbs import DVBSStream


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPU DVB-S/S2 demodulator")
    ap.add_argument("--iq", required=True,
                    help="IQ file, or udp://[host]:port for live ingest "
                         "(2 samples/symbol unless --samplerate "
                         "and --symbolrate say otherwise)")
    ap.add_argument("--format", default="cf32",
                    choices=["cf32", "cs16", "cs8", "cu8"])
    ap.add_argument("--samplerate", type=float, default=None,
                    help="capture sample rate in Hz; with --symbolrate, "
                         "resamples to 2 samples/symbol on ingest "
                         "(the runtime rate coupling of main.cpp:217-243)")
    ap.add_argument("--symbolrate", type=float, default=None,
                    help="signal symbol rate in Hz (with --samplerate)")
    ap.add_argument("--offset", type=float, default=0.0,
                    help="carrier offset in Hz within the capture "
                         "(mixed to baseband before resampling)")
    ap.add_argument("--carrier", action="append", default=None,
                    metavar="OFF:SYM",
                    help="demodulate an ADDITIONAL carrier from the "
                         "wideband capture (repeatable; needs "
                         "--samplerate/--symbolrate). Each extra "
                         "carrier gets its own receiver; file outputs "
                         "are suffixed .cN, UDP ports increment. The "
                         "reference needs one plugin instance per "
                         "carrier (main.cpp:30); here the channelizer "
                         "bank feeds N streams in one process")
    ap.add_argument("--mode", default="s2", choices=["s", "s2"])
    ap.add_argument("--rate", default=None,
                    choices=["1/2", "2/3", "3/4", "5/6", "7/8"],
                    help="DVB-S code rate (default: auto-detect per "
                         "carrier; REQUIRED for the fused multi-carrier "
                         "DVB-S bank, which shares one rate)")
    ap.add_argument("--modcod", type=int, default=None,
                    help="DVB-S2 MODCOD number 1-28")
    ap.add_argument("--framesize", default=None,
                    choices=["normal", "short"])
    ap.add_argument("--pilots", action="store_true")
    ap.add_argument("--auto-modcod", action="store_true")
    ap.add_argument("--block-symbols", type=int, default=1 << 17)
    ap.add_argument("--ldpc-trials", type=int, default=32)
    ap.add_argument("--fec", default="xla", choices=["xla", "pallas"],
                    help="LDPC decoder: xla (the float layered decoder, "
                         "plain PyTorch) or pallas (the int8 layered "
                         "decoder: the hand-written CUDA kernel on the "
                         "card, any number of frames per call)")
    ap.add_argument("--viterbi", default="auto",
                    choices=["auto", "xla", "pallas"],
                    help="DVB-S Viterbi segment decoder: auto or "
                         "pallas the radix-8 kernel (the CUDA kernel on "
                         "the card, its plain version on the CPU), xla "
                         "the float decoder of ops/viterbi.py")
    ap.add_argument("--state-file", default=None,
                    help="checkpoint/resume: restore stream state from "
                         "this file at startup (if it exists) and write "
                         "it back on exit, so a restarted receiver "
                         "continues mid-stream instead of reacquiring "
                         "(SURVEY.md sec. 5 loop-state carry; also "
                         "saved on the 'save' control command)")
    ap.add_argument("--udp", default=None, help="host:port UDP sink")
    ap.add_argument("--udp-idle-timeout", type=float, default=5.0,
                    help="with --iq udp://, stop after this many seconds "
                         "without datagrams")
    ap.add_argument("--out", default=None, help="output file")
    ap.add_argument("--config", default=None, help="JSON config file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; fails without "
                         "one). 'cpu' runs the kernels' plain versions")
    ap.add_argument("--control", action="store_true",
                    help="read runtime commands from stdin between blocks "
                         "(the CLI equivalent of the reference's GUI menu "
                         "+ setSymbolrate/setSamplerate, main.cpp:217-249): "
                         "'symbolrate <hz>', 'samplerate <hz>', "
                         "'offset <hz>', 'modcod <n> [short|normal] "
                         "[pilots|nopilots]', 'udp <host:port>|off', "
                         "'metrics'")
    args = ap.parse_args(argv)
    device = backend.resolve_device(args.device)

    cfgfile = Config(args.config) if args.config else Config(autosave=False)
    mc = args.modcod if args.modcod is not None else \
        modcod.get_modcod(cfgfile["dvbs2_constellation"],
                          cfgfile["dvbs2_coderate"])
    short = (args.framesize or cfgfile["dvbs2_framesize"]) == "short"
    pilots = args.pilots or cfgfile["dvbs2_pilots"]

    carriers = [(args.offset, args.symbolrate)]
    if args.carrier:
        if not (args.samplerate and args.symbolrate):
            ap.error("--carrier needs --samplerate and --symbolrate")
        for spec in args.carrier:
            off_s, sym_s = spec.split(":")
            carriers.append((float(off_s), float(sym_s)))
    C = len(carriers)

    def make_sink(ci):
        if args.udp:
            host, port = args.udp.rsplit(":", 1)
            return sink.UDPSink(host, int(port) + ci)
        if args.out:
            return sink.FileSink(args.out + (f".c{ci}" if ci else ""))
        return None

    def make_stream():
        if args.mode == "s":
            return DVBSStream(rate=args.rate,
                              block_symbols=args.block_symbols,
                              viterbi_impl=args.viterbi, device=device)
        return DVBS2Stream(mc=mc, short=short, pilots=pilots,
                           block_symbols=args.block_symbols,
                           auto_modcod=args.auto_modcod,
                           max_ldpc_trials=args.ldpc_trials,
                           fec=args.fec, device=device)

    def make_emit(snk):
        if snk is None:
            return lambda b: None
        return snk.send_raw if args.mode == "s" else snk.send_ts_chunked

    # multi-carrier S2 at a shared MODCOD: ONE fused device program for
    # all carriers (models/bank_stream.DVBS2BankStream) instead of N
    # independent receivers — the bank is the production path, not a
    # bench construct (the reference runs N plugin instances,
    # main.cpp:30,129). --auto-modcod enables the bank-level vote:
    # a unanimous new MODCOD rebuilds the shared program once; a
    # MIXED bouquet (carriers voting differently) is surfaced via
    # detected_pls — run per-carrier streams for those.
    bank = None
    if args.mode == "s2" and C > 1:
        from .models.bank_stream import DVBS2BankStream
        from .parallel.mesh import bank_block_symbols
        bank_bs = bank_block_symbols(C, mc=mc, short=short, pilots=pilots) \
            if args.fec == "pallas" else args.block_symbols
        bank = DVBS2BankStream(C, mc=mc, short=short, pilots=pilots,
                               block_symbols=bank_bs, fec=args.fec,
                               max_ldpc_trials=args.ldpc_trials,
                               auto_modcod=args.auto_modcod, device=device)
        streams = [bank]
    elif args.mode == "s" and C > 1 and args.rate:
        # fused DVB-S bank (shared code rate); without --rate each
        # carrier gets its own auto-locking stream instead
        from .parallel.dvbs_bank import DVBSBankStream
        bank = DVBSBankStream(C, rate=args.rate,
                              block_samples=2 * args.block_symbols,
                              viterbi_impl=args.viterbi, device=device)
        streams = [bank]
    else:
        streams = [make_stream() for _ in range(C)]
    sinks = [make_sink(ci) for ci in range(C)]
    emits = [make_emit(s) for s in sinks]
    stream, out_sink, emit = streams[0], sinks[0], emits[0]

    import os as _os
    import pickle as _pickle

    def save_state():
        if not args.state_file:
            return
        blob = dict(streams=[s.get_state() for s in streams],
                    ingest=ingest.get_state() if ingest is not None
                    else None)
        with open(args.state_file, "wb") as f:
            _pickle.dump(blob, f)

    def restore_state():
        if not (args.state_file and _os.path.exists(args.state_file)):
            return
        with open(args.state_file, "rb") as f:
            saved = _pickle.load(f)
        for s, st in zip(streams, saved["streams"]):
            s.set_state(st)
        if saved.get("ingest") is not None and ingest is not None:
            ingest.set_state(saved["ingest"])
        print(f"state restored from {args.state_file}", file=sys.stderr)

    if args.mode == "s2" and bank is None:
        # persist a successful auto-MODCOD vote, as the reference does
        # after reconfiguring (main.cpp:383-408 writes the voted modcod
        # back through config.acquire/release)
        def _persist_modcod(cfg, _cf=cfgfile):
            _cf["dvbs2_constellation"] = cfg.constellation
            _cf["dvbs2_coderate"] = cfg.rate
            _cf["dvbs2_framesize"] = cfg.framesize
            _cf["dvbs2_pilots"] = cfg.pilots
            print(f"auto-modcod: switched to {cfg.modcod} "
                  f"{cfg.framesize} pilots={cfg.pilots} (persisted)",
                  file=sys.stderr)
        streams[0].on_modcod_switch = _persist_modcod

    chunk0 = 4 * args.block_symbols
    if args.iq.startswith("udp://"):
        # live ingest: --iq udp://[host]:port ; stops after
        # --udp-idle-timeout seconds of silence
        hp = args.iq[len("udp://"):]
        uhost, _, uport = hp.rpartition(":")
        src = source.UDPSource(int(uport), uhost or "0.0.0.0",
                               fmt=args.format,
                               timeout=args.udp_idle_timeout)
        print(f"udp ingest on {uhost or '0.0.0.0'}:{uport}: receive "
              f"buffer {src.rcvbuf} bytes", file=sys.stderr)
        total_samples = "live"

        def block_iter():
            buf, have = [], 0
            while True:
                part = src.read()
                if part is None:            # idle: flush and stop
                    if have:
                        yield np.concatenate(buf)
                    src.close()
                    print(f"udp ingest: {src.datagrams} datagrams "
                          f"received", file=sys.stderr)
                    return
                buf.append(part)
                have += len(part)
                if have >= chunk0:
                    cat = np.concatenate(buf)
                    yield cat[:chunk0]
                    buf, have = [cat[chunk0:]], have - chunk0
    else:
        samples = source.read_iq_file(args.iq, args.format)
        total_samples = len(samples)

        def block_iter():
            for i in range(0, len(samples), chunk0):
                yield samples[i:i + chunk0]
    ingest = None
    if args.samplerate and args.symbolrate:
        from .ops.resample import Channelizer
        ingest = Channelizer(args.samplerate, carriers, device=device)
    elif args.samplerate or args.symbolrate:
        ap.error("--samplerate and --symbolrate must be given together")
    elif args.offset:
        ap.error("--offset needs --samplerate and --symbolrate")
    restore_state()
    total_out = 0
    ctrl_buf = ""

    def poll_control():
        """Apply queued stdin commands (non-blocking). Runs between
        blocks, mirroring the reference's ctrlMtx + tempStop/tempStart
        reconfiguration handshake (module_dvbs2_demod.cpp:98-214)."""
        nonlocal ingest, out_sink, emit, ctrl_buf
        import os
        import select
        # read raw bytes (not sys.stdin.readline: a second line queued
        # in the same write would sit in the TextIOWrapper buffer while
        # select reports the fd drained — applied one block late)
        while select.select([sys.stdin], [], [], 0)[0]:
            data = os.read(sys.stdin.fileno(), 65536)
            if not data:
                break               # EOF: process what we have
            ctrl_buf += data.decode(errors="replace")
        while "\n" in ctrl_buf:
            line, ctrl_buf = ctrl_buf.split("\n", 1)
            cmd = line.split()
            if not cmd:
                continue
            try:
                if cmd[0] in ("symbolrate", "samplerate", "offset"):
                    if ingest is None:
                        print("control: rates need --samplerate/"
                              "--symbolrate at startup", file=sys.stderr)
                        continue
                    from .ops.resample import Channelizer
                    sr = ingest.samplerate
                    off, sym = ingest.carriers[0]
                    val = float(cmd[1])
                    if cmd[0] == "symbolrate":
                        sym = val
                        cfgfile["dvbs2_symrate"] = val
                    elif cmd[0] == "samplerate":
                        sr = val
                    else:
                        off = val
                    # rebuild = the reference's tap/loop-gain regen;
                    # restart-is-reacquire semantics (SURVEY.md sec. 5);
                    # rate commands address the PRIMARY carrier, extra
                    # --carrier entries are preserved
                    ingest = Channelizer(sr, [(off, sym)] +
                                         list(ingest.carriers[1:]),
                                         device=device)
                    print(f"control: rates -> samplerate={sr} "
                          f"symbolrate={sym} offset={off}",
                          file=sys.stderr)
                elif cmd[0] == "modcod" and args.mode == "s2":
                    if bank is not None:
                        print("control: modcod is fixed for the fused "
                              "carrier bank (restart with new settings)",
                              file=sys.stderr)
                        continue
                    mc_new = int(cmd[1])
                    short_new = True if "short" in cmd else \
                        False if "normal" in cmd else None
                    pil_new = True if "pilots" in cmd else \
                        False if "nopilots" in cmd else None
                    stream.set_params(mc_new, short_new, pil_new)
                    cfgfile["dvbs2_constellation"] = \
                        stream.cfg.constellation
                    cfgfile["dvbs2_coderate"] = stream.cfg.rate
                    cfgfile["dvbs2_framesize"] = stream.cfg.framesize
                    cfgfile["dvbs2_pilots"] = stream.cfg.pilots
                    print(f"control: modcod -> {stream.cfg.modcod} "
                          f"{stream.cfg.framesize} pilots="
                          f"{stream.cfg.pilots}", file=sys.stderr)
                elif cmd[0] == "udp":
                    if out_sink:
                        out_sink.close()
                    if cmd[1] == "off":
                        out_sink, emit = None, (lambda b: None)
                    else:
                        host, port = cmd[1].rsplit(":", 1)
                        out_sink = sink.UDPSink(host, int(port))
                        emit = (out_sink.send_raw if args.mode == "s"
                                else out_sink.send_ts_chunked)
                    sinks[0], emits[0] = out_sink, emit
                    print(f"control: udp -> {cmd[1]}", file=sys.stderr)
                elif cmd[0] == "save":
                    save_state()
                    print(f"control: state saved to {args.state_file}",
                          file=sys.stderr)
                elif cmd[0] == "metrics":
                    if bank is None:
                        print(f"control: {stream.metrics}", file=sys.stderr)
                    elif args.mode == "s2":
                        print(f"control: {bank.stats.report()}",
                              file=sys.stderr)
                    else:
                        print("control: dvbs bank lock=" +
                              "".join(str(int(x)) for x in bank.locked) +
                              " ber=" + "/".join(f"{b:.3f}" for b in bank.ber)
                              + " out_of_sync=" + "/".join(
                                  str(int(x)) for x in bank.out_of_sync)
                              + f" steps={bank.steps_run}", file=sys.stderr)
                else:
                    print(f"control: unknown command {cmd[0]!r}",
                          file=sys.stderr)
            except (ValueError, IndexError) as e:
                print(f"control: bad command {line.strip()!r}: {e}",
                      file=sys.stderr)

    consumed = 0
    for base in block_iter():
        consumed += len(base)
        if args.control:
            poll_control()
        per = ingest.feed(base) if ingest is not None else [base]
        if bank is not None:
            datas = bank.feed(per)
            for ci, d in enumerate(datas):
                total_out += len(d)
                emits[ci](d)
            if args.mode == "s2":
                print(f"[{consumed:>10}/{total_samples}] out={total_out}B "
                      f"bank ok=" +
                      "/".join(f"{int(o)}:{int(s)}" for o, s in
                               zip(bank.frames_ok, bank.frames_seen)) +
                      f" sync={bank.sync_quality.mean():.2f} "
                      f"trials={int(bank.ldpc_trials.max(initial=0))}",
                      file=sys.stderr)
            else:
                print(f"[{consumed:>10}/{total_samples}] out={total_out}B "
                      f"dvbs bank lock=" +
                      "".join(str(int(x)) for x in bank.locked) +
                      " ber=" +
                      "/".join(f"{b:.3f}" for b in bank.ber),
                      file=sys.stderr)
            continue
        data = stream.feed(per[0])
        total_out += len(data)
        emits[0](data)
        for ci in range(1, C):
            d = streams[ci].feed(per[ci])
            total_out += len(d)
            emits[ci](d)
            mm = streams[ci].metrics
            print(f"  [c{ci}] out+={len(d)}B "
                  f"ok={mm.frames_ok}/{mm.frames_seen}", file=sys.stderr)
        m = stream.metrics
        if args.mode == "s":
            # DVB-S metric set (module_dvbs_demod.cpp:101-115)
            print(f"[{consumed:>10}/{total_samples}] out={total_out}B "
                  f"vit_sig={m.viterbi_sig_level:.1f} "
                  f"vit_rate={m.viterbi_rate} lock={int(m.viterbi_lock)} "
                  f"rs_avg={m.rs_avg_errors:.2f} "
                  f"defra_err={m.deframer_errors} "
                  f"ok={m.frames_ok}/{m.frames_seen}", file=sys.stderr)
        else:
            print(f"[{consumed:>10}/{total_samples}] out={total_out}B "
                  f"sync={m.pl_sync_best_match:.2f} "
                  f"ldpc_trials={m.ldpc_trials} bch_q={m.bch_quality:.1f} "
                  f"modcod={m.detected_modcod} "
                  f"ok={m.frames_ok}/{m.frames_seen}", file=sys.stderr)
    if bank is not None and hasattr(bank, "flush"):
        for ci, d in enumerate(bank.flush()):
            total_out += len(d)
            emits[ci](d)
    sinks[0] = out_sink       # control may have swapped carrier 0's sink
    for snk in sinks:
        if snk:
            snk.close()
    save_state()
    print(f"done: {total_out} bytes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
