"""Runs one cell once: set-up, the measured window, the check, the line.

Everything a cell needs is found by name, each piece in a file of its
own, so that a cell, a configuration, a traffic mix or a per-layer metric
is added with files and manifest entries alone:

- `BENCHMARK.json` names the cell's configuration, traffic mix and
  metrics;
- `rxbench/configs/<config>.json` is the deployment;
- `rxbench/traffic/<mix>.json` is the mix, whose `driver` names the
  general driver `rxbench/traffic/<driver>.py` that runs it;
- `rxbench/metrics/<metric>.json` names the reader
  (`rxbench/readers/<reader>.py`) of a per-layer metric and its
  parameters; a `rxbench/metrics/<metric>.py` with `read(ctx, spec)` is
  its own reader;
- `rxbench/work/<name>.py` counts the work of a roofline share.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import reference
from .capture import modcod_config

FORBIDDEN = ("jax", "jaxlib", "flax", "dvbs_tpu")
SAMPLED_BLOCKS = 3          # blocks whose step outputs are checked


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "rxbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """BENCHMARK.json at `root`, with its pieces looked up by name."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.m = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.m["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.m["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> tuple:
        for c in self.m["configs"]:
            if c["name"] == name:
                return c, json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> tuple:
        mix = json.loads((self.bench / "traffic" / f"{name}.json").read_text())
        return mix, load_module(self.bench / "traffic" / f"{mix['driver']}.py")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics (trace off) or per-layer ones."""
        e2e = [m for m in self.m["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.m["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in names]

    def reader(self, name: str) -> tuple:
        """(read function, spec) of per-layer metric `name`."""
        py = self.bench / "metrics" / f"{name}.py"
        if py.exists():
            return load_module(py).read, {}
        spec = json.loads((self.bench / "metrics" / f"{name}.json").read_text())
        return load_module(self.bench / "readers" /
                           f"{spec['reader']}.py").read, spec

    def work(self, name: str):
        return load_module(self.bench / "work" / f"{name}.py").work

    def peaks(self) -> dict:
        return json.loads((self.bench / "peaks.json").read_text())


def start_captures(root: Path, conf_file: str, n: int, seed: int,
                   tmp: str) -> list:
    """One worker process a carrier (capture.py); each writes its period
    to an .npz under `tmp`."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    jobs = []
    for c in range(n):
        out = os.path.join(tmp, f"carrier{c}.npz")
        p = subprocess.Popen([sys.executable, "-m", "rxbench.capture",
                              str(root / conf_file), str(c), str(seed), out],
                             cwd=str(root), env=env)
        jobs.append((p, out))
    return jobs


def collect_captures(jobs: list) -> list:
    carriers = []
    for p, out in jobs:
        if p.wait() != 0:
            raise RuntimeError(f"capture worker failed: {p.args}")
        with np.load(out) as z:
            carriers.append({k: z[k] for k in z.files})
        os.unlink(out)
    for c in carriers:
        for k in ("P", "ratio", "delay", "turns"):
            c[k] = c[k].item()
    return carriers


class TraceContext:
    """What a per-layer reader reads: the trace, and the traced stretch's
    counts, host times, sweeps and schedule."""

    def __init__(self, man, trace, session, m0, m1, win, conf):
        self.trace = trace
        self.conf = conf
        self.cfg = modcod_config(conf)
        self.steps = m1["steps"] - m0["steps"]
        self.blocks = m1["fins"] - m0["fins"]
        self.frames_per_step = conf["frames_per_step"]
        self.block_symbols = session.stream.block_symbols
        self.host = {
            "step_fn": session.step_s[m0["steps"]:m1["steps"]],
            "bank_stream._finalize": session.fin_s[m0["fins"]:m1["fins"]],
            "bank_stream.feed": [b - a for a, b in zip(
                session.t_call[m0["feeds"]:m1["feeds"]],
                session.t_ret[m0["feeds"]:m1["feeds"]])]}
        self.trials = [t.cpu().numpy() for t in session.step_trials] + \
            [t.cpu().numpy() for t in session.esc_trials[m0["escs"]:m1["escs"]]]
        self.backlog = win.get("backlog", [])
        self.peaks = man.peaks()
        self._man = man

    def work(self, name: str) -> tuple:
        return self._man.work(name)(self)


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi reads it (a roofline share
    is against the published peak at 700 W), or None without it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def refuse_forbidden(log) -> bool:
    """True, and the names on `log`, where the run has loaded a module of
    JAX or of the JAX package."""
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run: {', '.join(bad)}", file=log)
    return bool(bad)


def python_loop_ms() -> float:
    """ms for a fixed pure-Python loop: the host core's speed at the
    moment, which the stream's host work follows."""
    t = time.perf_counter()
    acc, d = 0, {}
    for i in range(1_000_000):
        acc += i & 7
        if i % 97 == 0:
            d[i % 1000] = acc
    return (time.perf_counter() - t) * 1e3


class HostLoad:
    """The host's load over the window: this process's CPU seconds and
    garbage-collector pauses."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, None
        gc.callbacks.append(self._gc)
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1
            self._t = None

    def stop(self, seconds: float) -> dict:
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.remove(self._gc)
        r0 = self.r0
        return dict(
            cpu_share=(r1.ru_utime + r1.ru_stime - r0.ru_utime -
                       r0.ru_stime) / seconds,
            sys_share=(r1.ru_stime - r0.ru_stime) / seconds,
            gc_ms=self.gc_s * 1e3, gc_collections=self.gc_n,
            python_loop_ms=python_loop_ms())


def host_times(session, m0, m1) -> dict:
    """The window's host ms a block: the enqueue (`step_fn`), `_finalize`
    and the rest of `feed`."""
    steps = session.step_s[m0["steps"]:m1["steps"]]
    fins = session.fin_s[m0["fins"]:m1["fins"]]
    feeds = sum(b - a for a, b in zip(session.t_call[m0["feeds"]:m1["feeds"]],
                                      session.t_ret[m0["feeds"]:m1["feeds"]]))
    blocks = max(1, len(fins))
    return dict(blocks=len(fins),
                enqueue_ms=sum(steps) / max(1, len(steps)) * 1e3,
                finalize_ms=sum(fins) / blocks * 1e3,
                stream_host_ms=(feeds - sum(steps) - sum(fins)) / blocks * 1e3)


def set_up(man: Manifest, workload: str, seed: int, device: str) -> tuple:
    """Captures (in worker processes) and the bank (here, meanwhile),
    then the warm-up. Returns (session, conf, mix, driver, carriers)."""
    cell = man.cell(workload)
    centry, conf = man.config(cell["config"])
    mix, driver = man.traffic(cell["traffic"])
    with tempfile.TemporaryDirectory(prefix="rxbench-capture-") as tmp:
        jobs = start_captures(man.root, centry["file"], conf["carriers"],
                              seed, tmp)
        try:
            import torch
            from dvbs_tpu_torch.io import native
            from .session import Session
            if not native.available():
                raise RuntimeError("the native TS parser is not built "
                                   "(native/libdvbs_native.so)")
            session = Session(conf, device)
            if torch.device(device).type == "cuda":
                from dvbs_tpu_torch.kernels import build
                build.load()
            carriers = collect_captures(jobs)
        finally:
            for p, _ in jobs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    session.attach(carriers)
    session.warm_up(mix["warmup_blocks"], driver.chunk(session, mix))
    return session, conf, mix, driver, carriers


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             log=sys.stderr, prepare=None) -> dict | None:
    """Run cell `workload` once and return its result line (a dict), or
    None where a module of the JAX package or JAX itself was loaded.
    `prepare(session)`, where given, runs after the set-up (the tests
    plant faults there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = Manifest(root)
    session, conf, mix, driver, carriers = set_up(man, workload, seed, device)
    import torch
    on_card = torch.device(device).type == "cuda"
    if prepare is not None:
        prepare(session)
    span = mix["trace_blocks"] - 2 if trace else mix["sample_span"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    base = len(session.step_j0)
    session.sample_at = {base + int(k) for k in
                         rng.choice(span, SAMPLED_BLOCKS, replace=False)}
    load = HostLoad()
    m0 = session.mark()
    setup_s = m0["t"] - t_start
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if on_card else [])
        session.keep_trials = True
        with profile(activities=acts) as prof:
            with record_function("rxbench.window"):
                win = driver.drive(session, mix, seconds,
                                   max_blocks=mix["trace_blocks"])
                if on_card:
                    torch.cuda.synchronize()
            m1 = session.mark()
            # before the profiler stops: its teardown is not the window's
            host = load.stop(win["t1"] - win["t0"])
        session.keep_trials = False
    else:
        win = driver.drive(session, mix, seconds)
        m1 = session.mark()
        host = load.stop(win["t1"] - win["t0"])
    host.update(host_times(session, m0, m1))
    if on_card:
        torch.cuda.synchronize()
        mem_peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(0)
    else:
        mem_peak, kind = 0, "cpu"
    if refuse_forbidden(log):
        return None

    # ---- the check, after the window --------------------------------
    t_check = time.perf_counter()
    samples = reference.to_host(session.samples)
    tx = reference.Transmitter(conf, carriers)
    outs = reference.ts_outputs(session)
    ts = reference.check_ts(tx, session, outs)
    win["feeds0"], win["feeds1"] = m0["feeds"], m1["feeds"]
    lat = reference.latencies(tx, session, outs, ts["q"], win,
                              win if "sched_t0" in win else None)
    blk = reference.check_blocks(tx, session, samples, conf["n_iters"],
                                 conf["sof_threshold"])
    seen, ok = session.frames()
    checks = dict(
        ts_bad_packets=(ts["ts_bad_packets"], 0),
        frames_failed=(seen - ok, 0),
        window_packets_missing=(int(len(lat) == 0), 0),
        sampled_blocks_missing=(int(len(samples) == 0), 0),
        start_err_max_sym=(blk["start_err_max_sym"],
                           conf["limits"]["start_err_max_sym"]),
        pls_mismatch=(blk["pls_mismatch"], 0),
        llr_sign_err_max=(blk["llr_sign_err_max"],
                          conf["limits"]["llr_sign_err_max"]),
        hard_mismatch_bits=(blk["hard_mismatch_bits"], 0),
        kbch_mismatch_bytes=(blk["kbch_mismatch_bytes"], 0),
        trials_bad=(blk["trials_bad"], 0))
    correct = all(v <= lim for v, lim in checks.values())
    print(f"window {win['t1'] - win['t0']:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=log)
    print(f"sampled frames {blk['sampled_frames']}: PL-sync quality min "
          f"{blk['quality_min']}, under the gate {blk['under_sync_gate']}, "
          f"of which decoded to the frame sent "
          f"{blk['under_sync_gate_decoded']}", file=log)
    for k, bad in enumerate(session.fin_bad):
        if bad.any():
            print(f"block {k} (window blocks from {m0['fins']}): frames "
                  f"failed per carrier {bad.tolist()}", file=log)

    # ---- metrics ------------------------------------------------------
    metrics = {}
    wanted = man.metrics(workload, trace)
    device_info = dict(platform="gpu" if on_card else "cpu", kind=kind,
                       count=1, memory_peak_bytes=int(mem_peak))
    breakdown = None
    if trace:
        from .trace import Trace
        tdir = Path(tempfile.gettempdir()) / "rxbench"
        tdir.mkdir(exist_ok=True)
        tpath = tdir / f"{workload}.trace.json"
        prof.export_chrome_trace(str(tpath))
        tr = Trace(str(tpath))
        ctx = TraceContext(man, tr, session, m0, m1, win, conf)
        for m in wanted:
            read, spec = man.reader(m["name"])
            v = read(ctx, spec)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        if on_card:
            device_info["power_limit"] = power_limit()
        breakdown = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
    else:
        e2e = dict(
            rx_msamples_per_s=(m1["consumed"] - m0["consumed"]) /
            (win["t1"] - win["t0"]) / 1e6, setup_s=setup_s)
        if len(lat):        # without a packet the run is not correct
            e2e["ts_latency_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        for m in wanted:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=float(e2e[m["name"]]),
                                          unit=m["unit"])
    line = dict(correct=bool(correct),
                attempted=int(m1["seen"] - m0["seen"]),
                failed=int((m1["seen"] - m1["ok"]) - (m0["seen"] - m0["ok"])),
                metrics=metrics, device=device_info)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["host"] = host
    line["checks"] = {k: dict(value=float(v), limit=float(lim))
                      for k, (v, lim) in checks.items()}
    # the readers, the work counts and the trace are loaded after the
    # window: what they load counts too
    if refuse_forbidden(log):
        return None
    print(f"host {json.dumps(host)}", file=log)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=log)
    return line
