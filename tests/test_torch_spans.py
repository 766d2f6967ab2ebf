"""The port's span primitive (profiling.span) and the bank stream's
spans and counters, on the CPU; no JAX.

- off (no profiler recording): a span opens no profiler range, holds no
  more garbage-collected objects while open than a bare context manager
  and none after, and times into its stats;
- on: a span is a profiler range of its name, closed on exit even where
  the profiler stopped meanwhile;
- under profiling.device_trace, a 2-carrier bank's Chrome trace holds
  every `bank.*` span nested as bank_stream.py lists them, `resample`
  inside `timing`, and the layers' ranges under their names;
- the bank's TS bytes are the same with a profiler recording and
  without;
- the bank's stats count blocks, frames, samples, FIFO bytes, uploaded
  bytes and turns consistently with what was fed;
- the early fetch: one `bank.prefetch` a dispatched step, inside
  `bank.feed` and apart from `bank.step` and `bank.finalize`; the
  stats' `fetches` and `fetch_ready` and their line of the report;
- the CLI's `--control` command `metrics` prints a bank's numbers (the
  DVB-S2 bank's stats report, the DVB-S bank's lock and BER).

Tolerance: exact (counts, bytes and names).
"""
import gc
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from dvbs_tpu_torch import cli, profiling
from dvbs_tpu_torch.io import source
from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
from dvbs_tpu_torch.ops.frontend import pack_cs4
from dvbs_tpu_torch.parallel import mesh
from dvbs_tpu_torch.spec import modcod
from dvbs_tpu_torch.tx import channel, dvbs2_mod

torch.set_num_threads(2)

MC, SHORT, C = 4, True, 2
CFG = modcod.get_config(MC, short=SHORT)
BLOCK = mesh.bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
N = 2 * BLOCK
FINALIZE_CHILDREN = ("bank.fetch", "bank.escalate", "bank.bch_repair",
                     "bank.parse", "bank.vote")
LAYERS = ("frontend", "timing", "plsync", "phase", "demap", "ldpc",
          "bch_pack")


class _Bare:
    """The least a context manager holds while open (the `with`
    statement's bound __exit__)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _held(make) -> int:
    """Garbage-collected objects alive inside two nested `with`s."""
    before = gc.get_count()[0]
    with make():
        with make():
            inside = gc.get_count()[0]
    assert gc.get_count()[0] == before
    return inside - before


class _RecordFunctionCount:
    def __init__(self, real):
        self.real, self.n = real, 0

    def __call__(self, name):
        self.n += 1
        return self.real(name)


@pytest.mark.parametrize("with_stats", [False, True])
def test_span_off_opens_no_range_and_allocates_nothing(monkeypatch,
                                                       with_stats):
    count = _RecordFunctionCount(profiling.record_function)
    monkeypatch.setattr(profiling, "record_function", count)
    st = profiling.PipelineStats() if with_stats else None
    with profiling.span("x", st):      # makes the stats' timer of "x"
        pass
    bare = _Bare()
    gc.disable()
    try:
        floor = _held(lambda: bare)
        for _ in range(1000):           # "x" nests in itself
            assert _held(lambda: profiling.span("x", st)) == floor
    finally:
        gc.enable()
    assert count.n == 0
    if with_stats:
        with profiling.span("sleep", st):
            time.sleep(0.002)
        total, calls = st.stages["x"]
        assert calls == 2001 and total > 0
        assert st.stages["sleep"][0] >= 0.002
        assert "stage x" in st.report()


def test_span_on_is_a_range_closed_after_the_profiler_stops():
    from torch.profiler import ProfilerActivity, profile
    st = profiling.PipelineStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("inner.on", st):
            torch.ones(4).sum()
        late = profiling.span("late", st)
        late.__enter__()
    late.__exit__(None, None, None)          # the profiler has stopped
    names = {e.key for e in prof.key_averages()}
    assert "inner.on" in names and "late" in names
    assert st.stages["inner.on"][1] == 1 and st.stages["late"][1] == 1


def _carrier(seed, cfo, delay):
    pkts = dvbs2_mod.random_ts_packets(150, seed=seed)
    bb = dvbs2_mod.ts_to_bbframes(pkts, CFG)
    tx = dvbs2_mod.bbframes_to_plframes(bb, CFG).reshape(-1)
    y = channel.impair(channel.shape(tx, sps=2), snr_db=6.0, cfo=cfo,
                       delay_samples=delay, sco_ppm=10.0, seed=seed + 1)
    return pack_cs4(y)


@pytest.fixture(scope="module")
def signals():
    a = _carrier(31, 0.006 * np.pi, 0.3)
    b = _carrier(47, -0.011 * np.pi, 0.7)
    F = (BLOCK - 2 * 256 - 90) // CFG.plframe_len - 1
    n = N + 3 * 2 * F * CFG.plframe_len + 2 * CFG.plframe_len
    return [a[:n], b[:n]]


def _run(sigs, n_iters=12):
    """A fresh bank stream fed the signals in half-block chunks; returns
    (stream, TS bytes per carrier, feed calls)."""
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                         fec="xla", ingest="cs4", n_iters=n_iters,
                         device="cpu")
    outs = [bytearray() for _ in range(C)]
    lo, calls = 0, 0
    while lo < len(sigs[0]):
        e = min(lo + N // 2, len(sigs[0]))
        for c, o in zip(st.feed([s[lo:e] for s in sigs]), outs):
            o.extend(c)
        lo, calls = e, calls + 1
    return st, [bytes(o) for o in outs], calls


@pytest.fixture(scope="module")
def traced(signals, tmp_path_factory):
    """The bank streamed under device_trace, at 1 sweep a step so that
    blocks escalate: (stream, TS bytes, feed calls, Chrome trace
    events)."""
    path = tmp_path_factory.mktemp("trace") / "bank.json"
    with profiling.device_trace(str(path)):
        st, ts, calls = _run(signals, n_iters=1)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return st, ts, calls, ev


def _spans(ev, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in ev if e["name"] == name]


def _inside(inner, outer):
    """Every span of `inner` lies inside some span of `outer`."""
    return all(any(a0 <= a and b <= b0 for a0, b0 in outer)
               for a, b in inner)


def _apart(one, other):
    """No span of `one` overlaps a span of `other`."""
    return not any(a < b0 and a0 < b for a, b in one for a0, b0 in other)


def test_bank_spans_nest_in_the_trace(traced):
    st, _, calls, ev = traced
    feeds = _spans(ev, "bank.feed")
    assert len(feeds) == calls
    for name in ("bank.fifo", "bank.upload", "bank.step", "bank.finalize"):
        assert _spans(ev, name), name
        assert _inside(_spans(ev, name), feeds), name
    fins = _spans(ev, "bank.finalize")
    assert len(fins) == st.stats.blocks
    assert st.stats.escalations > 0
    for name in FINALIZE_CHILDREN:
        assert _spans(ev, name), name
        assert _inside(_spans(ev, name), fins), name
    assert len(_spans(ev, "bank.fetch")) == len(fins)
    steps = _spans(ev, "bank.step")
    assert len(steps) == st._dispatched
    for name in LAYERS[:-2]:
        assert _inside(_spans(ev, name), steps), name
    for name in LAYERS[-2:]:            # the step's FEC and the escalation's
        assert _spans(ev, name), name
    assert _spans(ev, "resample")
    assert _inside(_spans(ev, "resample"), _spans(ev, "timing"))


def test_bank_prefetch_span_apart_from_step_and_finalize(traced):
    """The copies of a step's small outputs are queued under their own
    span, one a dispatched step, inside `bank.feed` and outside the
    step's and the finalize's spans (which keep counting their own
    work); `bank.fetch` stays one a block, inside `bank.finalize`."""
    st, _, _, ev = traced
    pre = _spans(ev, "bank.prefetch")
    assert len(pre) == st._dispatched == st.stats.fetches
    assert _inside(pre, _spans(ev, "bank.feed"))
    for name in ("bank.step", "bank.finalize"):
        assert _apart(pre, _spans(ev, name)), name
    fins = _spans(ev, "bank.finalize")
    fetch = _spans(ev, "bank.fetch")
    assert len(fetch) == len(fins) == st.stats.blocks
    assert _inside(fetch, fins)


def test_bank_ts_same_with_and_without_a_profiler(signals, traced):
    _, ts_off, _ = _run(signals, n_iters=1)
    assert ts_off == traced[1]
    assert all(len(t) > 0 for t in ts_off)


def test_bank_stats_count_what_was_fed(signals):
    st, ts, calls = _run(signals)
    s = st.stats
    F = st.F
    assert s.blocks >= 3 and s.blocks == len(s.turns)
    assert [b for b, _ in s.turns] == list(range(s.blocks))
    assert all(ns > 0 for _, ns in s.turns)
    assert s.frames_seen == C * F * s.blocks == st.frames_seen.sum()
    assert s.frames_ok == st.frames_ok.sum() == s.frames_seen
    assert sum(s.trial_hist.values()) == s.frames_seen
    assert s.ts_bytes_out == sum(len(t) for t in ts)
    assert s.samples_in == C * len(signals[0])
    # cs4 bytes: one a sample; every dispatched block stacked, uploaded
    assert s.upload_bytes == st._dispatched * C * N
    assert s.fifo_bytes >= s.upload_bytes + s.samples_in
    assert s.escalations == 0 and s.bch_repaired == 0
    stages = s.stages
    assert stages["bank.feed"][1] == calls
    assert stages["bank.finalize"][1] == s.blocks
    assert stages["bank.step"][1] == stages["bank.upload"][1] == \
        st._dispatched
    rep = s.report()
    for name in ("bank.feed", "bank.fifo", "bank.upload", "bank.step",
                 "bank.finalize", "bank.fetch", "bank.parse", "bank.vote"):
        assert f"stage {name}" in rep
    assert "turn ms" in rep and "fifo bytes" in rep


def test_bank_counts_its_early_fetches(signals):
    """`fetches` counts every dispatched step; `fetch_ready` the blocks
    whose copies had completed when their finalize began, at most one a
    block, and on the CPU (copies made at once, no event) every block;
    the report prints both."""
    st, _, _ = _run(signals)
    s = st.stats
    assert s.fetches == st._dispatched == s.stages["bank.prefetch"][1]
    assert s.fetch_ready <= s.blocks
    assert s.fetch_ready == s.blocks
    rep = s.report()
    assert f"fetches {s.fetches}  fetch_ready {s.fetch_ready}" in rep
    assert "stage bank.prefetch" in rep


def _stdin_with(monkeypatch, text: str):
    """A real pipe as stdin (select() needs a file descriptor)."""
    r, w = os.pipe()
    os.write(w, text.encode())
    os.close(w)
    monkeypatch.setattr(sys, "stdin", os.fdopen(r, "r"))


@pytest.mark.parametrize("mode", [
    ["--mode", "s2", "--modcod", "4", "--framesize", "short",
     "--block-symbols", "16384", "--fec", "pallas"],
    ["--mode", "s", "--rate", "1/2", "--block-symbols", "8192"]],
    ids=["dvbs2_bank", "dvbs_bank"])
def test_control_metrics_on_a_bank(tmp_path, capsys, monkeypatch, mode):
    """`metrics` through --control on a two-carrier bank prints the
    bank's numbers instead of failing."""
    iq = str(tmp_path / "z.cf32")
    rng = np.random.default_rng(3)
    source.write_iq_file(iq, (rng.normal(size=60000) + 1j * rng.normal(
        size=60000)).astype(np.complex64))
    _stdin_with(monkeypatch, "metrics\n")
    assert cli.main(["--iq", iq, "--control", "--samplerate", "4e6",
                     "--symbolrate", "1e6", "--offset=-1e6", "--carrier",
                     "1e6:1e6", "--device", "cpu"] + mode) == 0
    err = capsys.readouterr().err
    assert "bad command" not in err
    if mode[1] == "s2":
        assert "control: blocks " in err and "fifo bytes" in err
    else:
        assert "control: dvbs bank lock=" in err
