"""CUDA-graph capture of the bank step (dvbs_tpu_torch/graphs.py,
parallel/mesh.CarrierBank) on the CPU, no JAX; the capture calls are
stubbed (the card's tests are in test_torch_cuda.py):

- a CPU input runs eagerly: no capture is tried, `eager_steps` counts
  every call, and the bank stream's stats report prints the three
  counters;
- the segment recorder cuts a capture at every span edge of the bank's
  `enqueue`: its spans are the eager step's, entered and left in the
  same order, with one graph before, between and after the edges; a
  replay opens the same spans again in the same order with each graph
  inside its own, and adds the launch counts its capture took back out;
  a graph that captured nothing (torch warns) is left out, and only
  that warning is held back;
- a capture that raises ends its open graph and leaves the launch
  counts and the span hook as they were;
- outside a capture `span` returns what it did before the hook (the
  shared no-op, the stats' timer).

Tolerance: exact (names, order, counts).
"""
import warnings

import numpy as np
import pytest
import torch

from dvbs_tpu_torch import backend, graphs, profiling
from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
from dvbs_tpu_torch.parallel import mesh

torch.set_num_threads(2)

MC, SHORT, C = 4, True, 2
BLOCK = mesh.bank_block_symbols(C, mc=MC, short=SHORT, frames_total=4)
N = 2 * BLOCK
LAYERS = ("frontend", "timing", "resample", "plsync", "phase", "demap",
          "ldpc", "bch_pack")


class FakeGraph:
    """A CUDA graph's capture calls, logged; a replay logs its number.
    With `warn_empty`, a capture during which backend.LAUNCHES did not
    move ends with torch's warning for a graph that captured nothing."""

    def __init__(self, log, warn_empty=False):
        self.log, self.i, self.state = log, None, "new"
        self.warn_empty = warn_empty

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert self.state == "new" and capture_error_mode == "thread_local"
        self.state = "capturing"
        self.launches = dict(backend.LAUNCHES)

    def capture_end(self):
        assert self.state == "capturing"
        self.state = "captured"
        warnings.warn("an unrelated warning")
        if self.warn_empty and backend.LAUNCHES == self.launches:
            warnings.warn(graphs.EMPTY + ". This usually means ...")

    def replay(self):
        assert self.state == "captured"
        self.log.append(("graph", self.i))


class LogSpan:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def __enter__(self):
        self.log.append(("enter", self.name))
        return self

    def __exit__(self, *exc):
        self.log.append(("exit", self.name))


def _logged(log):
    """A span hook that logs each span's entry and exit."""
    return profiling.capturing(lambda name, stats: LogSpan(log, name))


def _recorded(rec) -> list:
    """The recorder's events as ("enter"|"exit", name) and ("graph", i),
    numbering the graphs in capture order."""
    seq, names = [], []
    for kind, arg in rec.events:
        if kind == graphs._GRAPH:
            arg[0].i = sum(e[0] == "graph" for e in seq)
            seq.append(("graph", arg[0].i))
        elif kind == graphs._ENTER:
            names.append(arg[0])
            seq.append(("enter", arg[0]))
        else:
            seq.append(("exit", names.pop()))
    return seq


def _recorder(log, warn_empty=False):
    return graphs.SegmentRecorder(lambda: FakeGraph(log, warn_empty))


@pytest.fixture(scope="module")
def bank():
    step, _, _ = mesh.build_carrier_bank(
        C, mc=MC, short=SHORT, block_symbols=BLOCK, fec="xla", n_iters=2,
        ingest="cs4", stream_outputs=True, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (C, N), dtype=np.uint8))
    return step, x


def test_cpu_step_is_eager_and_counted(bank, monkeypatch):
    step, x = bank

    def no_capture(*a, **k):
        raise AssertionError("a capture was tried on a CPU input")
    monkeypatch.setattr(graphs, "StepGraph", no_capture)
    n0 = step.counts["eager_steps"]
    with torch.no_grad():
        outs = [step(x) for _ in range(3)]
    assert step.counts["eager_steps"] == n0 + 3
    assert step.counts["graph_captures"] == step.counts["graph_replays"] == 0
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[2][k]), k


def test_recorder_cuts_at_the_eager_steps_spans(bank):
    step, x = bank
    eager = []
    with torch.no_grad(), _logged(eager):
        step.enqueue(x)
    assert [n for k, n in eager if k == "enter"].count("frontend") == 2
    assert set(LAYERS) <= {n for _, n in eager}
    assert eager.index(("enter", "resample")) > eager.index(
        ("enter", "timing")) and eager.index(("exit", "resample")) < \
        eager.index(("exit", "timing"))

    log = []
    rec = _recorder(log)
    with torch.no_grad(), pytest.warns(UserWarning, match="unrelated"):
        out = rec.record(step.enqueue, x)
    assert profiling._capture is None
    seq = _recorded(rec)
    assert [e for e in seq if e[0] != "graph"] == eager
    # a graph before the first edge, between each two and after the last
    assert [e[0] == "graph" for e in seq] == \
        [i % 2 == 0 for i in range(2 * len(eager) + 1)]
    assert all(g.state == "captured" for kind, (g, *_) in
               [e for e in rec.events if e[0] == graphs._GRAPH])
    assert set(out) == {"kbch_bytes", "trials", "ldpc_ok", "bch_bad", "hard",
                        "quality", "pls", "pls_conf", "starts", "cfo",
                        "freq", "llrs"}

    with _logged(log):
        graphs.replay(rec.events)
    assert log == seq


def _fake_step(x):
    backend.LAUNCHES["resample_farrow"] += 1
    with profiling.span("a"):
        backend.LAUNCHES["soft_demap"] += 2
        with profiling.span("b"):
            backend.LAUNCHES["ldpc_layered"] += 1
        if x is None:
            raise ValueError("planted")
    return {"y": torch.ones(1)}


@pytest.mark.parametrize("warn_empty", [False, True])
def test_replay_adds_each_graphs_launch_counts(warn_empty):
    """Each graph's launch counts, added by every replay; with torch's
    warning for a graph that captured nothing, such graphs are left out
    and the warning is not passed on (the others are)."""
    before = dict(backend.LAUNCHES)
    log = []
    rec = _recorder(log, warn_empty)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec.record(_fake_step, 1)
    assert [str(w.message) for w in caught] == ["an unrelated warning"] * 5
    assert backend.LAUNCHES == before
    counts = [(("resample_farrow", 1),), (("soft_demap", 2),),
              (("ldpc_layered", 1),)] + ([] if warn_empty else [(), ()])
    assert [a[1] for k, a in rec.events if k == graphs._GRAPH] == counts
    assert len(rec.graphs) == 5         # the empty ones kept: the pool's
    assert [k for k, _ in rec.events].count(graphs._ENTER) == 2
    for n in (1, 2):
        graphs.replay(rec.events)
        assert backend.LAUNCHES == dict(
            before, resample_farrow=before["resample_farrow"] + n,
            soft_demap=before["soft_demap"] + 2 * n,
            ldpc_layered=before["ldpc_layered"] + n)


def test_failed_capture_raises_and_restores():
    before = dict(backend.LAUNCHES)
    log = []
    rec = _recorder(log)
    with pytest.raises(ValueError, match="planted"), \
            pytest.warns(UserWarning, match="unrelated"):
        rec.record(_fake_step, None)
    assert backend.LAUNCHES == before
    assert profiling._capture is None
    assert rec._graph.state == "captured"       # its capture was ended
    with profiling.capturing(rec.span):         # the hook can be set again
        pass
    with pytest.raises(RuntimeError, match="already"):
        with profiling.capturing(rec.span), profiling.capturing(rec.span):
            pass
    assert profiling._capture is None


def test_span_outside_a_capture_is_unchanged():
    st = profiling.PipelineStats()
    assert profiling._capture is None
    assert profiling.span("x") is profiling._NULL
    with profiling.span("x", st):
        pass
    assert profiling.span("x", st) is st._timers["x"]
    assert profiling.open_span("x", st) is st._timers["x"]
    assert profiling.open_span("x") is profiling._NULL


def test_stream_report_prints_the_graph_counters():
    st = DVBS2BankStream(C, mc=MC, short=SHORT, block_symbols=BLOCK,
                         fec="xla", ingest="cs4", n_iters=2, device="cpu")
    sig = np.random.default_rng(9).integers(0, 256, (C, 3 * N),
                                            dtype=np.uint8)
    for lo in range(0, sig.shape[1], N // 2):
        st.feed(list(sig[:, lo:lo + N // 2]))
    assert st._dispatched >= 2
    assert st.stats.step_counts == [st.step_fn.counts]
    rep = st.stats.report()
    assert (f"graph_captures 0  graph_replays 0  eager_steps "
            f"{st._dispatched}") in rep
