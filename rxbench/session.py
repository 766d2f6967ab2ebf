"""One receiver under test and the bookkeeping around it.

`Session` holds the program's streaming entry, `DVBS2BankStream`, built
as the configuration states, and the periodic captures it is fed from.
It wraps the stream's calls on the instance (nothing in the program is
edited) to record, for every call, what the benchmark needs afterwards:

- `feed`: the wall time it was handed its samples and returned, the
  samples it was given, and the TS bytes it returned per carrier;
- `step_fn`: the host time of each call (the enqueue), and where in each
  carrier's endless stream the block it was given starts; the outputs of
  the blocks drawn for the check are kept;
- `_finalize`: its host time and the frames each block failed;
  `_escalate`: the sweeps of each escalation.

Each wrapper also opens a profiler range of its name, which a traced run
reads (`bank_stream.feed`, `step_fn`, `bank_stream._finalize`,
`bank_stream._escalate`).
"""
from __future__ import annotations

import time

import numpy as np


class Session:
    def __init__(self, conf: dict, device):
        import torch
        from torch.profiler import record_function
        from dvbs_tpu_torch.models.bank_stream import DVBS2BankStream
        from dvbs_tpu_torch.parallel.mesh import bank_block_symbols
        self.torch = torch
        self.rf = record_function
        self.C = conf["carriers"]
        self.pos = 0                 # read position within the period
        self.fed = 0                 # samples handed to each carrier
        short = conf["framesize"] == "short"
        self.stream = DVBS2BankStream(
            self.C, mc=conf["modcod"], short=short, pilots=conf["pilots"],
            block_symbols=bank_block_symbols(
                self.C, mc=conf["modcod"], short=short, pilots=conf["pilots"],
                frames_total=conf["frames_per_step"]),
            fec=conf["fec"], ingest=conf["ingest"],
            n_iters=conf["n_iters"], max_ldpc_trials=conf["max_ldpc_trials"],
            sof_threshold=conf["sof_threshold"], device=device)
        if self.stream.F * self.C != conf["frames_per_step"]:
            raise ValueError(f"bank decodes {self.stream.F * self.C} frames "
                             f"a step, configuration states "
                             f"{conf['frames_per_step']}")
        self.block = 2 * self.stream.block_symbols      # samples a step
        # feed records: call time, return time, samples before, samples
        self.t_call, self.t_ret, self.fed_before, self.n_fed = [], [], [], []
        self.ts = [[] for _ in range(self.C)]           # bytes per call
        self.step_s, self.step_j0 = [], []
        self.fin_s, self.esc_trials = [], []
        self.fin_bad = []            # frames failed per carrier a block
        self.step_trials = []        # kept while `keep_trials` is set
        self.keep_trials = False
        self.sample_at = set()       # step ordinals whose outputs are kept
        self.samples = {}
        self._wrap()

    def attach(self, carriers: list) -> None:
        """The carriers' periodic captures (capture.make_carrier)."""
        self.P = int(carriers[0]["P"])
        if len(carriers) != self.C or any(int(c["P"]) != self.P
                                          for c in carriers):
            raise ValueError("one capture a carrier, of one period length")
        # two periods back to back: any chunk up to P is one slice
        self.caps2 = [np.concatenate([c["capture"], c["capture"]])
                      for c in carriers]

    # ------------------------------------------------------------------
    def _wrap(self):
        st = self.stream
        step, fin, esc = st.step_fn, st._finalize, st._escalate

        def step_fn(x):
            ahead = st._pending is not None
            j0 = np.array([self.fed - len(f) +
                           (int(st._next_adv[c]) if ahead else 0)
                           for c, f in enumerate(st._fifos)], np.int64)
            t0 = time.perf_counter()
            with self.rf("step_fn"):
                out = step(x)
            self.step_s.append(time.perf_counter() - t0)
            k = len(self.step_j0)
            self.step_j0.append(j0)
            if self.keep_trials:
                self.step_trials.append(out["trials"])
            if k in self.sample_at:
                self.samples[k] = dict(out=dict(out), j0=j0)
            return out

        def finalize(dev, outs):
            bad0 = st.frames_seen - st.frames_ok
            t0 = time.perf_counter()
            with self.rf("bank_stream._finalize"):
                r = fin(dev, outs)
            self.fin_s.append(time.perf_counter() - t0)
            self.fin_bad.append(st.frames_seen - st.frames_ok - bad0)
            return r

        def escalate(llrs):
            with self.rf("bank_stream._escalate"):
                out = esc(llrs)
            self.esc_trials.append(out["trials"])
            return out

        st.step_fn, st._finalize, st._escalate = step_fn, finalize, escalate
        self._escalate_plain = esc

    # ------------------------------------------------------------------
    def feed(self, n: int) -> None:
        """Hand the next n samples of every carrier to the stream."""
        while n > 0:
            k = min(n, self.P)
            parts = [c2[self.pos:self.pos + k] for c2 in self.caps2]
            self.fed_before.append(self.fed)
            self.n_fed.append(k)
            self.fed += k
            self.pos = (self.pos + k) % self.P
            t0 = time.perf_counter()
            with self.rf("bank_stream.feed"):
                outs = self.stream.feed(parts)
            t1 = time.perf_counter()
            self.t_call.append(t0)
            self.t_ret.append(t1)
            for c in range(self.C):
                self.ts[c].append(outs[c])
            n -= k

    def consumed(self) -> int:
        """Samples the stream has consumed, summed over carriers: fed,
        less what still waits in its FIFOs."""
        return sum(self.fed - len(f) for f in self.stream._fifos)

    def frames(self) -> tuple:
        """(frames seen, frames decoded), summed over carriers."""
        return (int(self.stream.frames_seen.sum()),
                int(self.stream.frames_ok.sum()))

    def warm_up(self, blocks: int, chunk: int) -> None:
        """Feed closed loop until `blocks` blocks are finalized, then run
        the escalation once on a block's LLRs, as a failing frame would:
        every shape and path of the window is then warm."""
        while len(self.fin_s) < blocks:
            self.feed(chunk)
        self.sample_at.add(len(self.step_j0))
        self.feed(chunk)
        while not self.samples:
            self.feed(chunk)
        llrs = self.samples.pop(min(self.samples))["out"]["llrs"]
        self.sample_at.clear()
        self._escalate_plain(llrs)
        if llrs.is_cuda:
            self.torch.cuda.synchronize()

    def mark(self) -> dict:
        """Counters at a point in the run (the window's start or end)."""
        seen, ok = self.frames()
        return dict(t=time.perf_counter(), feeds=len(self.t_call),
                    steps=len(self.step_j0), fins=len(self.fin_s),
                    escs=len(self.esc_trials), consumed=self.consumed(),
                    seen=seen, ok=ok)
