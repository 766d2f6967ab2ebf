"""Faults planted under a run, to show that the check catches them.

Each is a `prepare(session)` for `harness.run_cell`: it wraps the
stream's step so that the timed path is broken underneath, and the run
must then come out not `correct`. `control` breaks the guarantee
`frames` the configurations state: one decoded frame in every step is
dropped, as the receiver's sync gate does to a frame under it. The
others are the faults a cell of this benchmark can have:

- `state_unchanged`: the step returns its first block's outputs for every
  later block;
- `half_batch`: half of the carriers' frames are left out (their sync
  quality zeroed: the stream drops them);
- `answer_altered`: one byte of one BBFRAME altered where the step
  produces it;
- `llrs_altered`: one frame's LLRs negated where the soft demapper
  produces them (`ops/demap.soft_demap`);
- `starts_altered`: every frame start the step returns moved by 4
  symbols (moved where the locator produces them, no frame decodes, and
  the blocks drawn for the check are never reached).

The step's outputs are changed in place, so the outputs the benchmark
keeps for its check are the ones the stream goes on with; the demapper
is replaced on its module for as long as `planted` is open.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    """Yields the `prepare(session)` that plants fault `name`."""
    from dvbs_tpu_torch.ops import demap
    saved = demap.soft_demap
    if name == "llrs_altered":
        def soft_demap(*a, **k):
            llr = saved(*a, **k)
            llr[0, 0].neg_()
            return llr
        demap.soft_demap = soft_demap
    try:
        yield plant(name)
    finally:
        demap.soft_demap = saved


def plant(name: str):
    def prepare(session):
        st = session.stream
        inner = st.step_fn
        first = {}
        C = session.C

        def step(x):
            out = inner(x)
            if name == "control":
                out["quality"][0, 0] = 0.0
            elif name == "state_unchanged":
                if not first:
                    first.update(out)
                return dict(first)
            elif name == "half_batch":
                out["quality"][C // 2:] = 0.0
            elif name == "answer_altered":
                out["kbch_bytes"][0, 100] ^= 0x5A
            elif name == "starts_altered":
                out["starts"].add_(4)
            elif name != "llrs_altered":
                raise ValueError(f"no fault {name!r}")
            return out
        st.step_fn = step
    return prepare


FAULTS = ("control", "state_unchanged", "half_batch", "answer_altered",
          "llrs_altered", "starts_altered")
