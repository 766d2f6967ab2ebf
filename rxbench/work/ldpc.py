"""The `ldpc` range: layered offset min-sum decoding of every frame of a
step and of each escalation rerun, from float LLRs to hard bits.

Each frame counts its own sweeps (`trials`, as the step and the
escalation return them) times the edges of its code's parity-check
graph (info edges from the standard's address table, plus the 2 (N - K)
- 1 edges of the accumulator), times OPS_PER_EDGE operations per edge a
sweep: the extrinsic (posterior minus old message, 1), its magnitude and
sign (2), the running first and second minimum (2), the choice of the
minimum that excludes the edge (1), the offset and its clamp at 0 (2),
the sign applied (1), the new posterior (1): 10.

Bytes: the float32 LLRs in and the hard bits out (one byte a bit), per
frame of each decode call."""
from __future__ import annotations

import functools

from rxbench.txref import ldpc_spec

OPS_PER_EDGE = 10


@functools.lru_cache()
def edges(table: str) -> int:
    code = ldpc_spec.get_code(table)
    return int((code.info_addr >= 0).sum()) + 2 * code.R - 1


def work(ctx):
    cfg = ctx.cfg
    sweeps = sum(float(t.sum()) for t in ctx.trials)
    ops = sweeps * edges(cfg.ldpc_table) * OPS_PER_EDGE
    frames = sum(t.size for t in ctx.trials)
    nbytes = frames * cfg.nldpc * (4 + 1)
    return ops / ctx.steps, nbytes / ctx.steps
