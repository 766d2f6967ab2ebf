"""The host's frame decision over B frame lanes, one rule set for the
single-carrier receiver (models/dvbs2, models/driver) and the bank
(models/bank_stream). The callers fetch and open their spans.
"""
from __future__ import annotations

import numpy as np

from ..ops.plsync import DUMMY_LEN
from ..spec import bch_spec, scrambling

FRAME_TOL = 12      # symbols of start jitter before a gap is marked
MAX_DUMMIES = 3     # consecutive dummies absorbed without a gap
DUMMY_CONF = 0.5    # under the vote's: all-dummy blocks lose the freq anchor
VOTE_CONF = 0.7
VOTE_FRAMES = 50    # the auto-MODCOD vote's window (main.cpp:383-408)


def to_host(out: dict):
    """(the outputs but the hard bits, as numpy; the hard bits as they
    are, for the BCH repair to fetch the rows it needs)."""
    hard = out.pop("hard")
    return {k: v.cpu().numpy() for k, v in out.items()}, hard


def gate(quality: np.ndarray, threshold: float) -> np.ndarray:
    """The sync gate: lanes under the PL-sync threshold are noise,
    neither rerun, repaired nor parsed."""
    return quality >= threshold


def escalate(out: dict, sync: np.ndarray, budget: int, rerun):
    """Gated lanes of `out` whose LDPC did not converge take the verdict,
    bytes and trials (plus `budget`, the first pass's) of `rerun()`: the
    full-budget decode of every lane, through to_host. Returns (the
    rerun lanes, the rerun's hard bits or None)."""
    retry = (~out["ldpc_ok"]) & sync
    if not retry.any():
        return retry, None
    out2, hard2 = rerun()
    for k in ("ldpc_ok", "bch_bad", "kbch_bytes"):
        out[k] = np.where(retry.reshape((-1,) + (1,) * (out[k].ndim - 1)),
                          out2[k], out[k])
    out["trials"] = np.where(retry, budget + out2["trials"], out["trials"])
    return retry, hard2


def bch_repair(cfg, sync: np.ndarray, out: dict, row):
    """Host BCH of the gated lanes `out["bch_bad"]` flags, the nbch hard
    bits of each (of no other lane) from `row(lane)`. Returns frame_ok,
    the bytes (`out["kbch_bytes"]` with the repaired lanes' own) and the
    corrections (0 clean, -1 under the gate or failed). A lane still
    BCH-inconsistent is a wrong LDPC codeword whose garbage BBHEADER
    would desync the TS parser: rejected, the parser marks a gap."""
    frame_ok = sync & ~out["bch_bad"]
    plain = np.array(out["kbch_bytes"])
    corr = np.full(len(sync), -1, np.int32)
    corr[frame_ok] = 0
    for f in np.nonzero(sync & out["bch_bad"])[0]:
        fixed, corr[f] = bch_spec.decode(row(f), cfg.framesize, cfg.rate)
        if corr[f] >= 0:
            frame_ok[f] = True
            plain[f] = scrambling.bb_scramble_bytes(
                np.packbits(fixed[:cfg.kbch]))
    return frame_ok, plain, corr


def continuous(d: int, L: int) -> bool:
    """Good frames `d` symbols apart hold one data frame of L symbols and
    up to MAX_DUMMIES dummy PLFRAMEs (no data bytes) between them."""
    return any(abs(d - L - k * DUMMY_LEN) <= FRAME_TOL
               for k in range(MAX_DUMMIES + 1))


def is_dummy(pls, conf) -> bool:
    """A slot confidently detected as a dummy PLFRAME (MODCOD 0)."""
    return int(pls) >> 2 == 0 and conf >= DUMMY_CONF


def admits_vote(pls, conf) -> bool:
    """A confident detection votes; a dummy PLFRAME (idle filler, not a
    signal configuration) neither wins nor dilutes the vote."""
    return conf >= VOTE_CONF and int(pls) >> 2 != 0


def supermajority(n: int) -> int:
    """Votes of n a PLS code needs to switch the MODCOD: 90%."""
    return int(0.9 * n + 0.5)
