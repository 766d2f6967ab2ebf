"""The plain reference: what the receiver must have produced, worked out
from the benchmark's own transmitter (capture.py, txref/), and the
comparisons that decide `correct`.

It reads the program's outputs only to judge them, and imports nothing of
the program. Three guarantees the configurations state are held:

- `ts`: every carrier's TS, over the whole run, is one byte-exact
  contiguous run of the periodic packet sequence sent;
- `frames`: every PL frame the stream took in was decoded;
- `located`: on blocks drawn from the seed, each frame the step returned
  is a frame sent, at the position it was sent at (`starts`, within
  `start_err_max_sym` symbols), with the PLS code sent (`pls`), its LLRs'
  signs agreeing with the codeword sent but for the channel's errors
  (`llrs`), and, where the step says the LDPC converged, the codeword
  sent bit for bit (`hard`), in 1..n_iters sweeps (`trials`), and the
  BBFRAME sent byte for byte (`kbch_bytes`).
"""
from __future__ import annotations

import numpy as np

from .capture import TS, modcod_config, period_geometry

class Transmitter:
    """Per-carrier record of the periodic signal sent."""

    def __init__(self, conf: dict, carriers: list):
        self.cfg = modcod_config(conf)
        self.geo = period_geometry(self.cfg)
        self.L = self.cfg.plframe_len
        self.carriers = carriers
        self.index = [{p.tobytes(): i for i, p in enumerate(c["packets"])}
                      for c in carriers]

    def last_sample(self, c: int, q: np.ndarray) -> np.ndarray:
        """The received sample (index in carrier c's endless stream) that
        completes the PL frame carrying the last byte of packet q (index
        in the endless packet sequence)."""
        car = self.carriers[c]
        f = (TS * q + TS - 1) // self.geo["dfb"]
        m = (f + 1) * self.L - 1                       # its last symbol
        return np.ceil((2.0 * m - car["delay"]) / car["ratio"]).astype(np.int64)

    def packet_run(self, c: int, got: np.ndarray) -> tuple:
        """(index in the period of got's first packet or -1, packets of got
        [n, 188] that differ from the contiguous run from there)."""
        if len(got) == 0:
            return 0, 0
        sent = self.carriers[c]["packets"]
        i0 = self.index[c].get(got[0].tobytes(), -1)
        if i0 < 0:
            return -1, len(got)
        idx = (i0 + np.arange(len(got))) % len(sent)
        return i0, int(np.any(got != sent[idx], axis=1).sum())


def ts_outputs(session) -> list:
    """Per carrier: packets [n, 188] over the whole run, and the feed call
    that returned each."""
    res = []
    for c in range(session.C):
        sizes = np.array([len(b) for b in session.ts[c]], np.int64)
        got = np.frombuffer(b"".join(session.ts[c]), np.uint8)
        ragged = len(got) % TS
        call = np.repeat(np.arange(len(sizes)), sizes // TS)
        res.append(dict(packets=got[:len(got) - ragged].reshape(-1, TS),
                        call=call, ragged=ragged))
    return res


def first_packet_index(tx: Transmitter, session, c: int, i0: int,
                       call: int) -> int:
    """Index in the endless sequence of carrier c's first packet out, whose
    content is packet i0 of the period and which feed call `call`
    returned: the latest repeat of i0 whose frame had been fed by then."""
    n = tx.geo["packets"]
    fed = session.fed_before[call] + session.n_fed[call]
    q = i0
    while tx.last_sample(c, np.array([q + n]))[0] <= fed:
        q += n
    return q


def check_ts(tx: Transmitter, session, outs: list) -> dict:
    """TS contiguity over the whole run, and each packet's index in the
    endless sequence (for the latency)."""
    bad = 0
    qs = []
    for c, o in enumerate(outs):
        i0, nbad = tx.packet_run(c, o["packets"])
        bad += nbad + (o["ragged"] > 0)
        if len(o["packets"]) == 0:
            qs.append(np.zeros(0, np.int64))
            continue
        q0 = first_packet_index(tx, session, c, max(i0, 0), int(o["call"][0]))
        qs.append(q0 + np.arange(len(o["packets"])))
    return dict(ts_bad_packets=bad, q=qs)


def latencies(tx: Transmitter, session, outs: list, qs: list, win: dict,
              sched: dict | None) -> np.ndarray:
    """Seconds from due to out for every packet a feed call returned
    inside the window, all carriers. A sample is due when it was handed
    to `feed`, or on a schedule at its time there."""
    fed_end = np.array(session.fed_before, np.int64) + \
        np.array(session.n_fed, np.int64)
    t_call = np.array(session.t_call)
    t_ret = np.array(session.t_ret)
    lat = []
    for c, o in enumerate(outs):
        if len(o["packets"]) == 0:
            continue
        call = o["call"]
        inside = (call >= win["feeds0"]) & (call < win["feeds1"])
        j = tx.last_sample(c, qs[c][inside])
        k = np.minimum(np.searchsorted(fed_end, j, side="right"),
                       len(fed_end) - 1)
        due = t_call[k]
        if sched is not None:
            on = j >= sched["sched_j0"]
            due = np.where(on, sched["sched_t0"] +
                           (j - sched["sched_j0"] + 1) / sched["rate"], due)
        lat.append(t_ret[call[inside]] - due)
    return np.concatenate(lat) if lat else np.zeros(0)


def check_blocks(tx: Transmitter, session, samples: dict, n_iters: int,
                 gate: float = 0.6) -> dict:
    """The sampled blocks' outputs against the frames sent. Beside the
    numbers compared: the least PL-sync quality, the frames under the
    sync gate `gate`, and how many of those decoded to the BBFRAME sent."""
    cfg = tx.cfg
    L = tx.L
    NF = tx.geo["frames"]
    C = session.C
    start_err = 0.0
    llr_err = 0.0
    pls_bad = hard_bad = kbch_bad = trials_bad = 0
    frames = under = under_right = 0
    qmin = np.inf
    for s in samples.values():
        o = s["out"]
        starts = o["starts"]                          # [C, F]
        F = starts.shape[1]
        pls = o["pls"].reshape(C, F)
        ok = o["ldpc_ok"].reshape(C, F)
        bch_bad = o["bch_bad"].reshape(C, F)
        trials = o["trials"].reshape(C, F)
        hard = o["hard"].reshape(C, F, -1)
        llrs = o["llrs"].reshape(C, F, -1)
        kb = o["kbch_bytes"].reshape(C, F, -1)
        qual = o["quality"].reshape(C, F)
        for c in range(C):
            car = tx.carriers[c]
            # transmitted symbol position of the block's symbol 0
            base = (s["j0"][c] * car["ratio"] + car["delay"]) / 2.0
            pos = starts[c].astype(np.float64) + base
            f_inf = np.rint(pos / L).astype(np.int64)
            start_err = max(start_err, float(np.max(np.abs(pos - f_inf * L))))
            f = f_inf % NF
            cw = np.unpackbits(car["codewords"][f], axis=1)   # [F, nldpc]
            frames += F
            pls_bad += int((pls[c] != cfg.pls_code).sum())
            sign_err = ((llrs[c] < 0) != (cw == 1)).mean(axis=1)
            llr_err = max(llr_err, float(sign_err.max()))
            hard_bad += int((hard[c][ok[c]] != cw[ok[c]]).sum())
            good = ok[c] & ~bch_bad[c]
            kbch_bad += int((kb[c][good] != car["bbframes"][f[good]]).sum())
            qmin = min(qmin, float(qual[c].min()))
            low = qual[c] < gate
            under += int(low.sum())
            under_right += int((low & good & np.all(
                kb[c] == car["bbframes"][f], axis=1)).sum())
            trials_bad += int(((trials[c][ok[c]] < 1) |
                               (trials[c][ok[c]] > n_iters)).sum())
    return dict(sampled_frames=frames, start_err_max_sym=start_err,
                pls_mismatch=pls_bad, llr_sign_err_max=llr_err,
                hard_mismatch_bits=hard_bad, kbch_mismatch_bytes=kbch_bad,
                trials_bad=trials_bad, quality_min=qmin,
                under_sync_gate=under, under_sync_gate_decoded=under_right)


def to_host(samples: dict) -> dict:
    """The kept outputs as numpy arrays (after the window)."""
    return {k: dict(j0=s["j0"], out={n: v.detach().cpu().numpy()
                                     for n, v in s["out"].items()})
            for k, s in samples.items()}
