"""DVB-S golden modulator (EN 300 421): TS bytes -> QPSK symbols.

  TS packets -> energy dispersal (8-packet groups, inverted first sync)
  -> RS(204,188) -> convolutional interleave (I=12, M=17)
  -> K=7 rate-1/2 CC encode -> puncture -> QPSK map

Loopback oracle for the DVB-S receive chain (the reference is RX-only).
"""
from __future__ import annotations

import numpy as np

from ..spec import scrambling, rs_spec, dvbs_fec

_SQ2 = np.float32(1.0 / np.sqrt(2.0))


class DVBSModulator:
    """Stateful (interleaver + CC register continuity) DVB-S transmitter."""

    def __init__(self, rate: str = "1/2"):
        assert rate in dvbs_fec.RATES
        self.rate = rate
        self.interleaver = dvbs_fec.ConvInterleaver()
        self.cc_state = 0
        self._bit_carry = np.zeros(0, np.uint8)
        self._xy_carry = np.zeros((0, 2), np.uint8)

    def ts_to_symbols(self, ts: np.ndarray) -> np.ndarray:
        """ts: flat uint8 array of whole 8-packet groups (n*8*188)."""
        pkts = ts.reshape(-1, 8 * 188)
        chunks = []
        for grp in pkts:
            disp = scrambling.dvbs_scramble_group(grp)
            rs_in = disp.reshape(8, 188)
            rs_out = rs_spec.encode(rs_in).reshape(-1)       # 8*204
            chunks.append(rs_out)
        stream = self.interleaver.process(np.concatenate(chunks))
        bits = np.unpackbits(stream)
        xy = dvbs_fec.cc_encode(bits, self.cc_state)
        # carry CC state: register holds last 6 bits
        tail = bits[-6:][::-1]
        self.cc_state = int((tail * (1 << np.arange(6))).sum())
        xy = np.concatenate([self._xy_carry, xy])
        p = len(dvbs_fec.PUNCTURE[self.rate][0])
        n = (len(xy) // p) * p
        self._xy_carry = xy[n:]
        punct = dvbs_fec.puncture(xy[:n], self.rate)
        serial = np.concatenate([self._bit_carry, punct])
        n_sym = len(serial) // 2
        pairs = serial[:2 * n_sym].reshape(-1, 2)
        self._bit_carry = serial[2 * n_sym:]
        i = (1.0 - 2.0 * pairs[:, 0]).astype(np.float32)
        q = (1.0 - 2.0 * pairs[:, 1]).astype(np.float32)
        return ((i + 1j * q) * _SQ2).astype(np.complex64)


def random_ts_groups(n_groups: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pkts = rng.integers(0, 256, (n_groups * 8, 188)).astype(np.uint8)
    pkts[:, 0] = 0x47
    return pkts.reshape(-1)
