"""DVB-S2 inner LDPC code: table loading, graph construction, encoder.

The parity-address tables (EN 302 307-1 annexes B/C) live in
data/dvb_s2_tables.npz (see tools/gen_ldpc_tables.py for provenance).
Semantics follow the standard's IRA construction (sec. 5.3.2):

  q = (N-K)/360; info bit j (group g = j//360, m = j%360) accumulates into
  parity addresses (table_row[g] + m*q) mod (N-K); afterwards
  p_i ^= p_{i-1} (accumulator chain).

The parity-check graph used by the decoder: check node c connects to
parity bits c and c-1 plus every info bit that accumulates into c.
This matches the reference's table iterator
(reference src/demod/dvbs2/codings/xdsopl-ldpc-pabr/ldpc.hh:94-123).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "dvb_s2_tables.npz")


@functools.lru_cache()
def _npz():
    return np.load(_DATA)


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """Static structure of one DVB-S2 LDPC code."""
    table: str          # e.g. "B4"
    N: int              # codeword length
    K: int              # info length
    rows: np.ndarray    # [K/360, deg_max] first-bit addresses, -1 padded
    row_deg: np.ndarray  # [K/360] info-bit degree per group

    @property
    def R(self) -> int:
        return self.N - self.K

    @property
    def q(self) -> int:
        return self.R // 360

    @functools.cached_property
    def info_addr(self) -> np.ndarray:
        """[K, deg_max] parity addresses per info bit (-1 padded)."""
        g = self.rows[:, None, :]                      # [G,1,D]
        m = np.arange(360)[None, :, None]              # [1,360,1]
        addr = (g + m * self.q) % self.R
        addr = np.where(self.rows[:, None, :] < 0, -1, addr)
        return addr.reshape(self.K, -1)

    @functools.cached_property
    def check_edges(self):
        """Variable-node index list per check node, grouped by check degree.

        Returns list of (deg, checks, var_idx) where var_idx is
        [n_checks, deg] int32 of variable-node (codeword bit) indices and
        checks is [n_checks] int32 of check ids. Check c's variables:
        info bits accumulating into c, parity bit K+c, and parity bit
        K+c-1 when c>0.
        """
        addr = self.info_addr
        deg = (addr >= 0).sum(1)
        flat_addr = addr[addr >= 0]
        flat_var = np.repeat(np.arange(self.K, dtype=np.int64), deg)
        order = np.argsort(flat_addr, kind="stable")
        sorted_addr = flat_addr[order]
        sorted_var = flat_var[order]
        counts = np.bincount(sorted_addr, minlength=self.R)
        starts = np.concatenate([[0], np.cumsum(counts)])
        cdeg = counts + 2
        cdeg[0] = counts[0] + 1  # check 0 has no p_{-1}
        groups = []
        for d in np.unique(cdeg):
            checks = np.nonzero(cdeg == d)[0]
            vi = np.zeros((len(checks), d), np.int32)
            for row, c in enumerate(checks):
                info_vars = sorted_var[starts[c]:starts[c + 1]]
                parity_vars = [self.K + c] if c == 0 else [self.K + c - 1, self.K + c]
                vi[row] = np.concatenate([info_vars, parity_vars])
            groups.append((int(d), checks.astype(np.int32), vi))
        return groups

    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """Systematic IRA encode. info_bits [..., K] uint8 -> [..., N]."""
        assert info_bits.shape[-1] == self.K
        flat = info_bits.reshape(-1, self.K)
        addr = self.info_addr
        valid = addr >= 0
        out = np.empty((flat.shape[0], self.N), np.uint8)
        for b in range(flat.shape[0]):
            contrib = flat[b][:, None] & valid  # [K, D]
            p = np.bincount(addr[valid], weights=contrib[valid],
                            minlength=self.R).astype(np.int64) % 2
            p = np.cumsum(p) % 2  # accumulator chain
            out[b, :self.K] = flat[b]
            out[b, self.K:] = p
        return out.reshape(info_bits.shape[:-1] + (self.N,))

    def check_syndrome(self, code_bits: np.ndarray) -> np.ndarray:
        """Parity-check verification; returns number of failed checks."""
        c = code_bits.astype(np.int64)
        addr = self.info_addr
        valid = addr >= 0
        contrib = c[:self.K, None] * valid
        s = np.bincount(addr[valid], weights=contrib[valid],
                        minlength=self.R).astype(np.int64)
        p = c[self.K:]
        s = (s + p + np.concatenate([[0], p[:-1]])) % 2
        return int(s.sum())


@functools.lru_cache()
def get_code(table: str) -> LDPCCode:
    """Load a code by table name ("B1".."B11", "C1".."C10")."""
    z = _npz()
    N, K, M = (int(v) for v in z[table + "_NKM"])
    assert M == 360
    return LDPCCode(table=table, N=N, K=K,
                    rows=z[table + "_rows"], row_deg=z[table + "_deg"])
