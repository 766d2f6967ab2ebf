"""DVB-S2 MODCOD configuration tables (ETSI EN 302 307-1).

Capability parity with the reference's modcod_to_cfg
(reference src/demod/dvbs2/codings/modcod_to_cfg.cpp:5-221) and the
BCH/LDPC size tables (reference src/demod/dvbs2/codings/bbframe_bch.cpp:39-179,
bbframe_ldpc.cpp:28-116), re-expressed as declarative Python data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Code rates (EN 302 307-1 table 5b)
RATES = ("1/4", "1/3", "2/5", "1/2", "3/5", "2/3", "3/4", "4/5", "5/6", "8/9", "9/10")

NORMAL = "normal"   # FECFRAME 64800
SHORT = "short"     # FECFRAME 16200

# Constellations
QPSK, PSK8, APSK16, APSK32 = "qpsk", "8psk", "16apsk", "32apsk"

MOD_BITS = {QPSK: 2, PSK8: 3, APSK16: 4, APSK32: 5}

# kbch, nbch (= kldpc) per (framesize, rate): EN 302 307-1 tables 5a/5b.
# BCH error-correction capability t and the nbch values mirror
# bbframe_bch.cpp:39-179.
BCH_PARAMS = {
    (NORMAL, "1/4"): (16008, 16200, 12),
    (NORMAL, "1/3"): (21408, 21600, 12),
    (NORMAL, "2/5"): (25728, 25920, 12),
    (NORMAL, "1/2"): (32208, 32400, 12),
    (NORMAL, "3/5"): (38688, 38880, 12),
    (NORMAL, "2/3"): (43040, 43200, 10),
    (NORMAL, "3/4"): (48408, 48600, 12),
    (NORMAL, "4/5"): (51648, 51840, 12),
    (NORMAL, "5/6"): (53840, 54000, 10),
    (NORMAL, "8/9"): (57472, 57600, 8),
    (NORMAL, "9/10"): (58192, 58320, 8),
    (SHORT, "1/4"): (3072, 3240, 12),
    (SHORT, "1/3"): (5232, 5400, 12),
    (SHORT, "2/5"): (6312, 6480, 12),
    (SHORT, "1/2"): (7032, 7200, 12),
    (SHORT, "3/5"): (9552, 9720, 12),
    (SHORT, "2/3"): (10632, 10800, 12),
    (SHORT, "3/4"): (11712, 11880, 12),
    (SHORT, "4/5"): (12432, 12600, 12),
    (SHORT, "5/6"): (13152, 13320, 12),
    (SHORT, "8/9"): (14232, 14400, 12),
    # 9/10 does not exist for short frames (EN 302 307-1 table 5b)
}

# LDPC table name per (framesize, rate): bbframe_ldpc.cpp:28-116.
LDPC_TABLE = {}
for _i, _r in enumerate(RATES):
    LDPC_TABLE[(NORMAL, _r)] = "B%d" % (_i + 1)
    if _r != "9/10":
        LDPC_TABLE[(SHORT, _r)] = "C%d" % (_i + 1)

# MODCOD number -> (constellation, rate, gamma1, gamma2)
# modcod_to_cfg.cpp:5-140; APSK ring-ratio gammas are the DVB-S2
# optimized values from EN 302 307-1 tables 9/10.
_MODCODS = {
    1: (QPSK, "1/4", None, None),
    2: (QPSK, "1/3", None, None),
    3: (QPSK, "2/5", None, None),
    4: (QPSK, "1/2", None, None),
    5: (QPSK, "3/5", None, None),
    6: (QPSK, "2/3", None, None),
    7: (QPSK, "3/4", None, None),
    8: (QPSK, "4/5", None, None),
    9: (QPSK, "5/6", None, None),
    10: (QPSK, "8/9", None, None),
    11: (QPSK, "9/10", None, None),
    12: (PSK8, "3/5", None, None),
    13: (PSK8, "2/3", None, None),
    14: (PSK8, "3/4", None, None),
    15: (PSK8, "5/6", None, None),
    16: (PSK8, "8/9", None, None),
    17: (PSK8, "9/10", None, None),
    18: (APSK16, "2/3", 3.15, None),
    19: (APSK16, "3/4", 2.85, None),
    20: (APSK16, "4/5", 2.75, None),
    21: (APSK16, "5/6", 2.70, None),
    22: (APSK16, "8/9", 2.60, None),
    23: (APSK16, "9/10", 2.57, None),
    24: (APSK32, "3/4", 2.84, 5.27),
    25: (APSK32, "4/5", 2.72, 4.87),
    26: (APSK32, "5/6", 2.64, 4.64),
    27: (APSK32, "8/9", 2.54, 4.33),
    28: (APSK32, "9/10", 2.53, 4.30),
}

# slots per XFECFRAME for (constellation, framesize): modcod_to_cfg.cpp
_SLOTS = {
    (QPSK, NORMAL): 360, (QPSK, SHORT): 90,
    (PSK8, NORMAL): 240, (PSK8, SHORT): 60,
    (APSK16, NORMAL): 180, (APSK16, SHORT): 45,
    (APSK32, NORMAL): 144, (APSK32, SHORT): 36,
}


@dataclasses.dataclass(frozen=True)
class ModcodConfig:
    """Full static configuration of one DVB-S2 MODCOD."""
    modcod: int
    constellation: str
    rate: str
    framesize: str          # NORMAL | SHORT
    pilots: bool
    slots: int              # payload slots of 90 symbols
    kbch: int               # BB frame payload bits
    nbch: int               # = kldpc
    bch_t: int              # BCH correctable errors
    nldpc: int              # 64800 | 16200
    ldpc_table: str         # e.g. "B4"
    g1: Optional[float]     # APSK ring ratio gamma1
    g2: Optional[float]     # APSK ring ratio gamma2

    @property
    def mod_bits(self) -> int:
        return MOD_BITS[self.constellation]

    @property
    def pls_code(self) -> int:
        """PLS index = MODCOD<<2 | short<<1 | pilots (module_dvbs2_demod.cpp:64)."""
        return (self.modcod << 2) | (int(self.framesize == SHORT) << 1) | int(self.pilots)

    @property
    def pilot_blocks(self) -> int:
        """Number of 36-symbol pilot blocks (one after every 16 slots,
        except when coinciding with frame end; dvbs2_pl_sync.cpp:17-31)."""
        if not self.pilots:
            return 0
        n, cnt = self.slots - 16, 1
        while n > 16:
            n -= 16
            cnt += 1
        return cnt

    @property
    def plframe_len(self) -> int:
        """Total PLFRAME symbols incl. 90-symbol PLHEADER and pilots."""
        return (self.slots + 1) * 90 + self.pilot_blocks * 36

    @property
    def payload_len(self) -> int:
        """Data symbols per frame (excl. header and pilots) = nldpc/mod_bits."""
        return self.slots * 90


def get_config(modcod: int, short: bool = False, pilots: bool = False) -> ModcodConfig:
    """Equivalent of get_dvbs2_cfg (modcod_to_cfg.cpp:5-140)."""
    if modcod not in _MODCODS:
        raise ValueError(f"unsupported MODCOD {modcod}")
    constellation, rate, g1, g2 = _MODCODS[modcod]
    framesize = SHORT if short else NORMAL
    if (framesize, rate) not in BCH_PARAMS:
        raise ValueError(f"rate {rate} not defined for {framesize} frames")
    kbch, nbch, bch_t = BCH_PARAMS[(framesize, rate)]
    nldpc = 16200 if short else 64800
    slots = _SLOTS[(constellation, framesize)]
    assert slots * 90 * MOD_BITS[constellation] == nldpc
    return ModcodConfig(
        modcod=modcod, constellation=constellation, rate=rate,
        framesize=framesize, pilots=pilots, slots=slots,
        kbch=kbch, nbch=nbch, bch_t=bch_t, nldpc=nldpc,
        ldpc_table=LDPC_TABLE[(framesize, rate)], g1=g1, g2=g2)


def get_modcod(constellation: str, rate: str) -> int:
    """Inverse map (modcod_to_cfg.cpp:142-221)."""
    for mc, (c, r, _, _) in _MODCODS.items():
        if c == constellation and r == rate:
            return mc
    raise ValueError(f"no MODCOD for {constellation} {rate}")


def from_pls_code(pls_code: int) -> ModcodConfig:
    """Decode a 7-bit PLS code back to a config."""
    return get_config(pls_code >> 2, bool(pls_code & 2), bool(pls_code & 1))
