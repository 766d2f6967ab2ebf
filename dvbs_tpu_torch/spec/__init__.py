"""Standards layer: pure-numpy DVB-S/DVB-S2 tables, codes, and sequences."""
from . import modcod, plheader, scrambling, gf2m, bch_spec, ldpc_spec
from . import constellations, interleaver

__all__ = ["modcod", "plheader", "scrambling", "gf2m", "bch_spec",
           "ldpc_spec", "constellations", "interleaver"]
