"""Golden modulators (test oracle): numpy DVB-S / DVB-S2 transmitters.

The reference plugin is receive-only; these encoders exist so the RX
pipeline can be validated in loopback at every layer (SURVEY.md sec. 4).
"""
from . import dvbs2_mod, channel  # noqa: F401
