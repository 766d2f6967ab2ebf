"""JSON configuration persistence.

Same keys and autosave behavior as the reference's ConfigManager use
(main.cpp:97-127): hostname, port, sending, dvbs_version, dvbs_symrate,
dvbs2_symrate, dvbs2_{constellation,coderate,framesize,pilots,automodcod},
dvbs_bandwidth, dvbs2_bandwidth.
"""
from __future__ import annotations

import json
import os

DEFAULTS = {
    "hostname": "localhost",
    "port": 5000,
    "sending": False,
    "dvbs_version": "ts2",        # "ts" (DVB-S) | "ts2" (DVB-S2)
    "dvbs_symrate": 250000,
    "dvbs2_symrate": 250000,
    "dvbs2_constellation": "qpsk",
    "dvbs2_coderate": "1/2",
    "dvbs2_framesize": "normal",
    "dvbs2_pilots": False,
    "dvbs2_automodcod": False,
    "dvbs_bandwidth": 500000.0,
    "dvbs2_bandwidth": 500000.0,
}


class Config:
    def __init__(self, path: str = "dvbs_demodulator_config.json",
                 autosave: bool = True):
        self.path = path
        self.autosave = autosave
        self.data = dict(DEFAULTS)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self.data.update(json.load(f))
            except (json.JSONDecodeError, OSError):
                pass

    def __getitem__(self, k):
        return self.data[k]

    def __setitem__(self, k, v):
        self.data[k] = v
        if self.autosave:
            self.save()

    def save(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=2)
        os.replace(tmp, self.path)
