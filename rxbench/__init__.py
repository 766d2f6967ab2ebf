"""rxbench: the benchmark of dvbs_tpu_torch (see README.md)."""
