"""Host I/O: BBFRAME/TS parsing, deframing, sources, sinks, config."""
