"""Generic readers of per-layer metrics: each module has
`read(ctx, spec) -> float | None`, where `spec` is the metric's file under
`metrics/` and `ctx` the traced stretch (harness.TraceContext). A reader
that finds nothing to read returns None, and the metric is left out."""
