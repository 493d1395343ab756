"""Per-layer metrics, one reader a metric: `<metric>.py` defines
`read(ctx)`, which takes a `harness.TraceContext` (the traced stretch of
the window, the cell, the traced jobs' inputs and answers) and returns
the metric's value, or None where the cell gives it nothing to read."""
