"""Per-layer metric readers, one module a metric: ``read(trace_view)``
returns the value, or None where the trace holds nothing to read."""
