"""Per-layer metric readers, one file a metric, found by the metric's
name in ``BENCHMARK.json``.  Each file has ``read(trace)`` which takes the
traced run's :class:`bench.harness.Traced` and returns the metric's value, or
None where the trace holds nothing for it to read (the harness then
leaves the metric out of the line)."""
