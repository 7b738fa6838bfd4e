"""Per-layer metric readers: ``<metric>.py`` for each per-layer metric
of ``BENCHMARK.json``, loaded by file name (``harness.spec``)."""
