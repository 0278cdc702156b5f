"""Per-layer metric readers, one file a metric named as in
BENCHMARK.json, each with ``read(rec)`` (see _common.py)."""
