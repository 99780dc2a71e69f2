"""Per-layer metric readers, one file each, named as the metric is in
``BENCHMARK.json``.  Each defines ``read(rec)``: the metric's value from
the traced run's record (``run.py``'s ``record``), or None where the
record holds nothing to read (the harness then leaves the metric out)."""
