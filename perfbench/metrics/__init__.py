"""One reader a per-layer metric, named as in ``BENCHMARK.json``: each
defines ``read(run) -> float | None`` (None when it finds nothing)."""
