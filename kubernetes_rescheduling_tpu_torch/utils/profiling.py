"""Profiling: wall-clock timers and decision-latency histograms — the port
of ``kubernetes_rescheduling_tpu.utils.profiling``.

The north-star metric is rescheduling decisions/sec; the reference measures
only whole-run wall time (main.py:126-135). Here every decision gets a
latency sample and the distribution is inspectable. ``trace_to`` is
re-exported from ``telemetry.spans`` (the same object), where the
``torch.profiler`` integration lives.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from kubernetes_rescheduling_tpu_torch.telemetry.registry import Histogram
from kubernetes_rescheduling_tpu_torch.telemetry.spans import trace_to  # noqa: F401


@dataclass
class Timer:
    """``with Timer() as t: ...; t.elapsed_s``"""

    elapsed_s: float = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_s = time.perf_counter() - self._t0


class LatencyHistogram(Histogram):
    """Streaming latency stats for decision rounds: a fixed-bucket histogram
    (memory O(buckets) however long the run; count, mean and max exact, the
    percentiles bucket-interpolated). ``add``/``summary`` are the JAX
    package's API."""

    def __init__(self) -> None:
        super().__init__("latency_seconds")

    def add(self, seconds: float) -> None:
        self.observe(seconds)
