"""Labeled metric series — the port's trimmed copy of
``kubernetes_rescheduling_tpu.telemetry.registry`` (stdlib only).

Three metric kinds, as in the Prometheus data model: :class:`Counter`
(monotone ``inc``), :class:`Gauge` (``set``) and :class:`Histogram` (fixed buckets: per-bucket counts plus
sum/count/min/max). A metric declared with ``labelnames`` is a family;
``.labels(...)`` returns (and memoizes) the child series for one
label-value tuple. The control loop's boundary, breaker and round end
write here; :meth:`MetricsRegistry.value` reads a counter or gauge back.
Exposition, snapshots and the JSONL sink wait with the rest of the
telemetry plane.
"""

from __future__ import annotations

import math
import threading
from typing import Any

# latency-shaped default buckets (seconds)
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _Metric:
    """One metric family: shared name/help/labelnames, per-label children."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], _Metric] = {}
        self._lock = threading.Lock()

    def labels(self, **labelvalues: Any) -> "_Metric":
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labelvalues)}"
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _make_child(self) -> "_Metric":
        raise NotImplementedError

    def _require_unlabeled(self) -> None:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; call .labels(...) first")


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str = "", help: str = "", labelnames=()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _make_child(self) -> "Counter":
        return Counter(self.name)

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled()
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self.value += amount


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str = "", help: str = "", labelnames=()):
        super().__init__(name, help, labelnames)
        self.value = 0.0

    def _make_child(self) -> "Gauge":
        return Gauge(self.name)

    def set(self, value: float) -> None:
        self._require_unlabeled()
        with self._lock:
            self.value = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str = "", help: str = "", labelnames=(),
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets = b
        self.counts = [0] * (len(b) + 1)  # +1 for the implicit +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def _make_child(self) -> "Histogram":
        return Histogram(self.name, buckets=self.buckets)

    def observe(self, value: float) -> None:
        self._require_unlabeled()
        v = float(value)
        with self._lock:
            i = next((i for i, ub in enumerate(self.buckets) if v <= ub), len(self.buckets))
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.min = min(self.min, v)
            self.max = max(self.max, v)


class MetricsRegistry:
    """Get-or-create metric families."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, tuple(labelnames), **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise ValueError(f"{name} already registered as {m.kind}, not {cls.kind}")
        if m.labelnames != tuple(labelnames):
            raise ValueError(
                f"{name} already registered with labels {m.labelnames}, not {tuple(labelnames)}"
            )
        return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        m = self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)
        want = tuple(sorted(float(x) for x in buckets))
        if m.buckets != want:
            raise ValueError(f"{name} already registered with buckets {m.buckets}, not {want}")
        return m

    def value(self, name: str, **labels: Any) -> float:
        """A counter's or gauge's current value (0.0 when the series does
        not exist yet)."""
        m = self._metrics.get(name)
        if m is None:
            return 0.0
        if m.labelnames:
            key = tuple(str(labels[n]) for n in m.labelnames)
            m = m._children.get(key)
        return m.value if m is not None else 0.0



_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-default registry (where a caller passes none)."""
    return _default_registry
