"""Labeled metric series with Prometheus exposition and a JSONL sink — the
port's copy of ``kubernetes_rescheduling_tpu.telemetry.registry`` (stdlib
only), exposing byte for byte what the JAX package's registry exposes.

Three metric kinds, mirroring the Prometheus data model:

- :class:`Counter` — monotone ``inc``.
- :class:`Gauge` — ``set``/``inc``/``dec``.
- :class:`Histogram` — fixed-bucket streaming: per-bucket counts plus
  sum/count/min/max, memory O(buckets) whatever the sample volume.
  Percentiles interpolate linearly within a bucket, so their error is
  bounded by the bucket width (Prometheus ``histogram_quantile``).

Labels: a metric declared with ``labelnames`` is a family; ``.labels(...)``
returns (and memoizes) the child series for one label-value tuple, so two
lookups with the same values hit the SAME series. A metric with no
labelnames is its own single series. :meth:`MetricsRegistry.value` reads a
counter or gauge back.
"""

from __future__ import annotations

import json
import math
import threading
import time
from pathlib import Path
from typing import Any, Iterable

# Latency-shaped default buckets (seconds): sub-ms device rounds up to
# multi-second reconcile waits all land in a resolved bucket.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# Request-scale micro buckets (seconds), 50µs–250ms: the serving plane's
# per-request stage spans live one to three orders of magnitude below the
# round-scale DEFAULT_BUCKETS — queue-wait and decode are tens of
# microseconds, a coalesced device dispatch single-digit milliseconds —
# and under the default preset every stage would collapse into the two
# bottom buckets, making the interpolated p50/p99 meaningless. Selectable
# at registration (``registry.histogram(..., buckets=MICRO_BUCKETS)``);
# the registry's bucket-mismatch check guarantees a family can never mix
# presets across call sites. Used by all serving_request_seconds{stage}
# families.
MICRO_BUCKETS: tuple[float, ...] = (
    50e-6, 100e-6, 250e-6, 500e-6,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labels: dict[str, str], extra: dict[str, str] | None = None) -> str:
    items = {**labels, **(extra or {})}
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in items.items()
    )
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


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
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labelvalues)}"
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

    def _series(self) -> Iterable[tuple[dict[str, str], "_Metric"]]:
        """(labels, leaf) pairs — the family itself when unlabeled."""
        if self.labelnames:
            with self._lock:
                items = list(self._children.items())
            for key, child in items:
                yield dict(zip(self.labelnames, key)), child
        else:
            yield {}, self

    def _require_unlabeled(self) -> None:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                f".labels(...) first"
            )


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

    def expose(self, labels: dict[str, str]) -> list[str]:
        return [f"{self.name}{_format_labels(labels)} {_fmt_value(self.value)}"]

    def sample(self) -> dict[str, Any]:
        return {"value": self.value}


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

    def inc(self, amount: float = 1.0) -> None:
        self._require_unlabeled()
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def expose(self, labels: dict[str, str]) -> list[str]:
        return [f"{self.name}{_format_labels(labels)} {_fmt_value(self.value)}"]

    def sample(self) -> dict[str, Any]:
        return {"value": self.value}


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str = "",
        help: str = "",
        labelnames=(),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
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
            i = 0
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q ∈ [0, 100]. Linear interpolation inside the landing bucket;
        clamped to the observed min/max so the estimate never leaves the
        data's actual range (the bound the accuracy test asserts)."""
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * self.count
        cum = 0
        lo = 0.0
        for i, ub in enumerate(self.buckets):
            c = self.counts[i]
            if cum + c >= rank and c > 0:
                frac = (rank - cum) / c
                est = lo + frac * (ub - lo)
                return min(max(est, self.min), self.max)
            cum += c
            lo = ub
        return self.max  # landed in the +Inf bucket

    def summary(self) -> dict[str, float]:
        """The ``LatencyHistogram.summary`` schema (ms-denominated), so
        existing consumers migrate by swapping the class."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean_ms": self.mean * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p90_ms": self.percentile(90) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "max_ms": self.max * 1e3,
            "decisions_per_sec": (1.0 / self.mean) if self.mean > 0 else 0.0,
        }

    def expose(self, labels: dict[str, str]) -> list[str]:
        lines = []
        cum = 0
        for i, ub in enumerate(self.buckets):
            cum += self.counts[i]
            le = _format_labels(labels, {"le": _fmt_value(ub)})
            lines.append(f"{self.name}_bucket{le} {cum}")
        le = _format_labels(labels, {"le": "+Inf"})
        lines.append(f"{self.name}_bucket{le} {self.count}")
        lab = _format_labels(labels)
        lines.append(f"{self.name}_sum{lab} {_fmt_value(self.sum)}")
        lines.append(f"{self.name}_count{lab} {self.count}")
        return lines

    def sample(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": {
                _fmt_value(ub): self.counts[i]
                for i, ub in enumerate(self.buckets)
            },
            "inf": self.counts[-1],
        }


class MetricsRegistry:
    """Get-or-create metric families; exposition + JSONL dump over all."""

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
            raise ValueError(
                f"{name} already registered as {m.kind}, not {cls.kind}"
            )
        if m.labelnames != tuple(labelnames):
            raise ValueError(
                f"{name} already registered with labels {m.labelnames}, "
                f"not {tuple(labelnames)}"
            )
        return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(),
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> Histogram:
        m = self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )
        want = tuple(sorted(float(x) for x in buckets))
        if m.buckets != want:
            raise ValueError(
                f"{name} already registered with buckets {m.buckets}, "
                f"not {want}"
            )
        return m

    def expose(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        out: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for labels, leaf in m._series():
                out.extend(leaf.expose(labels))
        return "\n".join(out) + ("\n" if out else "")

    def snapshot(self) -> list[dict[str, Any]]:
        """One plain dict per series — the JSONL record shape."""
        ts = time.time()
        out = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            for labels, leaf in m._series():
                out.append(
                    {
                        "ts": ts,
                        "metric": m.name,
                        "type": m.kind,
                        "labels": labels,
                        **leaf.sample(),
                    }
                )
        return out

    def dump_jsonl(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("a") as f:
            for rec in self.snapshot():
                f.write(json.dumps(rec, default=float) + "\n")

    def write_exposition(self, path: str | Path) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.expose())

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

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-default registry (tests isolate with this);
    returns the previous one so callers can restore it."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry
    return prev
