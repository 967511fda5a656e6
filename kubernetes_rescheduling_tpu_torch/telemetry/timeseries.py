"""The history plane: a bounded in-process time-series ring store — the
port's copy of ``kubernetes_rescheduling_tpu.telemetry.timeseries``.

Every health signal before this module was a point-in-time value — the
registry holds the *current* counter totals, the watchdog judges small
rolling windows, /healthz flips on the latest sample. :class:`SeriesStore`
adds the missing axis: it samples SELECTED registry families at
round/batch grain into fixed-capacity rings, so the SLO engine
(:mod:`telemetry.slo`) can ask "how many bad events in the last W
ticks?" — the primitive error budgets and burn rates are built from.

Cardinality discipline (the fleet's label-budget rules, applied to history):

- **fixed per-series capacity** — each ring is a bounded deque of
  ``(tick, value)`` pairs; memory per series is O(capacity) however long
  the run;
- **hard global series budget** — at most ``max_series`` rings exist at
  once; admitting a new series beyond the budget evicts the
  least-recently-updated ring and counts it
  (``timeseries_evictions_total``), so a 1k-tenant fleet soak holds the
  same bytes as a solo run (T-independence, test-pinned);
- **family allowlist** — only the families named at construction are
  sampled at all; an exploding label space in some other family can
  never reach the store.

Counter extraction is **reset-tolerant**: a sampled value that DROPS
below its predecessor (a registry rebase, a fresh cell binding) is read
as a restart — the new value IS the delta, the classic Prometheus
``increase()`` convention — so burn windows never go negative across
rebases.

Histograms sample as derived ``:count`` / ``:sum`` series, plus
per-bucket cumulative counts for the families in ``bucket_families``
(the latency-threshold SLO mode needs "requests at or under X ms", which
is exactly a cumulative bucket count).

Everything here reads host-side values the registry already holds. Feeding the store adds zero device transfers by construction.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)

# the round/batch-grain families the default store samples: serving
# outcomes + stage latency, the wall-clock round headline, breaker /
# degraded / skip accounting, the bounded fleet rollup quantiles, and
# the watchdog's own violation counter
DEFAULT_FAMILIES = (
    "serving_placements_total",
    "serving_shed_total",
    "serving_request_seconds",
    "wall_round_ms",
    "rounds_total",
    "rounds_skipped_total",
    "degraded_rounds_total",
    "circuit_breaker_transitions_total",
    "fleet_cost_quantile",
    "fleet_load_std_quantile",
    "fleet_drift_quantile",
    "slo_violations_total",
)

# histogram families whose cumulative bucket counts are sampled too
# (bounded: one extra series per declared bucket edge)
DEFAULT_BUCKET_FAMILIES = ("serving_request_seconds",)


def series_key(metric: str, labels: dict[str, str] | None, part: str = "") -> str:
    """The canonical series name: ``metric[:part]{k="v",...}`` with
    sorted labels — what /query takes and the SLO selectors resolve to."""
    base = f"{metric}:{part}" if part else metric
    if not labels:
        return base
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{base}{{{inner}}}"


class SeriesStore:
    """Bounded ring store over selected registry families.

    ``capacity`` is points per series; ``max_series`` the hard global
    budget (LRU-evicted, counted). ``families=None`` samples every
    record offered — the golden fixture's mode; production stores pass
    the allowlist."""

    def __init__(
        self,
        *,
        capacity: int = 512,
        max_series: int = 256,
        families: Iterable[str] | None = DEFAULT_FAMILIES,
        bucket_families: Iterable[str] = DEFAULT_BUCKET_FAMILIES,
        registry: MetricsRegistry | None = None,
    ) -> None:
        if capacity < 2:
            raise ValueError("timeseries capacity must be >= 2")
        if max_series < 1:
            raise ValueError("timeseries max_series must be >= 1")
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.families = None if families is None else frozenset(families)
        self.bucket_families = frozenset(bucket_families)
        self.registry = registry
        # name -> deque[(tick, value)]; insertion order doubles as the
        # LRU order (move_to_end on every update)
        self._series: collections.OrderedDict[
            str, collections.deque[tuple[int, float]]
        ] = collections.OrderedDict()
        # name -> (metric, labels) so selectors match without re-parsing
        self._meta: dict[str, tuple[str, dict[str, str]]] = {}
        self.evictions = 0
        self.last_tick = 0

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    def __len__(self) -> int:
        return len(self._series)

    def names(self) -> list[str]:
        return list(self._series)

    def points(self) -> int:
        """Total retained points — the ring-bytes bound's proxy."""
        return sum(len(d) for d in self._series.values())

    # ---- writes ----

    def record(
        self,
        metric: str,
        labels: dict[str, str] | None,
        tick: int,
        value: float,
        part: str = "",
    ) -> None:
        """Append one point to one series, admitting (and budget-gating)
        the series if new. The grain-level entry point ``sample`` fans
        into."""
        name = series_key(metric, labels, part)
        ring = self._series.get(name)
        if ring is None:
            while len(self._series) >= self.max_series:
                victim, _ = self._series.popitem(last=False)
                self._meta.pop(victim, None)
                self.evictions += 1
                self._reg().counter(
                    "timeseries_evictions_total",
                    "history-plane series evicted by the hard global "
                    "series budget (least-recently-updated first)",
                ).inc()
            ring = self._series[name] = collections.deque(
                maxlen=self.capacity
            )
            self._meta[name] = (metric, dict(labels or {}))
        else:
            self._series.move_to_end(name)
        ring.append((int(tick), float(value)))

    def sample(self, records: list[dict[str, Any]], tick: int) -> None:
        """Ingest one registry snapshot (``MetricsRegistry.snapshot()``
        record dicts) at ``tick``. Only allowlisted families are kept;
        counters/gauges store their value, histograms their count/sum
        (plus cumulative bucket counts for ``bucket_families``)."""
        tick = int(tick)
        self.last_tick = max(self.last_tick, tick)
        for rec in records:
            metric = rec.get("metric")
            if self.families is not None and metric not in self.families:
                continue
            labels = rec.get("labels") or {}
            if rec.get("type") == "histogram":
                self.record(metric, labels, tick, rec.get("count", 0))
                # ":count" is the canonical total; the bare name above
                # stays for symmetry with /query's counter readout
                self.record(
                    metric, labels, tick, rec.get("sum", 0.0), part="sum"
                )
                if metric in self.bucket_families:
                    running = 0.0
                    for ub, n in (rec.get("buckets") or {}).items():
                        running += n
                        self.record(
                            metric, labels, tick, running, part=f"le:{ub}"
                        )
            else:
                self.record(metric, labels, tick, rec.get("value", 0.0))
        self._reg().gauge(
            "timeseries_series",
            "history-plane series currently retained (bounded by the "
            "hard max_series budget)",
        ).set(len(self._series))

    # ---- reads ----

    def query(self, name: str, n: int | None = None) -> list[tuple[int, float]]:
        """The last ``n`` points of one series (the /query endpoint's
        readout); the full bounded ring when ``n`` is None. Raises
        ``KeyError`` for an unknown (or evicted) series."""
        ring = self._series[name]
        pts = list(ring)
        if n is not None:
            n = max(int(n), 0)
            pts = pts[len(pts) - min(n, len(pts)):]
        return pts

    def match(
        self, metric: str, labels: Iterable[tuple[str, str]] = ()
    ) -> list[str]:
        """Series names whose metric matches and whose labels contain
        every given (key, value) pair — the SLO selectors' resolver."""
        want = dict(labels)
        out = []
        for name, (m, lbls) in self._meta.items():
            if m != metric:
                continue
            if all(lbls.get(k) == v for k, v in want.items()):
                out.append(name)
        return out

    def delta(self, name: str, window: int, now: int | None = None) -> float:
        """Reset-tolerant increase of a monotone series over the last
        ``window`` ticks: consecutive drops read as restarts (the new
        value IS the delta), so rebases never produce negative burn.
        Unknown series contribute 0 — a family that never fed (a solo
        run with no serving engine) is simply zero events."""
        ring = self._series.get(name)
        if not ring:
            return 0.0
        now = self.last_tick if now is None else int(now)
        floor = now - int(window)
        prev: float | None = None
        total = 0.0
        for tick, value in ring:
            if tick <= floor:
                prev = value  # the base point just outside the window
                continue
            if prev is None:
                # the window predates the ring: the first retained point
                # is all we can attribute (capacity-bounded honesty)
                total += value if tick <= floor + 1 else 0.0
            else:
                total += value - prev if value >= prev else value
            prev = value
        return total

    def value(self, name: str) -> float | None:
        """The latest sampled value of one series (gauge-style read)."""
        ring = self._series.get(name)
        return ring[-1][1] if ring else None
