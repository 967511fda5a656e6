"""SLO v2: error budgets and multi-window multi-burn-rate alerting — the
port's copy of ``kubernetes_rescheduling_tpu.telemetry.slo``.

The watchdog's threshold rules are point detectors — "p99 over 50 ms right
now". This module adds the Google-SRE maturation step: each
:class:`SloSpec` declares an *objective* over good/bad events, the
engine accounts the remaining **error budget** over a long window, and
alerts on the **burn rate** — how many multiples of the sustainable
error rate we are currently consuming — measured over paired windows:

- ``slo_fast_burn`` — the *page*: a high burn threshold over a short
  window, confirmed by an even shorter window (the classic 5m/1h pair,
  expressed in rounds/requests because the sim clock is not wall time).
  Fires earlier than any static threshold on a hard overload, which is
  the point: budget math detects "p99 will be blown soon" before p99 is
  blown.
- ``slo_slow_burn`` — the *ticket*: a lower threshold over a longer
  window, catching slow leaks a page-level rule would sleep through.

Both windows of a pair must agree before the rule fires (the
multi-window trick that kills the one-bad-round false positive), and
burn math runs on :class:`~telemetry.timeseries.SeriesStore` deltas, so
it inherits the history plane's reset tolerance and memory bounds.

Burn entries feed the existing watchdog as a new rule kind
(``Watchdog.observe_slo_burn``) so /healthz, ``slo_violations_total``,
structured logs, and the flight recorder all work unchanged; per-tenant
budget gauges route through the fleet's ``TenantSeries`` gate — over the
tenant budget they are suppressed and counted, never registered.

One accounting caveat, accepted for simplicity: the ``rounds_success``
default spec counts degraded rounds in both ``rounds_total`` (good) and
``degraded_rounds_total`` (bad), slightly inflating the denominator
under degradation; clean soaks still read exactly 1.0 budget.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)
from kubernetes_rescheduling_tpu_torch.telemetry.timeseries import SeriesStore

# watchdog rule names contributed by this module (picked up by
# scripts/check_watchdog_rules_documented.py alongside watchdog.py's)
RULE_FAST_BURN = "slo_fast_burn"
RULE_SLOW_BURN = "slo_slow_burn"

# a selector is (metric, ((label_key, label_value), ...)); empty labels
# match (and sum) every series of the family
Selector = tuple[str, tuple[tuple[str, str], ...]]


def _short_window(window: int) -> int:
    """The confirm window of a burn pair: 1/12 of the long window (the
    SRE-workbook 5m-of-1h ratio), floored at one tick."""
    return max(int(window) // 12, 1)


def budget_burn_frac(good: float, bad: float, objective: float) -> float:
    """Fraction of the error budget consumed by a finished run:
    bad / ((1 - objective) * total), clamped to [0, inf). The bench
    ledger's ``slo_budget_burn_frac`` reading (1.0 = budget exactly
    spent, >1 = SLO violated)."""
    total = good + bad
    if total <= 0:
        return 0.0
    allowed = (1.0 - objective) * total
    if allowed <= 0:
        return math.inf if bad > 0 else 0.0
    return bad / allowed


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative SLO.

    ``kind="events"`` counts good/bad selector deltas; ``kind="latency"``
    derives them from a histogram family: good = requests at or under
    ``threshold_s`` (the cumulative count of the smallest bucket whose
    upper bound covers the threshold), bad = the rest."""

    name: str
    objective: float = 0.99
    kind: str = "events"
    good: tuple[Selector, ...] = ()
    bad: tuple[Selector, ...] = ()
    family: str = ""
    labels: tuple[tuple[str, str], ...] = ()
    threshold_s: float = 0.0

    def validate(self) -> "SloSpec":
        if not self.name:
            raise ValueError("SloSpec.name must be non-empty")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SloSpec {self.name}: objective must be in (0, 1)"
            )
        if self.kind not in ("events", "latency"):
            raise ValueError(
                f"SloSpec {self.name}: kind must be 'events' or 'latency'"
            )
        if self.kind == "events" and not (self.good or self.bad):
            raise ValueError(
                f"SloSpec {self.name}: events kind needs good/bad selectors"
            )
        if self.kind == "latency" and (
            not self.family or self.threshold_s <= 0
        ):
            raise ValueError(
                f"SloSpec {self.name}: latency kind needs family and "
                "threshold_s > 0"
            )
        return self


def default_specs(
    *, objective: float = 0.99, latency_threshold_ms: float = 0.0
) -> tuple[SloSpec, ...]:
    """The stock SLOs every wired loop gets: serving availability
    (placed or honestly-empty vs shed/timeout), control-loop round
    success, and — when a latency threshold is configured — serving
    latency over the total-stage histogram."""
    specs = [
        SloSpec(
            name="serving_availability",
            objective=objective,
            good=(
                ("serving_placements_total", (("outcome", "placed"),)),
                ("serving_placements_total", (("outcome", "no_candidate"),)),
            ),
            bad=(
                ("serving_placements_total", (("outcome", "shed"),)),
                ("serving_placements_total", (("outcome", "timeout"),)),
            ),
        ),
        SloSpec(
            name="rounds_success",
            objective=objective,
            good=(("rounds_total", ()),),
            bad=(
                ("rounds_skipped_total", ()),
                ("degraded_rounds_total", ()),
            ),
        ),
    ]
    if latency_threshold_ms > 0:
        specs.append(
            SloSpec(
                name="serving_latency",
                objective=objective,
                kind="latency",
                family="serving_request_seconds",
                labels=(("stage", "total"),),
                threshold_s=latency_threshold_ms / 1000.0,
            )
        )
    return tuple(s.validate() for s in specs)


class SloEngine:
    """Compiles :class:`SloSpec`s against a :class:`SeriesStore` and
    evaluates budget + burn each tick.

    ``evaluate`` returns the burn-rule entries for
    ``Watchdog.observe_slo_burn`` (worst spec wins per rule) and
    publishes ``slo_budget_remaining_frac{slo}`` /
    ``slo_burn_rate{slo,window}`` gauges; ``table()`` is the /slo
    endpoint's cached readout."""

    def __init__(
        self,
        specs: Sequence[SloSpec],
        store: SeriesStore,
        *,
        registry: MetricsRegistry | None = None,
        budget_window: int = 512,
        fast_window: int = 48,
        fast_burn: float = 14.4,
        slow_window: int = 288,
        slow_burn: float = 6.0,
        tenant_series: Any = None,
    ) -> None:
        self.specs = tuple(s.validate() for s in specs)
        self.store = store
        self.registry = registry
        self.budget_window = int(budget_window)
        self.fast_window = int(fast_window)
        self.fast_burn = float(fast_burn)
        self.slow_window = int(slow_window)
        self.slow_burn = float(slow_burn)
        self.tenant_series = tenant_series
        self._table: list[dict[str, Any]] = []
        # tenant -> [good, bad]; populated ONLY while the TenantSeries
        # gate is enabled (tenants <= budget), so it is budget-bounded
        self._tenant_events: dict[str, list[float]] = {}

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    # ---- event extraction ----

    def _selector_delta(self, sel: Selector, window: int) -> float:
        metric, labels = sel
        return sum(
            self.store.delta(name, window)
            for name in self.store.match(metric, labels)
        )

    def _events(self, spec: SloSpec, window: int) -> tuple[float, float]:
        """(good, bad) event counts over the trailing ``window`` ticks."""
        if spec.kind == "events":
            good = sum(self._selector_delta(s, window) for s in spec.good)
            bad = sum(self._selector_delta(s, window) for s in spec.bad)
            return good, bad
        # latency kind: per underlying histogram series, good = the
        # cumulative count of the smallest bucket covering the
        # threshold, bad = total count minus that
        buckets: dict[str, list[tuple[float, str]]] = {}
        totals: dict[str, str] = {}
        for name in self.store.match(spec.family, spec.labels):
            label_part = "{" + name.split("{", 1)[1] if "{" in name else ""
            if ":le:" in name:
                ub = name.partition(":le:")[2].split("{", 1)[0]
                buckets.setdefault(label_part, []).append((float(ub), name))
            elif ":" not in name.split("{", 1)[0].removeprefix(spec.family):
                totals[label_part] = name  # bare count series, not :sum
        good = bad = 0.0
        for label_part, edges in buckets.items():
            covering = min(
                (e for e in edges if e[0] + 1e-12 >= spec.threshold_s),
                default=None,
            )
            total_name = totals.get(label_part)
            if covering is None or total_name is None:
                continue
            under = self.store.delta(covering[1], window)
            total = self.store.delta(total_name, window)
            good += under
            bad += max(total - under, 0.0)
        return good, bad

    # ---- evaluation ----

    def burn_rate(self, spec: SloSpec, window: int) -> float:
        """error_frac / (1 - objective) over the trailing window: 1.0
        burns the budget exactly at its sustainable rate, 0 with no
        traffic."""
        good, bad = self._events(spec, window)
        total = good + bad
        if total <= 0:
            return 0.0
        return (bad / total) / (1.0 - spec.objective)

    def evaluate(self, tick: int) -> dict[str, dict[str, Any]]:
        """One evaluation pass at ``tick``; call after the store sampled
        this tick's snapshot. Returns ``{rule: detail}`` burn entries
        for the watchdog (empty when nothing burns)."""
        reg = self._reg()
        table: list[dict[str, Any]] = []
        entries: dict[str, dict[str, Any]] = {}
        for spec in self.specs:
            good_b, bad_b = self._events(spec, self.budget_window)
            total_b = good_b + bad_b
            allowed = (1.0 - spec.objective) * total_b
            remaining = (
                1.0
                if total_b <= 0
                else max(0.0, min(1.0, 1.0 - bad_b / max(allowed, 1e-12)))
            )
            fast = self.burn_rate(spec, self.fast_window)
            fast_short = self.burn_rate(spec, _short_window(self.fast_window))
            slow = self.burn_rate(spec, self.slow_window)
            slow_short = self.burn_rate(spec, _short_window(self.slow_window))
            # ticks until the remaining budget is gone at the current
            # fast-window bad-event rate (None when not burning)
            tte = None
            if bad_b > 0:
                bad_rate = self._events(spec, self.fast_window)[1] / max(
                    self.fast_window, 1
                )
                if bad_rate > 0:
                    tte = max(allowed - bad_b, 0.0) / bad_rate
            row = {
                "slo": spec.name,
                "objective": spec.objective,
                "budget_remaining_frac": round(remaining, 6),
                "burn_fast": round(fast, 4),
                "burn_fast_short": round(fast_short, 4),
                "burn_slow": round(slow, 4),
                "burn_slow_short": round(slow_short, 4),
                "good": good_b,
                "bad": bad_b,
                "budget_window": self.budget_window,
                "time_to_exhaustion": (
                    round(tte, 1) if tte is not None else None
                ),
                "tick": int(tick),
            }
            table.append(row)
            reg.gauge(
                "slo_budget_remaining_frac",
                "fraction of the SLO error budget remaining over the "
                "budget window (1.0 = untouched)",
                labelnames=("slo",),
            ).labels(slo=spec.name).set(round(remaining, 6))
            burn_gauge = reg.gauge(
                "slo_burn_rate",
                "error-budget burn rate over the paired alert windows "
                "(1.0 = sustainable consumption)",
                labelnames=("slo", "window"),
            )
            burn_gauge.labels(slo=spec.name, window="fast").set(round(fast, 4))
            burn_gauge.labels(slo=spec.name, window="slow").set(round(slow, 4))
            for rule, burn, short, window, threshold in (
                (RULE_FAST_BURN, fast, fast_short, self.fast_window, self.fast_burn),
                (RULE_SLOW_BURN, slow, slow_short, self.slow_window, self.slow_burn),
            ):
                if threshold <= 0:
                    continue
                # multi-window confirm: both the long window and its
                # 1/12 confirm window must exceed the threshold
                if burn >= threshold and short >= threshold:
                    detail = {
                        "slo": spec.name,
                        "burn_rate": round(burn, 4),
                        "burn_rate_short": round(short, 4),
                        "window": window,
                        "short_window": _short_window(window),
                        "threshold": threshold,
                        "budget_remaining_frac": round(remaining, 6),
                        "time_to_exhaustion": row["time_to_exhaustion"],
                        "value": round(burn, 4),
                    }
                    prev = entries.get(rule)
                    if prev is None or detail["burn_rate"] > prev["burn_rate"]:
                        entries[rule] = detail
        self._table = table
        return entries

    def table(self) -> list[dict[str, Any]]:
        """The last evaluation's budget/burn table (the /slo payload)."""
        return [dict(row) for row in self._table]

    # ---- per-tenant budgets (fleet mode) ----

    def observe_tenant_round(self, tenant: str, ok: bool) -> None:
        """Account one tenant round against the per-tenant budget and
        publish ``slo_tenant_budget_remaining_frac`` through the
        TenantSeries gate. With the gate disabled (tenant count over
        the label budget) nothing is stored — the suppressed publish is
        counted by the gate itself, keeping this T-independent."""
        ts = self.tenant_series
        if ts is None or not getattr(ts, "enabled", False):
            if ts is not None:
                # over budget: route one (suppressed, counted) publish
                # through the gate so the drop is observable
                ts.gauge_set(
                    "slo_tenant_budget_remaining_frac",
                    "per-tenant SLO error budget remaining "
                    "(TenantSeries-gated)",
                    tenant,
                    1.0,
                )
            return
        good_bad = self._tenant_events.setdefault(tenant, [0.0, 0.0])
        good_bad[0 if ok else 1] += 1.0
        good, bad = good_bad
        objective = self.specs[0].objective if self.specs else 0.99
        allowed = (1.0 - objective) * (good + bad)
        remaining = (
            1.0
            if good + bad <= 0
            else max(0.0, min(1.0, 1.0 - bad / max(allowed, 1e-12)))
        )
        ts.gauge_set(
            "slo_tenant_budget_remaining_frac",
            "per-tenant SLO error budget remaining (TenantSeries-gated)",
            tenant,
            round(remaining, 6),
        )

    def tenant_budgets(self) -> dict[str, float]:
        out = {}
        for tenant, (good, bad) in sorted(self._tenant_events.items()):
            objective = self.specs[0].objective if self.specs else 0.99
            allowed = (1.0 - objective) * (good + bad)
            out[tenant] = (
                1.0
                if good + bad <= 0
                else max(0.0, min(1.0, 1.0 - bad / max(allowed, 1e-12)))
            )
        return out
