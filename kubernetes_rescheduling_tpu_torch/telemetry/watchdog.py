"""Rolling-window SLO watchdog for the control loop.

Three rule families, each optional, evaluated after every executed round
over a bounded window of recent rounds:

- **round latency p95** — the p95 of per-round device decision latency
  exceeds ``latency_p95_s`` (0 disables);
- **comm-cost regression** — the latest round's communication cost rose
  more than ``cost_regression_frac`` above the window's best (0 disables);
- **retrace** — any captured function re-captured while being watched:
  its ``cuda_graph_captures_total`` (``solver/compiled.py``; the JAX
  package reads ``jax_traces_total``) rose ``max_retraces`` or more above
  the BASELINE captured when the watchdog first saw it (0 disables; the
  steady-state invariant is no new traces — one more means every round
  is paying a recompile). Baselines — and the rolling windows — reset on
  :meth:`Watchdog.rebase`, which the ops plane calls when a new run
  binds, so a bench session's later cells compiling fresh shapes are not
  misread as retraces. Under elastic churn a counted **bucket
  promotion** (``RoundRecord.churn["promotions"]``) legitimately
  recompiles every kernel once — each promotion observed since the
  baseline raises the per-fn allowance by one, so the rule flags only
  retraces a promotion does NOT explain.

A fourth rule is fed EXTERNALLY rather than per round: **perf
regression** (:meth:`Watchdog.observe_perf`) takes the perf ledger's
rolling-window verdicts (``telemetry.perf_ledger.detect``) — the bench
harness calls it after each cell. A newly regressed metric increments
``perf_regressions_total{metric}`` (plus the generic
``slo_violations_total{rule="perf_regression"}`` on rule entry), and the
rule stays active until a later verdict set clears the metric. Unlike the
per-round windows, perf state survives :meth:`rebase` — it describes the
ledger's cross-run history, not the current run's window.

A fifth rule kind is the SLO v2 burn pair (``slo_fast_burn`` /
``slo_slow_burn``): the error-budget engine (:mod:`telemetry.slo`)
evaluates multi-window burn rates over the history plane and feeds the
currently-firing entries via :meth:`Watchdog.observe_slo_burn` — the
watchdog just does the entry/recovery bookkeeping, so burn alerts count,
log, and flip /healthz exactly like the native rules.

Entering violation increments ``slo_violations_total{rule}`` and logs an
``slo_violation`` event; leaving logs ``slo_recovered``. The set of
currently-active violations (:attr:`Watchdog.active`) is what flips
``/healthz`` unhealthy — a rule that recovers un-flips it. Every active
entry carries the uniform ``{rule, value, threshold, since}`` quartet on
top of its rule-specific detail, so /healthz consumers render legacy
threshold rules and burn-rate rules identically.

The port's copy of ``kubernetes_rescheduling_tpu.telemetry.watchdog``
(stdlib only): fed the same record dicts, the two give the same verdicts.
The ``perf_regression`` verdicts come through :meth:`Watchdog.observe_perf`
from ``perf_ledger.detect`` (the bench harness after each cell, ``reschedule
--perf-ledger`` after its run); the ``shadow_win_rate`` rule reads the
rounds' shadow blocks, and the ``mesh_imbalance`` rule the mesh plane's
summaries (:meth:`Watchdog.observe_mesh`: the dp fleet loop and
``bench_multichip`` through ``OpsPlane.observe_device_rollup``).
"""

from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass
from typing import Any

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)

RULE_LATENCY = "round_latency_p95"
RULE_COST = "comm_cost_regression"
RULE_RETRACE = "retrace"
RULE_PERF = "perf_regression"
RULE_ATTRIBUTION = "attribution_drift"
RULE_FORECAST = "forecast_skill"
RULE_PIPELINE = "pipeline_overlap"
RULE_RECONCILE = "reconcile_divergence"
RULE_SHADOW = "shadow_win_rate"
RULE_FLEET_TAIL = "fleet_tail_cost"
RULE_SCAN_TRIPWIRE = "scan_tripwire"
RULE_SERVING = "serving_p99"
RULE_MESH = "mesh_imbalance"

# the counter the retrace rule watches: one a CUDA graph capture
# (solver/compiled.py), the port's jax_traces_total
CAPTURES_METRIC = "cuda_graph_captures_total"


@dataclass(frozen=True)
class SLORules:
    """Thresholds; a zero threshold disables its rule."""

    window: int = 20
    min_samples: int = 5            # rounds before latency/cost rules judge
    latency_p95_s: float = 0.0
    cost_regression_frac: float = 0.0
    max_retraces: int = 1
    # attribution drift: the top-1 service edge's share of total
    # communication cost exceeding this fraction means one edge dominates
    # the objective — the placement (or the traffic estimate feeding it)
    # has collapsed onto a single hot pair (0 disables; needs per-round
    # attribution records — see telemetry.attribution)
    attribution_drift_frac: float = 0.0
    # forecast skill: a TRAINED forecaster whose running skill (1 −
    # mae_model/mae_persistence) sits below this threshold is losing to
    # the free persistence baseline — the proactive policy is paying
    # model risk for nothing (the controller's device-side gate has
    # already degraded those rounds to reactive CAR; this rule makes the
    # condition a visible SLO). Only rounds carrying forecast data are
    # judged, so reactive runs can never trip it. The natural threshold
    # is 0.0 — "at least tie persistence".
    forecast_min_skill: float = 0.0
    # pipeline overlap collapse: the rolling mean overlap_ratio of
    # pipelined rounds (RoundRecord.pipeline — the fraction of background
    # boundary time hidden behind foreground work) sitting below this
    # means the pipelined loop has degenerated to sequential round-trips
    # — the wall-clock win the perf ledger's wall_round_ms series gates
    # is silently gone (0 disables; only rounds carrying pipeline
    # telemetry are judged, so sequential runs can never trip it).
    pipeline_min_overlap: float = 0.0
    # reconcile divergence: the latest round's reconcile block
    # (RoundRecord.reconcile — the intent ledger's accounting) reports at
    # least this many pods STILL diverged from the controller's intent
    # after the round's corrective moves — drift is outrunning the repair
    # budget, or repairs cannot land (0 disables; 1 = any persistent
    # drift; only rounds carrying reconcile data are judged, so runs with
    # the plane off can never trip it).
    reconcile_max_drift_pods: int = 0
    # fleet tail cost: the p99 of the fleet's per-tenant communication
    # cost rollup (telemetry.fleet_rollup — observe_fleet_rollup feeds
    # it) rising more than this fraction above the rolling window's
    # best means the fleet's WORST tenants are regressing even if the
    # median looks fine — exactly the signal per-tenant series used to
    # carry and the cardinality budget suppressed (0 disables; only
    # runs feeding rollups are judged; the window resets on rebase,
    # like the cost rule, so a new run's cost scale is never misjudged)
    fleet_tail_frac: float = 0.0
    # fleet tenant-state TTL: per-source state keyed by tenant (the
    # reconcile blocks) is pruned once a tenant goes unseen for this
    # many observed rounds — under tenant churn the dict would
    # otherwise grow without bound (counted
    # watchdog_tenants_pruned_total; 0 disables pruning)
    tenant_ttl_rounds: int = 100
    # shadow win-rate: the latest scored shadow round's RUNNING win-rate
    # against the replayed trace's actual scheduler sitting below this
    # means the shadow run is losing the head-to-head — promoting these
    # recommendations to a live cluster would make placement worse (0
    # disables; only rounds carrying shadow data are judged, so live
    # runs can never trip it; min_samples scored rounds before judging).
    shadow_min_win_rate: float = 0.0
    # scan tripwire: a scan block whose in-trace tripwire plane tripped
    # (telemetry.tripwire — the controller feeds the decoded trip via
    # observe_scan_block) is an active violation until a CLEAN block
    # lands — the device itself judged the block unhealthy, so /healthz
    # must say so (False disables; only scan runs feed blocks, so the
    # per-round path can never trip it)
    scan_tripwire: bool = True
    # serving p99: the serving plane's rolling-window p99 request latency
    # (ms, end-to-end: queue-wait through decode — ServingEngine feeds a
    # summary after every dispatched batch via observe_serving) exceeding
    # this threshold is a violation; the window draining back under it
    # recovers. Judged only once the rolling window holds min_samples
    # completed requests, so a cold-start compile spike on the first
    # request cannot flip /healthz on its own (0 disables; only serving
    # runs feed summaries, so round-only runs can never trip it).
    serving_p99_ms: float = 0.0
    # mesh imbalance: the device plane's worst/median attributed
    # per-device step-time ratio (telemetry.mesh — the controller feeds
    # the latest device-rollup summary via observe_mesh) exceeding this
    # means one dp device is pacing the whole mesh — a straggler chip, a
    # skewed tenant block, or a failing interconnect. Judged only on
    # meshes with >= 2 devices, so single-chip runs (where the ratio is
    # definitionally 1) can never trip it; a later balanced round
    # recovers. 0 disables; thresholds below 1 are rejected (the ratio
    # can never sit below 1).
    mesh_imbalance_ratio: float = 0.0

    def validate(self) -> "SLORules":
        if self.window < 2:
            raise ValueError("window must be >= 2")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        for name in ("latency_p95_s", "cost_regression_frac"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.max_retraces < 0:
            raise ValueError("max_retraces must be >= 0")
        if not (0.0 <= self.attribution_drift_frac <= 1.0):
            raise ValueError("attribution_drift_frac must be in [0, 1]")
        if self.forecast_min_skill > 1.0:
            raise ValueError(
                "forecast_min_skill must be <= 1.0 (skill is bounded "
                "above by 1)"
            )
        if not (0.0 <= self.pipeline_min_overlap <= 1.0):
            raise ValueError(
                "pipeline_min_overlap must be in [0, 1] (overlap_ratio "
                "is a fraction)"
            )
        if self.reconcile_max_drift_pods < 0:
            raise ValueError(
                "reconcile_max_drift_pods must be >= 0 (0 disables the "
                "reconcile_divergence rule)"
            )
        if not (0.0 <= self.shadow_min_win_rate <= 1.0):
            raise ValueError(
                "shadow_min_win_rate must be in [0, 1] (a win-rate "
                "fraction; 0 disables the shadow_win_rate rule)"
            )
        if self.fleet_tail_frac < 0:
            raise ValueError(
                "fleet_tail_frac must be >= 0 (0 disables the "
                "fleet_tail_cost rule)"
            )
        if self.tenant_ttl_rounds < 0:
            raise ValueError(
                "tenant_ttl_rounds must be >= 0 (0 disables per-tenant "
                "state pruning)"
            )
        if self.serving_p99_ms < 0:
            raise ValueError(
                "serving_p99_ms must be >= 0 (0 disables the serving_p99 "
                "rule)"
            )
        if self.mesh_imbalance_ratio != 0.0 and self.mesh_imbalance_ratio < 1.0:
            raise ValueError(
                "mesh_imbalance_ratio must be 0 (rule off) or >= 1 "
                "(worst/median step time can never sit below 1)"
            )
        return self


def _p95(samples: list[float]) -> float:
    s = sorted(samples)
    idx = max(math.ceil(0.95 * len(s)) - 1, 0)
    return s[idx]


class Watchdog:
    """Feed it one completed round at a time; read ``active`` for health."""

    def __init__(
        self,
        rules: SLORules | None = None,
        *,
        registry: MetricsRegistry | None = None,
        logger=None,
    ) -> None:
        self.rules = (rules or SLORules()).validate()
        self.registry = registry
        self.logger = logger
        self._lat: collections.deque[float] = collections.deque(
            maxlen=self.rules.window
        )
        self._cost: collections.deque[float] = collections.deque(
            maxlen=self.rules.window
        )
        self._trace_base: dict[str, float] = {}
        # elastic churn: cumulative bucket promotions last seen / the
        # allowance accrued since (re)base — each promotion excuses one
        # retrace per fn (the ONLY legal churn recompile)
        self._promo_seen: int | None = None
        self._promo_allow: int = 0
        self._perf_active: dict[str, dict[str, Any]] = {}
        self._attr: dict[str, Any] | None = None  # latest round's attribution
        self._forecast: dict[str, Any] | None = None  # latest round's forecast
        # latest reconcile block PER SOURCE (solo runs key None; fleet
        # tenants key their name): the rule judges the worst source, so
        # one tenant's convergence can never mask another's drift
        self._reconcile: dict[str | None, dict[str, Any]] = {}
        # last round index each tenant was seen at — per-tenant state is
        # PRUNED once unseen for tenant_ttl_rounds (counted), so tenant
        # churn cannot grow the per-source dicts without bound
        self._tenant_seen: dict[str, int] = {}
        self._last_round: int = 0
        self._shadow: dict[str, Any] | None = None  # latest shadow block
        # latest scan block's decoded trip (None = last block was clean
        # or no scan block observed yet) — observe_scan_block feeds it
        self._scan_trip: dict[str, Any] | None = None
        # latest serving-plane summary (observe_serving feeds it after
        # every dispatched batch; its p99_ms/count judge the serving rule)
        self._serving: dict[str, Any] | None = None
        # latest device-rollup summary (observe_mesh feeds it once per
        # fleet round/scan block; its ratio/n_devices judge the
        # mesh_imbalance rule)
        self._mesh: dict[str, Any] | None = None
        # latest SLO-engine burn entries (observe_slo_burn feeds them
        # each history-plane tick; merged into `now` verbatim so burn
        # rules ride the same entry/recovery bookkeeping)
        self._slo_burn: dict[str, dict[str, Any]] = {}
        # rule -> wall time it entered violation (the structured
        # /healthz verdicts' `since` field; cleared on recovery)
        self._since: dict[str, float] = {}
        # fleet cost-rollup tail (p99 per fleet round) — rolling window
        self._fleet_tail: collections.deque[float] = collections.deque(
            maxlen=self.rules.window
        )
        # pipelined rounds' overlap ratios (rolling window)
        self._overlap: collections.deque[float] = collections.deque(
            maxlen=self.rules.window
        )
        self.active: dict[str, dict[str, Any]] = {}
        self.violations_seen = 0

    def rebase(self) -> None:
        """Start a fresh observation window: clear the rolling latency/
        cost windows, retrace baselines, and active violations. Called
        when a new run binds to the ops plane — cross-run comparisons
        (a different algorithm's cost scale, a new shape's first
        compile) are not SLO signals. Perf-ledger regressions are NOT
        cleared: they judge cross-run history by design, and a new cell
        binding must not mask yesterday's cliff — only a recovered
        verdict set (:meth:`observe_perf`) clears them."""
        self._lat.clear()
        self._cost.clear()
        self._trace_base.clear()
        self._promo_seen = None
        self._promo_allow = 0
        self._attr = None
        self._forecast = None
        self._reconcile = {}
        self._tenant_seen = {}
        self._last_round = 0
        self._shadow = None
        self._scan_trip = None
        self._serving = None
        self._mesh = None
        self._slo_burn = {}
        self._overlap.clear()
        self._fleet_tail.clear()
        self.active = (
            {RULE_PERF: self.active[RULE_PERF]}
            if RULE_PERF in self.active
            else {}
        )
        self._since = {
            rule: t for rule, t in self._since.items() if rule in self.active
        }

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    def observe_round(self, record, tenant=None) -> list[dict[str, Any]]:
        """Record one executed round and re-evaluate every rule. Returns
        the NEWLY raised violations (already counted and logged).
        ``tenant`` names the fleet tenant the round belongs to (None for
        solo runs) — per-source state like the reconcile block keys on
        it so interleaved tenant rounds never mask each other."""
        self._lat.append(float(record.decision_latency_s))
        self._cost.append(float(record.communication_cost))
        attr = getattr(record, "attribution", None)
        if isinstance(attr, dict):
            self._attr = attr
        forecast = getattr(record, "forecast", None)
        if isinstance(forecast, dict):
            self._forecast = forecast
        reconcile = getattr(record, "reconcile", None)
        if isinstance(reconcile, dict):
            self._reconcile[tenant] = reconcile
        rnd = getattr(record, "round", None)
        advanced = isinstance(rnd, (int, float)) and int(rnd) > self._last_round
        if advanced:
            self._last_round = int(rnd)
        if tenant is not None:
            self._tenant_seen[tenant] = self._last_round
        if advanced:
            # prune once per ROUND, not per tenant-observation: a fleet
            # round fans T observe_round calls through here, and nothing
            # new can expire until the round index moves
            self._prune_tenants()
        shadow = getattr(record, "shadow", None)
        if isinstance(shadow, dict):
            self._shadow = shadow
        pipeline = getattr(record, "pipeline", None)
        if isinstance(pipeline, dict) and "overlap_ratio" in pipeline:
            self._overlap.append(float(pipeline["overlap_ratio"]))
        churn = getattr(record, "churn", None)
        if isinstance(churn, dict):
            p = churn.get("promotions")
            if isinstance(p, (int, float)):
                p = int(p)
                if self._promo_seen is None:
                    # promotions that pre-date the watch are baselined
                    # away, exactly like the trace baselines
                    self._promo_seen = p
                elif p > self._promo_seen:
                    self._promo_allow += p - self._promo_seen
                    self._promo_seen = p
        return self.check()

    def _prune_tenants(self) -> None:
        """Drop per-tenant state (the reconcile blocks) for tenants
        unseen for ``tenant_ttl_rounds`` rounds — the churn-proofing
        half of the per-source design: without it a fleet that retires
        tenants would grow the dicts forever, and a long-gone tenant's
        stale drift block could hold the reconcile rule in violation."""
        ttl = self.rules.tenant_ttl_rounds
        if ttl <= 0 or not self._tenant_seen:
            return
        dead = [
            t
            for t, seen in self._tenant_seen.items()
            if self._last_round - seen > ttl
        ]
        for t in dead:
            self._tenant_seen.pop(t, None)
            self._reconcile.pop(t, None)
            self._reg().counter(
                "watchdog_tenants_pruned_total",
                "per-tenant watchdog state entries pruned after the "
                "tenant went unseen for tenant_ttl_rounds rounds",
            ).inc()

    def observe_fleet_rollup(
        self, rollup: dict[str, Any]
    ) -> list[dict[str, Any]]:
        """Feed one fleet round's decoded tenant rollup
        (``telemetry.fleet_rollup.decode_rollup``): the p99 of the
        per-tenant cost dimension joins the rolling tail window the
        ``fleet_tail_cost`` rule judges. Returns the newly raised
        violations, like :meth:`observe_round`."""
        try:
            p99 = float(rollup["dims"]["cost"]["quantiles"]["p99"])
        except (KeyError, TypeError):
            return []
        self._fleet_tail.append(p99)
        return self.check()

    def observe_scan_block(
        self, trip: dict[str, Any] | None
    ) -> list[dict[str, Any]]:
        """Feed one scan block's tripwire verdict (the controller's
        decoded trip dict, or None for a clean block). A tripped block
        arms the ``scan_tripwire`` rule; the next clean block clears it
        — the device's own health verdict, surfaced on /healthz.
        Returns the newly raised violations, like
        :meth:`observe_round`."""
        self._scan_trip = dict(trip) if trip is not None else None
        return self.check()

    def observe_serving(
        self, summary: dict[str, Any] | None
    ) -> list[dict[str, Any]]:
        """Feed the serving plane's latest rolling-window summary
        (``ServingEngine.summary()`` — the engine calls this through
        ``OpsPlane.observe_serving`` after every dispatched batch). The
        summary's ``p99_ms`` over ``count`` completed requests judges the
        ``serving_p99`` rule; a later summary whose window has drained
        back under the threshold recovers it. Returns the newly raised
        violations, like :meth:`observe_round`."""
        self._serving = dict(summary) if summary is not None else None
        return self.check()

    def observe_mesh(
        self, summary: dict[str, Any] | None
    ) -> list[dict[str, Any]]:
        """Feed the device plane's latest rollup summary
        (``telemetry.mesh.MeshPlane.observe_block`` — the fleet loop
        calls this through ``OpsPlane.observe_device_rollup`` once per
        round/block). The summary's worst/median step-time ``ratio``
        over ``n_devices`` judges the ``mesh_imbalance`` rule; a later
        balanced round recovers it. Returns the newly raised
        violations, like :meth:`observe_round`."""
        self._mesh = dict(summary) if summary is not None else None
        return self.check()

    def observe_slo_burn(
        self, entries: dict[str, dict[str, Any]]
    ) -> list[dict[str, Any]]:
        """Feed the SLO engine's burn-rule entries for this tick
        (``telemetry.slo.SloEngine.evaluate`` — rule name to detail dict,
        empty when nothing burns). Burn rules ride the same
        entry/recovery bookkeeping as every other rule: newly burning
        counts ``slo_violations_total{rule}``, the burn dropping back
        under threshold recovers. Returns the newly raised violations,
        like :meth:`observe_round`."""
        self._slo_burn = {
            rule: dict(detail) for rule, detail in (entries or {}).items()
        }
        return self.check()

    def observe_perf(self, verdicts: dict[str, dict[str, Any]]) -> list[dict[str, Any]]:
        """Feed one perf-ledger verdict set (``perf_ledger.detect``).
        Metrics whose status is ``regressed`` arm the ``perf_regression``
        rule; each NEWLY regressed metric counts once in
        ``perf_regressions_total{metric}``. A verdict set with no
        regressions clears the rule (the recovery path). Returns the
        newly raised violations, like :meth:`observe_round`."""
        regressed = {
            k: v for k, v in (verdicts or {}).items()
            if v.get("status") == "regressed"
        }
        for key in regressed:
            if key not in self._perf_active:
                self._reg().counter(
                    "perf_regressions_total",
                    "perf-ledger metrics newly judged regressed",
                    labelnames=("metric",),
                ).labels(metric=key).inc()
        self._perf_active = regressed
        return self.check()

    def _uniform(
        self, rule: str, detail: dict[str, Any]
    ) -> tuple[float, float]:
        """(value, threshold) for the uniform verdict shape — the
        measured quantity that tripped the rule and the boundary it
        crossed. Rules whose detail already carries the pair (the burn
        rules) are left alone by the setdefault in :meth:`check`."""
        r = self.rules
        if rule == RULE_LATENCY:
            return detail.get("p95_s", 0.0), detail.get("threshold_s", 0.0)
        if rule == RULE_COST:
            base = detail.get("baseline", 0.0)
            return (
                detail.get("cost", 0.0),
                base * (1.0 + detail.get("threshold_frac", 0.0)),
            )
        if rule == RULE_RETRACE:
            return float(len(detail.get("fns") or ())), float(
                detail.get("max_retraces", r.max_retraces)
            )
        if rule == RULE_ATTRIBUTION:
            return detail.get("share", 0.0), detail.get("threshold_frac", 0.0)
        if rule == RULE_FORECAST:
            return detail.get("skill", 0.0), detail.get("threshold", 0.0)
        if rule == RULE_PIPELINE:
            return (
                detail.get("overlap_ratio_mean", 0.0),
                detail.get("threshold", 0.0),
            )
        if rule == RULE_RECONCILE:
            return float(detail.get("drift_pods", 0)), float(
                detail.get("threshold", 0)
            )
        if rule == RULE_FLEET_TAIL:
            base = detail.get("baseline", 0.0)
            return (
                detail.get("p99_cost", 0.0),
                base * (1.0 + detail.get("threshold_frac", 0.0)),
            )
        if rule == RULE_SHADOW:
            return detail.get("win_rate", 0.0), detail.get("threshold", 0.0)
        if rule == RULE_SERVING:
            return detail.get("p99_ms", 0.0), detail.get("threshold_ms", 0.0)
        if rule == RULE_MESH:
            return detail.get("ratio", 0.0), detail.get(
                "threshold_ratio", 0.0
            )
        if rule == RULE_PERF:
            return float(detail.get("count", 0)), 0.0
        # scan_tripwire and anything without a numeric axis: the device
        # latched a boolean verdict — 1 over a 0 threshold
        return 1.0, 0.0

    def check(self) -> list[dict[str, Any]]:
        r = self.rules
        now: dict[str, dict[str, Any]] = {}
        if r.latency_p95_s > 0 and len(self._lat) >= r.min_samples:
            p95 = _p95(list(self._lat))
            if p95 > r.latency_p95_s:
                now[RULE_LATENCY] = {
                    "p95_s": p95, "threshold_s": r.latency_p95_s,
                    "window": len(self._lat),
                }
        # the baseline excludes the latest sample, so the rule needs at
        # least 2 samples whatever min_samples says
        if r.cost_regression_frac > 0 and len(self._cost) >= max(r.min_samples, 2):
            latest = self._cost[-1]
            baseline = min(list(self._cost)[:-1])
            if baseline > 0 and latest > (1.0 + r.cost_regression_frac) * baseline:
                now[RULE_COST] = {
                    "cost": latest, "baseline": baseline,
                    "threshold_frac": r.cost_regression_frac,
                }
        if r.max_retraces > 0:
            # compare against the count first seen for each fn, not the
            # cumulative total: a fresh shape compiling once (a later
            # bench cell, the explain kernel's first round) is not a
            # retrace — only growth while under watch is
            retraced = {}
            for rec in self._reg().snapshot():
                if rec["metric"] != CAPTURES_METRIC:
                    continue
                fn = rec["labels"].get("fn", "?")
                v = rec.get("value", 0)
                base = self._trace_base.setdefault(fn, v)
                # each counted bucket promotion explains one retrace per
                # fn — only growth BEYOND the promotion allowance is an
                # SLO signal (the elastic invariant: 1 steady-state
                # trace plus exactly the counted promotions)
                if v - base - self._promo_allow >= r.max_retraces:
                    retraced[fn] = v
            if retraced:
                now[RULE_RETRACE] = {
                    "fns": retraced, "max_retraces": r.max_retraces,
                    "promotions_allowed": self._promo_allow,
                }
        if r.attribution_drift_frac > 0 and self._attr is not None:
            # the LATEST round's attribution judges: one edge carrying
            # more than the configured fraction of total cost means the
            # objective has collapsed onto a single hot pair
            edges = self._attr.get("edges") or ()
            total = self._attr.get("total") or 0.0
            if edges and total > 0:
                top = edges[0]
                share = top.get("cost", 0.0) / total
                if share > r.attribution_drift_frac:
                    now[RULE_ATTRIBUTION] = {
                        "edge": f"{top.get('src_service')}->{top.get('dst_service')}",
                        "share": share,
                        "threshold_frac": r.attribution_drift_frac,
                        "total": total,
                    }
        if self._forecast is not None and self._forecast.get("trained"):
            # the LATEST round's forecast block judges: a trained model
            # below the skill floor is losing to the free persistence
            # baseline (the controller's device gate has already
            # degraded the delta — this surfaces it on /healthz)
            skill = float(self._forecast.get("skill", 0.0))
            if skill < r.forecast_min_skill:
                now[RULE_FORECAST] = {
                    "skill": skill,
                    "threshold": r.forecast_min_skill,
                    "mae_model": self._forecast.get("mae_model"),
                    "mae_persistence": self._forecast.get("mae_persistence"),
                    "mode": self._forecast.get("mode"),
                }
        if r.pipeline_min_overlap > 0 and len(self._overlap) >= r.min_samples:
            # overlap collapse: the rolling MEAN of pipelined rounds'
            # hidden-background fraction — one slow flush is noise, a
            # window of them means the pipeline is sequential again
            mean = sum(self._overlap) / len(self._overlap)
            if mean < r.pipeline_min_overlap:
                now[RULE_PIPELINE] = {
                    "overlap_ratio_mean": mean,
                    "threshold": r.pipeline_min_overlap,
                    "window": len(self._overlap),
                }
        if r.reconcile_max_drift_pods > 0 and self._reconcile:
            # each source's LATEST round carrying reconcile data judges,
            # and the WORST source decides: pods still diverged from
            # intent after that round's corrective moves means drift is
            # outrunning the repair budget (or repairs cannot land — a
            # dead target, a frozen boundary). In fleet mode sources are
            # tenants, so one tenant converging (drift_pods=0) can never
            # mask another tenant's persistent drift
            tenant, worst = max(
                self._reconcile.items(),
                key=lambda kv: int(kv[1].get("drift_pods") or 0),
            )
            drift = int(worst.get("drift_pods") or 0)
            if drift >= r.reconcile_max_drift_pods:
                now[RULE_RECONCILE] = {
                    "drift_pods": drift,
                    "threshold": r.reconcile_max_drift_pods,
                    "divergences": len(worst.get("divergences") or ()),
                    "repairs_issued": len(worst.get("repairs") or ()),
                    **({"tenant": tenant} if tenant is not None else {}),
                }
        if r.fleet_tail_frac > 0 and len(self._fleet_tail) >= max(
            r.min_samples, 2
        ):
            # the cost-regression rule's shape, applied to the fleet's
            # TAIL: the latest round's p99 cost rollup vs the window's
            # best — the worst tenants regressing is an SLO signal even
            # while the fleet median holds (the baseline excludes the
            # latest sample, so >= 2 samples whatever min_samples says)
            latest = self._fleet_tail[-1]
            baseline = min(list(self._fleet_tail)[:-1])
            if baseline > 0 and latest > (1.0 + r.fleet_tail_frac) * baseline:
                now[RULE_FLEET_TAIL] = {
                    "p99_cost": latest,
                    "baseline": baseline,
                    "threshold_frac": r.fleet_tail_frac,
                    "window": len(self._fleet_tail),
                }
        if (
            r.shadow_min_win_rate > 0
            and self._shadow is not None
            and int(self._shadow.get("scored") or 0) >= r.min_samples
        ):
            # the latest scored round's RUNNING win-rate judges: a
            # shadow run losing the head-to-head means promoting these
            # recommendations would make real placement worse
            win_rate = float(self._shadow.get("win_rate") or 0.0)
            if win_rate < r.shadow_min_win_rate:
                now[RULE_SHADOW] = {
                    "win_rate": win_rate,
                    "threshold": r.shadow_min_win_rate,
                    "scored": int(self._shadow.get("scored") or 0),
                    "cost_delta": self._shadow.get("cost_delta"),
                }
        if r.serving_p99_ms > 0 and self._serving is not None:
            # the latest serving summary judges: its p99 is already a
            # rolling-window statistic (the engine's bounded recent-total
            # deque), so fast requests pushing slow ones out of the
            # window IS the recovery path — no second window here
            count = int(self._serving.get("count") or 0)
            p99 = float(self._serving.get("p99_ms") or 0.0)
            if count >= r.min_samples and p99 > r.serving_p99_ms:
                now[RULE_SERVING] = {
                    "p99_ms": p99,
                    "threshold_ms": r.serving_p99_ms,
                    "count": count,
                    "p50_ms": self._serving.get("p50_ms"),
                    "rate_rps": self._serving.get("rate_rps"),
                }
        if r.mesh_imbalance_ratio > 0 and self._mesh is not None:
            # the LATEST device rollup judges: the ratio is already a
            # whole-mesh statistic over the round's attributed step
            # times, and a mesh of one device is definitionally balanced
            # (ratio 1) — only real dp meshes are judged
            n_devices = int(self._mesh.get("n_devices") or 0)
            ratio = float(self._mesh.get("ratio") or 0.0)
            if n_devices >= 2 and ratio > r.mesh_imbalance_ratio:
                now[RULE_MESH] = {
                    "ratio": ratio,
                    "threshold_ratio": r.mesh_imbalance_ratio,
                    "n_devices": n_devices,
                    "worst_device": self._mesh.get("worst_device"),
                    "step_ms_p50": self._mesh.get("step_ms_p50"),
                    "step_ms_max": self._mesh.get("step_ms_max"),
                }
        if r.scan_tripwire and self._scan_trip is not None:
            # the LATEST scan block judges: its in-trace tripwire
            # latched, the replay was truncated at the trip round, and
            # the block drained — an active violation until a clean
            # block lands (observe_scan_block(None) clears)
            now[RULE_SCAN_TRIPWIRE] = dict(self._scan_trip)
        if self._perf_active:
            now[RULE_PERF] = {
                "metrics": {
                    k: {
                        "current": v.get("current"),
                        "baseline": v.get("baseline"),
                        "ratio": v.get("ratio"),
                    }
                    for k, v in sorted(self._perf_active.items())
                },
                "count": len(self._perf_active),
            }
        for rule, detail in self._slo_burn.items():
            now[rule] = dict(detail)

        # uniform verdict shape: every active rule carries value /
        # threshold / since alongside its rule-specific detail, so the
        # /healthz consumer renders burn-rate and legacy threshold rules
        # identically without knowing either's keys
        t_now = time.time()
        for rule, detail in now.items():
            value, threshold = self._uniform(rule, detail)
            detail.setdefault("value", value)
            detail.setdefault("threshold", threshold)
            detail["since"] = self._since.setdefault(rule, t_now)
        for rule in list(self._since):
            if rule not in now:
                del self._since[rule]

        raised = []
        for rule, detail in now.items():
            if rule not in self.active:
                raised.append({"rule": rule, **detail})
                self.violations_seen += 1
                self._reg().counter(
                    "slo_violations_total",
                    "SLO watchdog rules newly entering violation",
                    labelnames=("rule",),
                ).labels(rule=rule).inc()
                if self.logger is not None:
                    self.logger.warn("slo_violation", rule=rule, **detail)
        for rule in self.active:
            if rule not in now and self.logger is not None:
                self.logger.info("slo_recovered", rule=rule)
        self.active = now
        return raised

    @property
    def healthy(self) -> bool:
        return not self.active

    def status(self) -> dict[str, Any]:
        """The /healthz 'slo' block."""
        return {
            "healthy": self.healthy,
            "active": [
                {"rule": rule, **detail}
                for rule, detail in sorted(self.active.items())
            ],
            "violations_seen": self.violations_seen,
        }
