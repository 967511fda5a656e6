"""Fleet-scale observability — the port of
``kubernetes_rescheduling_tpu.telemetry.fleet_rollup``: device-side tenant
rollups and the cardinality budget.

- **Device half** — :func:`rollup_matrix`: a tensor reduction over the
  per-tenant metric matrix ``f32[T, M]`` (comm cost, load std,
  degraded/skipped flags, reconcile drift) giving per-dimension quantiles
  (p50/p90/p99/max, nearest rank, from one sort), sums, and the top-k WORST
  tenants (values and indices, ties to the lower index). It rides the
  fleet's round-end bundle (:func:`dispatch_fleet_bundle`, and the fleet
  scan's block): no transfer of its own, and O(k + quantile points) decode
  work whatever T is.
- **Host half** — :func:`decode_rollup` / :func:`publish_rollup`: the flat
  vector becomes BOUNDED metric families (``fleet_cost_quantile{q}``,
  ``fleet_load_std_quantile{q}``, ``fleet_drift_quantile{q}``, rank-labeled
  ``fleet_worst_tenant{rank,dim}``) and fleet totals. Tenant NAMES ride
  event payloads (:func:`rollup_event`), never label keys.
- **The budget gate** — :class:`TenantSeries`: the one gateway for
  tenant-labeled families. Fleets at or under the ``tenant_label_budget``
  keep the per-tenant series; larger fleets suppress them, counted in
  ``tenant_series_suppressed_total{family}``.
- **Bounded views** — :func:`fleet_health_block` (per-tenant rows at budget,
  breaker counts and the worst-k rows over it) and
  :class:`TenantSummaryRing` (the bounded per-tenant summary store behind
  the ops server's ``/tenants`` endpoints).

The numpy twin :func:`rollup_numpy` re-derives the device rollup on the
host (same nearest-rank positions, same tie order).
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any

import numpy as np
import torch

# the rollup's dimensions, in matrix-column order: per tenant, this
# round's communication cost, node-load std, degraded flag (0/1),
# skipped flag (0/1), and reconcile drift pods
DIMS: tuple[str, ...] = ("cost", "load_std", "degraded", "skipped", "drift")
NUM_DIMS = len(DIMS)
# quantile points, in rollup order (nearest-rank; "max" is the T-th)
QUANTS: tuple[str, ...] = ("p50", "p90", "p99", "max")
NUM_QUANTS = len(QUANTS)


def rollup_size(top_k: int) -> int:
    """Flat length of one rollup vector: per dimension, the quantile
    points, one sum, and top-k (value, tenant-index) pairs."""
    return NUM_DIMS * (NUM_QUANTS + 1 + 2 * top_k)


def _quantile_positions(tenants: int) -> tuple[int, ...]:
    """Nearest-rank positions into an ascending sort of T values —
    static per shape, shared verbatim by the device and numpy halves so
    their quantiles agree exactly (modulo f32 sort order)."""
    return tuple(
        min(max(math.ceil(q * tenants) - 1, 0), tenants - 1)
        for q in (0.50, 0.90, 0.99)
    ) + (tenants - 1,)


def rollup_matrix(matrix: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """``f32[T, NUM_DIMS]`` → one flat ``f32[rollup_size(top_k)]`` vector
    (quantiles, sums, top-k worst values, top-k worst tenant indices, each
    dimension-major), on the matrix's device and with no host read. "Worst"
    is HIGHEST for every dimension; ties go to the lower tenant index (a
    stable descending sort, the order of ``lax.top_k`` and of the numpy
    twin). ``top_k`` must already be clamped to ``<= T``."""
    tenants = matrix.shape[0]
    cols = matrix.float().t()                                       # [D, T]
    ranked = torch.sort(cols, dim=1).values
    # one column a position: indexing by a host list would copy it to the
    # device, which a graph capture refuses
    quants = torch.stack([ranked[:, p] for p in _quantile_positions(tenants)], dim=1)  # [D, Q]
    sums = cols.sum(dim=1)                                          # [D]
    vals, idx = torch.sort(cols, dim=1, descending=True, stable=True)
    return torch.cat([quants.reshape(-1), sums, vals[:, :top_k].reshape(-1),
                      idx[:, :top_k].float().reshape(-1)])


def rollup_numpy(matrix: np.ndarray, *, top_k: int) -> np.ndarray:
    """Host-side recompute of :func:`rollup_matrix` — the oracle the
    acceptance soak compares the device rollup against (f32 tolerance;
    identical quantile definition and tie order by construction)."""
    m = np.asarray(matrix, dtype=np.float32)
    tenants = m.shape[0]
    pos = list(_quantile_positions(tenants))
    quants = np.empty((NUM_DIMS, NUM_QUANTS), np.float32)
    vals = np.empty((NUM_DIMS, top_k), np.float32)
    idx = np.empty((NUM_DIMS, top_k), np.float32)
    for d in range(NUM_DIMS):
        col = m[:, d]
        quants[d] = np.sort(col)[pos]
        order = np.argsort(-col, kind="stable")[:top_k]
        vals[d] = col[order]
        idx[d] = order.astype(np.float32)
    sums = m.sum(axis=0, dtype=np.float32)
    return np.concatenate(
        [quants.ravel(), sums, vals.ravel(), idx.ravel()]
    )


def decode_rollup(flat, *, top_k: int) -> dict[str, Any]:
    """Unpack one pulled rollup vector into the structured dict the
    publishers, the watchdog rule, and the events consume."""
    flat = np.asarray(flat, dtype=np.float32)
    if flat.size != rollup_size(top_k):
        raise ValueError(
            f"rollup vector of {flat.size} values does not decode at "
            f"top_k={top_k} (expected {rollup_size(top_k)})"
        )
    nq = NUM_DIMS * NUM_QUANTS
    quants = flat[:nq].reshape(NUM_DIMS, NUM_QUANTS)
    sums = flat[nq : nq + NUM_DIMS]
    off = nq + NUM_DIMS
    vals = flat[off : off + NUM_DIMS * top_k].reshape(NUM_DIMS, top_k)
    idx = (
        flat[off + NUM_DIMS * top_k :]
        .reshape(NUM_DIMS, top_k)
        .astype(np.int64)
    )
    return {
        "top_k": top_k,
        "dims": {
            dim: {
                "quantiles": {
                    q: float(quants[d, j]) for j, q in enumerate(QUANTS)
                },
                "sum": float(sums[d]),
                "worst": [
                    {"tenant": int(idx[d, r]), "value": float(vals[d, r])}
                    for r in range(top_k)
                ],
            }
            for d, dim in enumerate(DIMS)
        },
    }


# ---------------- device half: the fleet round-end bundle ----------------


def fleet_round_bundle(pair: torch.Tensor, last_pair: torch.Tensor, flags: torch.Tensor,
                       active: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """The fleet round's closing vector with rollups on: the per-tenant
    metrics pair ``f32[T, 2]`` (``solver.fleet.fleet_metrics``), then the
    rollup over it. Tenants outside ``active`` (open breaker, dark backend)
    contribute their host-carried last-good pair instead of the filler
    row's; ``flags`` is the host's ``f32[T, 3]`` (degraded, skipped, drift)
    block."""
    merged = torch.where(active[:, None], pair, last_pair)
    matrix = torch.cat([merged, flags], dim=1)                      # f32[T, NUM_DIMS]
    return torch.cat([pair.reshape(-1), rollup_matrix(matrix, top_k=top_k)])


def dispatch_fleet_bundle(states, graphs, edges, last_pair, flags, active, *,
                          top_k: int) -> torch.Tensor:
    """Queue the fleet round bundle on the device: the batched metrics of
    ``states`` over ``graphs`` (each tenant's edge list in ``edges``) and
    their rollup, one flat tensor for the round's one ``fleet_metrics``
    read."""
    from kubernetes_rescheduling_tpu_torch.solver.fleet import fleet_metrics

    dev = last_pair.device
    pair = fleet_metrics(states, graphs, edges)
    return fleet_round_bundle(pair, last_pair, flags.to(dev), active.to(dev), top_k=top_k)


def decode_fleet_bundle(flat, *, tenants: int, top_k: int) -> tuple[np.ndarray, dict[str, Any]]:
    """Split one pulled fleet round bundle back into the per-tenant metrics
    pair ``f32[T, 2]`` and the decoded rollup."""
    flat = np.asarray(flat, dtype=np.float32)
    n_pair = tenants * 2
    if flat.size != n_pair + rollup_size(top_k):
        raise ValueError(
            f"fleet round bundle of {flat.size} values does not decode at "
            f"tenants={tenants}, top_k={top_k}"
        )
    return flat[:n_pair].reshape(tenants, 2), decode_rollup(flat[n_pair:], top_k=top_k)


# ---------------- host half: bounded families ----------------

def publish_rollup(registry, rollup: dict[str, Any]) -> None:
    """Decode → bounded metric families. Series count is k·dims +
    quantile points + a handful of fleet totals — independent of T.
    The value-bearing dims get their own quantile families; the 0/1 flag dims publish as fleet-total counts instead (a median
    of flags is not an operator quantity — "how many right now" is)."""
    dims = rollup["dims"]
    quantile_gauges = (
        (
            "cost",
            registry.gauge(
                "fleet_cost_quantile",
                "fleet-wide communication-cost quantile across tenants "
                "after the most recent fleet round (q = p50|p90|p99|max)",
                labelnames=("q",),
            ),
        ),
        (
            "load_std",
            registry.gauge(
                "fleet_load_std_quantile",
                "fleet-wide node-load-std quantile across tenants after "
                "the most recent fleet round (q = p50|p90|p99|max)",
                labelnames=("q",),
            ),
        ),
        (
            "drift",
            registry.gauge(
                "fleet_drift_quantile",
                "fleet-wide reconcile-drift-pods quantile across tenants "
                "after the most recent fleet round (q = p50|p90|p99|max)",
                labelnames=("q",),
            ),
        ),
    )
    for dim, g in quantile_gauges:
        for q, v in dims[dim]["quantiles"].items():
            g.labels(q=q).set(v)
    registry.gauge(
        "fleet_degraded_tenants",
        "tenants whose most recent fleet round finished degraded "
        "(failed post-move monitor)",
    ).set(dims["degraded"]["sum"])
    registry.gauge(
        "fleet_skipped_tenants",
        "tenants whose most recent fleet round was a counted skip "
        "(open breaker or dark backend)",
    ).set(dims["skipped"]["sum"])
    registry.gauge(
        "fleet_drift_pods",
        "fleet-total pods currently diverged from their tenant's "
        "reconcile intent (sum over tenants)",
    ).set(dims["drift"]["sum"])
    worst = registry.gauge(
        "fleet_worst_tenant",
        "metric value of the rank-th worst tenant per rollup dimension "
        "(dim = cost|load_std|degraded|skipped|drift); tenant NAMES "
        "ride the fleet_rollup event payload and /tenants, never label "
        "keys (the cardinality-budget convention)",
        labelnames=("rank", "dim"),
    )
    for dim in DIMS:
        for rank, row in enumerate(dims[dim]["worst"]):
            worst.labels(rank=str(rank), dim=dim).set(row["value"])


def rollup_event(
    rollup: dict[str, Any],
    tenant_names,
    *,
    round: int | None = None,
) -> dict[str, Any]:
    """The JSON-able ``fleet_rollup`` event payload: quantiles and sums
    per dimension plus the worst-k rows WITH tenant names attached —
    the one place per-tenant identity legally rides (event payloads are
    unindexed; metric label keys are not)."""
    dims = rollup["dims"]
    return {
        **({"round": round} if round is not None else {}),
        "top_k": rollup["top_k"],
        "quantiles": {
            dim: dict(dims[dim]["quantiles"]) for dim in DIMS
        },
        "sums": {dim: dims[dim]["sum"] for dim in DIMS},
        "worst": [
            {
                "dim": dim,
                "rank": rank,
                "tenant": (
                    tenant_names[row["tenant"]]
                    if 0 <= row["tenant"] < len(tenant_names)
                    else str(row["tenant"])
                ),
                "value": row["value"],
            }
            for dim in DIMS
            for rank, row in enumerate(dims[dim]["worst"])
        ],
    }


# ---------------- the cardinality budget gate ----------------


class TenantSeries:
    """THE budget-gated gateway for tenant-labeled metric families: every
    ``labelnames=("tenant",)`` registration of the port goes through it.
    At or under ``budget`` tenants the per-tenant families emit
    (``budget=None`` means unlimited, a ledger's path outside the fleet
    loop); over
    budget every update is suppressed and counted
    ``tenant_series_suppressed_total{family}``, so an operator can see
    both THAT detail was dropped and which families to read the
    bounded rollups for instead.
    """

    def __init__(self, registry, *, tenants: int, budget: int | None):
        self.registry = registry
        self.tenants = int(tenants)
        self.budget = budget
        self.enabled = budget is None or self.tenants <= int(budget)

    def _suppress(self, family: str) -> None:
        self.registry.counter(
            "tenant_series_suppressed_total",
            "per-tenant metric series updates suppressed by the "
            "ObsConfig.tenant_label_budget cardinality gate — the fleet "
            "is over budget; read the bounded fleet rollup families "
            "(fleet_*_quantile, fleet_worst_tenant) instead",
            labelnames=("family",),
        ).labels(family=family).inc()

    def counter_inc(
        self, name: str, help: str, tenant: str, amount: float = 1.0
    ) -> None:
        if self.enabled:
            self.registry.counter(
                name, help, labelnames=("tenant",)
            ).labels(tenant=tenant).inc(amount)
        else:
            self._suppress(name)

    def gauge_set(
        self, name: str, help: str, tenant: str, value: float
    ) -> None:
        if self.enabled:
            self.registry.gauge(
                name, help, labelnames=("tenant",)
            ).labels(tenant=tenant).set(value)
        else:
            self._suppress(name)


# ---------------- the live plane's bounded views ----------------


class TenantSummaryRing:
    """Bounded per-tenant live summaries behind ``/tenants`` and
    ``/tenants/<name>``: the drill-down that replaces O(T) metric
    series. Each entry holds the tenant's LAST round summary, breaker
    state, reconcile drift, and a capped window of recent comm costs;
    the store itself is LRU-bounded (``max_tenants``) so unbounded
    tenant churn cannot grow it without limit. Thread-safe — the ops
    server reads it from request threads mid-round."""

    def __init__(
        self, *, cost_window: int = 32, max_tenants: int = 1024
    ) -> None:
        if cost_window < 1 or max_tenants < 1:
            raise ValueError("cost_window and max_tenants must be >= 1")
        self.cost_window = cost_window
        self.max_tenants = max_tenants
        self.evicted = 0
        self._entries: collections.OrderedDict[str, dict] = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def observe(
        self,
        tenant: str,
        *,
        record: dict | None = None,
        breaker: str | None = None,
        drift: int | None = None,
        skipped: bool = False,
    ) -> None:
        with self._lock:
            e = self._entries.get(tenant)
            if e is None:
                e = {
                    "tenant": tenant,
                    "rounds": 0,
                    "skipped_rounds": 0,
                    "degraded_rounds": 0,
                    "breaker": None,
                    "drift": 0,
                    "last": None,
                    "costs": collections.deque(maxlen=self.cost_window),
                }
            self._entries[tenant] = e
            self._entries.move_to_end(tenant)
            if skipped:
                e["skipped_rounds"] += 1
            if record is not None:
                e["rounds"] += 1
                if record.get("degraded"):
                    e["degraded_rounds"] += 1
                e["last"] = dict(record)
                cost = record.get("communication_cost")
                if cost is not None:
                    e["costs"].append(float(cost))
            if breaker is not None:
                e["breaker"] = breaker
            if drift is not None:
                e["drift"] = int(drift)
            while len(self._entries) > self.max_tenants:
                self._entries.popitem(last=False)
                self.evicted += 1

    def overview(self) -> list[dict]:
        """The ``/tenants`` listing: one compact row per tracked tenant
        (newest-updated last, the LRU order)."""
        with self._lock:
            return [
                {
                    "tenant": e["tenant"],
                    "breaker": e["breaker"],
                    "rounds": e["rounds"],
                    "skipped_rounds": e["skipped_rounds"],
                    "degraded_rounds": e["degraded_rounds"],
                    "drift": e["drift"],
                    "communication_cost": (
                        e["costs"][-1] if e["costs"] else None
                    ),
                }
                for e in self._entries.values()
            ]

    def detail(self, tenant: str) -> dict | None:
        """The ``/tenants/<name>`` drill-down (None = never seen or
        LRU-evicted)."""
        with self._lock:
            e = self._entries.get(tenant)
            if e is None:
                return None
            out = dict(e)
            out["costs"] = list(e["costs"])
            return out


def fleet_health_block(
    rows: dict[str, dict],
    *,
    budget: int | None,
    event: dict[str, Any] | None = None,
) -> dict:
    """The ``/healthz`` fleet block, budget-gated: at or under budget
    the per-tenant rows pass through UNCHANGED (the bit-identity
    contract with the pre-budget plane); over budget the block is a
    bounded summary — breaker-state counts, fleet totals, and — when
    ``event`` (the latest :func:`rollup_event` payload) is given — the
    rollup's quantiles and worst-k rows (with names — a JSON payload,
    not a metric label) — so ``/healthz`` stays O(k) however many
    tenants serve."""
    if budget is None or len(rows) <= budget:
        return rows
    breakers: collections.Counter = collections.Counter(
        str(r.get("breaker")) for r in rows.values()
    )
    out: dict[str, Any] = {
        "tenants": len(rows),
        "suppressed": True,
        "tenant_label_budget": budget,
        "breaker_states": dict(sorted(breakers.items())),
        "rounds": sum(r.get("rounds", 0) for r in rows.values()),
        "skipped_rounds": sum(
            r.get("skipped_rounds", 0) for r in rows.values()
        ),
        "degraded_rounds": sum(
            r.get("degraded_rounds", 0) for r in rows.values()
        ),
    }
    if event is not None:
        out["quantiles"] = event.get("quantiles")
        out["worst"] = event.get("worst")
    return out
