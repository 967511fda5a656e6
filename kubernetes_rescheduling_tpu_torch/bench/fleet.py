"""The multiplexed fleet round loop — one device plane, N tenants: the port
of ``kubernetes_rescheduling_tpu.bench.fleet``.

:func:`run_fleet_controller` is the solo loop (``bench/controller.py``)
multiplexed over N tenants:

- **per tenant**: its own boundary, circuit breaker and retry clock (the
  backend's own ``advance``), its own admission guard and intent ledger,
  and its own ``ControllerResult`` with the solo invariant
  ``max_rounds == len(rounds) + skipped_rounds``;
- **one device plane**: a round runs ONE fleet decision for every active
  tenant — the greedy ``solver.fleet.fleet_solve``, the proactive
  ``fleet_solve_proactive`` after one ``forecast.fleet`` step for every
  tenant, or the dense global ``solver.fleet_global.fleet_global_solve``
  (on the card each one replay of a captured graph holding every tenant's
  body) — read home in ONE counted transfer
  (``device_transfers_total{site="fleet_decision"}``, the proactive
  plane's forecast diag matrix riding it), and closes
  with ONE metrics bundle (``site="fleet_metrics"``: the per-tenant
  round-end pair and, with ``config.fleet_rollup``, the fleet rollup).

A tenant whose breaker is open (or whose backend is dark) is a counted skip
and a masked slot: the other tenants decide exactly as without it.

Each tenant decides as the solo loop of seed ``_random.tenant_seed(
config.seed, t)`` (the counterpart of the JAX package's ``fold_in(key,
t)``): its ``random`` noise rows and its solver plans come from that seed's
round generators, or from the per-tenant seams ``gumbel_rows[t]`` /
``solver_plans[t]``, which take the solo loop's ``gumbel_rows`` /
``solver_plans`` callables.

Heterogeneous tenants are aligned at startup to one shared power-of-two
shape bucket (:func:`_align_fleet_buckets`), padded and masked, so a
tenant decides as its unpadded solo run. Churn (``config.elastic`` with
``elastic_tenants``, or ``churn={index: ChurnEngine}``) applies to the
selected tenants over ONE shared set of buckets; the untouched tenants'
records stay as without churn. ``config.scan_block`` K runs K steady-state
rounds of every tenant as one device block (``bench/scan.py``'s fleet
half) and one counted ``round_end`` read, with per-tenant tripwire lanes.

Chaos (``config.chaos``) wraps the tenants of ``fleet.chaos_tenants`` (all
of them when the tuple is empty), tenant ``t`` seeded ``chaos_seed + t``:
each tenant owns its fault stream, as it owns its clock and breaker, so a
chaotic tenant leaves every other tenant's records as in a clean run.

The pipelined fleet (``config.pipeline`` with T > 1): the active tenants'
boundary phases — apply, pace, post-move monitor, reconcile — run on a pool
of ``min(T, 8)`` worker threads between the decision read and the metrics
bundle, and the records are collected in tenant order. On the card each
tenant's phase runs on that tenant's own CUDA stream, with an event
recorded after it; the main thread waits on the events before the metrics
bundle reads the snapshots. The pool is joined before the main thread
issues any device work, so no worker runs while a fleet program is
captured. Shared host state stays safe: the registry and the logger lock
their series and ring, ``TenantSeries`` holds nothing but its fixed budget
decision, and a tenant's pending churn events are taken on the main thread
before the dispatch. Each tenant's records equal the serial fleet's.

The ops plane (``ops=``, a ``telemetry.server.OpsPlane``): ``/healthz``
grows a ``fleet`` block (per-tenant rows at the label budget, the bounded
summary over it — one tenant's open breaker is degraded service, not a
503), every tenant-round feeds the watchdog, the flight recorder's ring and
the ``/tenants`` summary ring, every rollup feeds the ``fleet_tail_cost``
rule, a tenant's breaker opening dumps a bundle scoped to that tenant, the
per-tenant SLO budgets publish through the label budget, and the profiler
gate opens around the next rounds or scan block. Breaker transitions of
the pipelined fleet fire on its workers; the plane's hooks they reach take
no lock the main thread holds while it waits for them.

Fleet restarts (``config.solver_restarts`` R > 1 on a global round) run
each tenant's best-of-R inside the one fleet program
(``solver.fleet_global``), restart ``i`` of tenant ``t`` on the i-th of
``parallel.sharded.restart_generators`` of the tenant's round generator, or
on the i-th plan list of its ``solver_plans`` seam.

The dp plane (``config.fleet.plane="dp"``, ``parallel/fleet.py``): each
rank of the fleet's dp mesh (shaped once from the default process group)
decides its block of tenants, and one gather over dp hands every rank the
whole fleet's decision bundle before the one counted read — no host read
is added a round. Under ``torchrun`` every rank runs this loop's host side
for the whole fleet: it is deterministic and replicated, so the records
are equal on every rank (timings aside); only rank 0 writes files, serves
HTTP and prints (``cli.py``). Without a process group the dp plane is the
vmap plane's call itself. A dp run feeds the mesh plane
(``telemetry.mesh.MeshPlane``, with ``config.device_rollup``): each
round's or scan block's fence and pulled bytes attributed across the dp
devices by the per-tenant cost column, each card's allocated memory riding
the gather, published as bounded families, the ``device_rollup`` event,
the ``/healthz`` ``mesh`` stanza, ``GET /devices`` and the
``mesh_imbalance`` rule. Checkpoint/resume is solo-only, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch._random import gumbel as draw_gumbel
from kubernetes_rescheduling_tpu_torch._random import round_generator, tenant_seed
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest, PlacementMechanism
from kubernetes_rescheduling_tpu_torch.backends.chaos import with_chaos
from kubernetes_rescheduling_tpu_torch.backends.fleet import FleetBackend
from kubernetes_rescheduling_tpu_torch.bench import scan as scan_mod
from kubernetes_rescheduling_tpu_torch.bench.admission import AdmissionGuard
from kubernetes_rescheduling_tpu_torch.bench.boundary import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BoundaryClient,
    CircuitBreaker,
)
from kubernetes_rescheduling_tpu_torch.bench.controller import (
    ControllerResult,
    RoundRecord,
    _solver_config,
    adopt_snapshot,
    observe_wall_round,
    pipeline_depth_gauge,
    pipeline_overlap_gauge,
)
from kubernetes_rescheduling_tpu_torch.bench.reconcile import (
    IntentLedger,
    move_intent,
    reconcile_round_block,
)
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
from kubernetes_rescheduling_tpu_torch.elastic.buckets import bucket_capacity, device_view
from kubernetes_rescheduling_tpu_torch.elastic.engine import make_fleet_churn
from kubernetes_rescheduling_tpu_torch.forecast.model import DIAG_SIZE
from kubernetes_rescheduling_tpu_torch.forecast.plane import decode_diag, publish_forecast
from kubernetes_rescheduling_tpu_torch.objectives.metrics import comm_edge_list
from kubernetes_rescheduling_tpu_torch.policies.proactive import scoring_policy
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver.compiled import to_device
from kubernetes_rescheduling_tpu_torch.solver.fleet import (
    ROW_MOST,
    ROW_SERVICE,
    ROW_TARGET,
    ROW_VICTIM,
    fleet_metrics,
    fleet_solve,
    fleet_solve_proactive,
    stack_tenants,
)
from kubernetes_rescheduling_tpu_torch.solver.fleet_global import (
    decode_fleet_global,
    fleet_global_solve,
)
from kubernetes_rescheduling_tpu_torch.telemetry import tripwire as tripwire_mod
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull
from kubernetes_rescheduling_tpu_torch.telemetry.fleet_rollup import (
    TenantSeries,
    decode_fleet_bundle,
    decode_rollup,
    dispatch_fleet_bundle,
    fleet_health_block,
    publish_rollup,
    rollup_event,
)
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from kubernetes_rescheduling_tpu_torch.telemetry.spans import span
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger

# the fleet loop's two round-end transfer sites
DECISION_SITE = "fleet_decision"
METRICS_SITE = "fleet_metrics"


@dataclass
class FleetResult:
    """Per-tenant round streams plus fleet-level accounting."""

    tenants: tuple[str, ...] = ()
    results: dict[str, ControllerResult] = field(default_factory=dict)
    # fleet decisions dispatched (rounds with >= 1 active tenant, and scan
    # blocks), and their fenced seconds
    batched_solves: int = 0
    device_solve_s: float = 0.0
    # wall seconds of each executed fleet round (sequential schedule) or
    # scan block, in order (timing field)
    round_wall_s: list[float] = field(default_factory=list)
    # the pipelined fleet's overlap ratio of each round it ran on the pool:
    # 1 - (pool wall / summed tenant phases) (timing field)
    pipeline_overlap: list[float] = field(default_factory=list)
    # the /healthz fleet block as the last round left it
    health: dict = field(default_factory=dict)

    @property
    def total_rounds(self) -> int:
        return sum(len(r.rounds) for r in self.results.values())

    @property
    def total_skipped(self) -> int:
        return sum(r.skipped_rounds for r in self.results.values())

    @property
    def amortized_solve_ms_per_tenant_round(self) -> float:
        """Fenced fleet-decision ms over the executed tenant-rounds."""
        n = self.total_rounds
        return (self.device_solve_s / n * 1e3) if n else 0.0


class _Tenant:
    """One tenant's host side: boundary, breaker, guard, ledger, graph,
    random streams and result."""

    def __init__(self, index: int, name: str, backend, config: RescheduleConfig, *, device,
                 logger, registry, tseries, gumbel_rows=None, solver_plans=None):
        self.index = index
        self.name = name
        self.device = device
        self.breaker = CircuitBreaker(
            max_consecutive_failures=config.max_consecutive_failures,
            cooldown_rounds=config.breaker_cooldown_rounds,
            logger=logger,
            registry=registry,
        )
        self.boundary = BoundaryClient(
            backend, policy=config.retry, breaker=self.breaker,
            failure_budget_per_round=config.failure_budget_per_round, registry=registry,
            tenant=name,
        )
        # per tenant: a tenant's last-good caches never cross into another's,
        # and its moves land in its own ledger (tenant-labeled drift gauge)
        self.guard = (
            AdmissionGuard(max_quarantine_frac=config.max_quarantine_frac, registry=registry,
                           logger=logger, on_reject=self.boundary.admission_reject)
            if config.reconcile_admission else None
        )
        self.ledger = (
            IntentLedger(registry=registry, logger=logger, tenant=name, tenant_series=tseries)
            if config.reconcile_enabled else None
        )
        self.seed = tenant_seed(config.seed, index)
        self.gumbel_rows = gumbel_rows
        self.solver_plans = solver_plans
        self.graph = None
        self._edges = None
        self.refresh_graph()
        self.state = None
        # churn debt: the carried snapshot predates applied churn (or a
        # shared-bucket promotion) and must be re-monitored behind the gate
        self.remask = False
        self.last_drift = 0
        self.result = ControllerResult()
        # the pipelined fleet's stream for this tenant's boundary phase (the
        # card only; made at first use)
        self._stream = None

    def phase_stream(self):
        """The context a pooled boundary phase runs in, and its stream: on
        the card this tenant's own CUDA stream, on the CPU none."""
        if self.device.type != "cuda":
            return contextlib.nullcontext(), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream), self._stream

    def refresh_graph(self) -> None:
        self.graph = self.boundary.comm_graph().to(self.device)

    def edges(self):
        """The round-end cost's edge list of the current graph."""
        if self._edges is None or self._edges[0] is not self.graph:
            self._edges = (self.graph, comm_edge_list(self.graph))
        return self._edges[1]

    def solve_graph(self, staged: bool):
        """The graph as the fleet bodies read it. Under churn (``staged``) the
        adjacency is written in place into one buffer a bucket shape, kept in
        the tenant's solver cache, so a churned fleet captures once plus once
        a promotion (a promotion evicts the slot); static runs pass the graph
        through."""
        graph = self.graph
        if not staged:
            return graph
        slot = self.boundary.solver_cache("solve_adj")
        if slot.get("graph") is not graph:
            buf = slot.get("adj")
            if buf is None or buf.shape != graph.adj.shape or buf.device != graph.adj.device:
                buf = graph.adj.clone()
            else:
                buf.copy_(graph.adj)
            slot["graph"], slot["adj"] = graph, buf
            slot["value"] = dataclasses.replace(graph, adj=buf)
        return slot["value"]

    def noise_row(self, rnd: int) -> torch.Tensor:
        """The ``random`` policy's noise row of round ``rnd`` (host)."""
        if self.gumbel_rows is not None:
            return self.gumbel_rows(rnd, 0).cpu()
        return draw_gumbel((self.state.num_nodes,), round_generator(self.seed, rnd), "cpu")

    def health_row(self) -> dict:
        return {"breaker": self.breaker.state, "rounds": len(self.result.rounds),
                "skipped_rounds": self.result.skipped_rounds,
                "degraded_rounds": self.result.degraded_rounds}


def _admitted_monitor(t: _Tenant):
    """The fleet loop's only monitor: one tenant's snapshot, on the loop's
    device, through that tenant's admission guard (None: failed or
    rejected, charged to the tenant's boundary)."""
    out = t.boundary.monitor()
    if out is not None:
        out = out.to(t.device)
    if t.guard is not None:
        out = t.guard.admit(out)
    return out


def _align_fleet_buckets(backends, *, floor: int, registry) -> dict | None:
    """Heterogeneous tenants: fit ONE shared power-of-two bucket over every
    tenant's live counts and pin each backend's snapshot padding to it, so
    the tenants share one shape. Same-shaped fleets are left untouched.
    Returns the shared capacities, or None when nothing needed aligning
    (or a backend lacks the simulator's ``live_counts`` /
    ``set_capacities``: stacking then raises the sizing error)."""
    counts = []
    for b in backends:
        raw = b
        while hasattr(raw, "inner"):
            raw = raw.inner
        if not (hasattr(raw, "live_counts") and hasattr(raw, "set_capacities")):
            return None
        counts.append(raw.live_counts())
    if len({tuple(sorted(c.items())) for c in counts}) <= 1:
        return None
    caps = {axis: bucket_capacity(max(c[axis] for c in counts), floor=floor)
            for axis in ("services", "nodes", "pods")}
    for b in backends:
        raw = b
        while hasattr(raw, "inner"):
            raw = raw.inner
        raw.set_capacities(node=caps["nodes"], pod=caps["pods"], service=caps["services"])
    for axis in ("services", "nodes", "pods"):
        registry.gauge(
            f"fleet_bucket_{axis}",
            f"shared fleet shape bucket: {axis[:-1]} capacity every tenant pads to",
        ).set(caps[axis])
    return caps


def run_fleet_controller(
    fleet: FleetBackend,
    config: RescheduleConfig,
    *,
    device: str | torch.device | None = DEFAULT_DEVICE,
    registry: MetricsRegistry | None = None,
    logger: StructuredLogger | None = None,
    on_round: Callable | None = None,
    churn: dict | None = None,
    gumbel_rows: Sequence[Callable[[int, int], torch.Tensor]] | None = None,
    solver_plans: Sequence[Callable[[int], list]] | None = None,
    ops=None,
) -> FleetResult:
    """Run ``config.max_rounds`` multiplexed rounds over a fleet on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    ``on_round(tenant_name, record, state)`` fires per executed
    tenant-round. ``churn`` (``{tenant_index: ChurnEngine}``, or built from
    ``config.elastic`` by ``elastic.engine.make_fleet_churn``) churns the
    selected tenants between rounds over one shared set of buckets.
    ``gumbel_rows[t]`` / ``solver_plans[t]`` replace tenant ``t``'s draws
    (the solo loop's seams, per tenant). ``registry`` gets the fleet's
    families: ``fleet_tenants``, the per-tenant ``fleet_rounds_total`` /
    ``fleet_moves_total`` / cost and load gauges through the cardinality
    gate (``config.tenant_label_budget``), and the rollup families.
    ``ops`` attaches the live ops plane (module docstring)."""
    config = config.validate()
    if config.fleet.tenants and config.fleet.tenants != fleet.num_tenants:
        raise ValueError(
            f"config.fleet.tenants={config.fleet.tenants} but the fleet backend has "
            f"{fleet.num_tenants} tenants"
        )
    if not config.fleet.tenants:
        # the fleet gate holds whatever the config's fleet block says
        config = dataclasses.replace(
            config, fleet=dataclasses.replace(config.fleet, tenants=fleet.num_tenants)
        ).validate()
    if config.algorithm == "global" or config.moves_per_round == "all":
        fleet_mode = "global"
    elif config.algorithm == "proactive":
        fleet_mode = "proactive"
    else:
        fleet_mode = "greedy"
    dev = resolve_device(device)
    registry = registry if registry is not None else get_registry()
    T = fleet.num_tenants
    for seam, what in ((gumbel_rows, "gumbel_rows"), (solver_plans, "solver_plans")):
        if seam is not None and len(seam) != T:
            raise ValueError(f"{what} has {len(seam)} entries for {T} tenants")
    backends = list(fleet.backends)
    if config.chaos != "none":
        hit = set(config.fleet.chaos_tenants) or set(range(T))
        backends = [with_chaos(b, config.chaos, seed=config.chaos_seed + t, registry=registry)
                    if t in hit else b for t, b in enumerate(backends)]
    _align_fleet_buckets(backends, floor=config.bucket_floor, registry=registry)

    tseries = TenantSeries(registry, tenants=T, budget=config.tenant_label_budget)
    if ops is not None:
        # per-tenant SLO budgets publish through the same label budget
        ops.bind_tenant_series(tseries)
    tenants = [
        _Tenant(i, name, backend, config, device=dev, logger=logger, registry=registry,
                tseries=tseries,
                gumbel_rows=gumbel_rows[i] if gumbel_rows is not None else None,
                solver_plans=solver_plans[i] if solver_plans is not None else None)
        for i, (name, backend) in enumerate(zip(fleet.tenant_names, backends))
    ]
    names = [t.name for t in tenants]
    rollup_on = config.fleet_rollup
    rollup_k = min(config.fleet_rollup_top_k, T)
    # per-tenant last-good (cost, load_std) for skipped tenants' rollup rows;
    # a tenant that never ran borrows the round's computed row
    last_pair = np.zeros((T, 2), np.float32)
    ever_good = np.zeros((T,), bool)
    last_rollup_event: list = [None]
    prev_logger_state = None
    if logger is not None:
        # ring fairness for the run, restored on exit
        prev_logger_state = (logger.registry, logger.max_records_per_tenant)
        logger.registry = registry
        if logger.max_records_per_tenant == 0 and T > 1:
            logger.max_records_per_tenant = max(4, logger.max_records // T)
    if churn is None and config.elastic != "none":
        churn = make_fleet_churn(fleet, config, registry=registry)
    churn = dict(churn or {})
    for idx in sorted(churn):
        if not 0 <= idx < T:
            raise ValueError(f"churn tenant index {idx} out of range for {T} tenants")
        churn[idx].bind(tenants[idx].boundary, config.max_rounds, registry=registry)
    if churn:
        # binding re-padded the graphs (the service bucket)
        for t in tenants:
            t.refresh_graph()
    staged = bool(churn)
    registry.gauge("fleet_tenants", "tenants served by the multiplexed fleet loop").set(T)

    result = FleetResult(tenants=tuple(names))

    def update_fleet_health() -> None:
        result.health = fleet_health_block({t.name: t.health_row() for t in tenants},
                                           budget=config.tenant_label_budget,
                                           event=last_rollup_event[0])
        if ops is not None:
            ops.health.fleet = result.health

    def emit_rollup(rollup: dict, rnd: int) -> None:
        """One round's rollup everywhere at once: the bounded families, the
        named event, the fleet_tail_cost window and the bundle cache."""
        publish_rollup(registry, rollup)
        ev = rollup_event(rollup, names, round=rnd)
        last_rollup_event[0] = ev
        if logger is not None:
            logger.info("fleet_rollup", **ev)
        if ops is not None:
            ops.observe_fleet_rollup(rollup, event=ev)

    if ops is not None:
        ops.bind(logger=logger, algorithm=config.algorithm)
        update_fleet_health()
        for t in tenants:
            # a tenant's breaker opening dumps a bundle tagged with the
            # tenant: the rollup plus only that tenant's summary
            t.breaker.on_transition = (
                lambda rec, _name=t.name: ops.on_breaker_transition({**rec, "tenant": _name}))
    # the profiler gate (POST /profile, --profile-rounds): an armed capture
    # opens just before a dispatch and closes once its rounds committed
    prof = getattr(ops, "profiler", None)

    scoring = (scoring_policy(config.algorithm, config.forecast) if fleet_mode != "global"
               else None)
    forecast_plane = None
    if fleet_mode == "proactive":
        from kubernetes_rescheduling_tpu_torch.forecast.fleet import FleetForecastPlane

        forecast_plane = FleetForecastPlane(config.forecast, T, device=dev)
    pid = POLICY_IDS[scoring] if scoring is not None else None
    thr = float(config.hazard_threshold_pct)
    mech = PlacementMechanism[scoring if scoring is not None else "global"]
    solver_cfg = _solver_config(config) if fleet_mode == "global" else None

    # the dp plane's mesh, resolved once (making one is collective over the
    # world), and the mesh plane it feeds
    dp_mesh = mesh_plane = None
    if config.fleet.plane == "dp":
        from kubernetes_rescheduling_tpu_torch.parallel import fleet as dp_fleet

        dp_mesh = dp_fleet._fleet_mesh(T, None, device=dev)
        if config.device_rollup:
            from kubernetes_rescheduling_tpu_torch.telemetry.mesh import MeshPlane

            mesh_plane = MeshPlane(registry, device_names=dp_fleet.dp_device_names(dp_mesh),
                                   budget=config.device_label_budget)
            if ops is not None:
                ops.bind_mesh(mesh_plane)
    with_hbm = mesh_plane is not None

    def observe_mesh(*, dispatch_s, transfer_bytes, weights, rounds, rnd, hbm=None) -> None:
        """One round's or block's device-axis accounting everywhere at once:
        the bounded mesh families, the named device_rollup event, the
        /healthz mesh stanza and the mesh_imbalance window."""
        if mesh_plane is None:
            return
        summary, ev = mesh_plane.observe_block(dispatch_s=dispatch_s,
                                               transfer_bytes=transfer_bytes, weights=weights,
                                               rounds=rounds, round=rnd, hbm_mb=hbm)
        if logger is not None:
            logger.info("device_rollup", **ev)
        if ops is not None:
            ops.observe_device_rollup(summary, event=ev)

    # startup: the solo loop's bounded probe per tenant, without its hard
    # failure — a dark tenant starts without a snapshot (counted skips)
    for t in tenants:
        for _ in range(max(3, config.max_consecutive_failures + 1)):
            t.state = _admitted_monitor(t)
            if t.state is not None:
                break
        if t.state is not None and t.ledger is not None:
            arrays = t.guard.host_arrays(t.state) if t.guard is not None else None
            t.ledger.rebase(t.state, service_names=t.graph.names, host_arrays=arrays)
    if all(t.state is None for t in tenants):
        raise ConnectionError(
            "fleet unavailable: every tenant's initial monitor() failed after retries"
        )

    def skip_round(t: _Tenant, rnd: int) -> None:
        t.result.skipped_rounds += 1
        tseries.counter_inc(
            "fleet_rounds_skipped_total",
            "tenant rounds frozen by that tenant's open breaker (or a dark backend)",
            t.name,
        )
        if ops is not None:
            ops.observe_tenant(t.name, breaker=t.breaker.state, drift=t.last_drift,
                               skipped=True)
        adm = t.guard.take_info() if t.guard is not None else {}
        if logger is not None:
            logger.info("fleet_round_skipped", tenant=t.name, round=rnd,
                        breaker=t.breaker.state,
                        consecutive_failures=t.breaker.consecutive_failures,
                        **({"admission": adm} if adm else {}))
        if ops is not None:
            ops.observe_skip(rnd, breaker_state=t.breaker.state)
        t.boundary.advance(config.sleep_after_action_s)

    # churn applied while a tenant's rounds are skipped flushes into its next
    # executed record (the solo loop's pending-churn rule, per tenant)
    pending_churn: dict[int, list[dict]] = {idx: [] for idx in churn}

    def emit_tenant_round(t: _Tenant, rec: RoundRecord, rnd: int) -> None:
        """The per-tenant-round epilogue, shared by both schedules."""
        t.result.rounds.append(rec)
        tseries.counter_inc("fleet_rounds_total",
                            "tenant rounds executed by the multiplexed fleet loop", t.name)
        if rec.moved:
            tseries.counter_inc("fleet_moves_total",
                                "deployments moved per tenant by fleet rounds", t.name)
        if rec.degraded:
            tseries.counter_inc(
                "fleet_degraded_rounds_total",
                "tenant rounds finished on a stale snapshot after the post-move monitor "
                "failed", t.name)
        tseries.gauge_set("fleet_communication_cost",
                          "per-tenant communication cost after the most recent fleet round",
                          t.name, rec.communication_cost)
        tseries.gauge_set("fleet_load_std",
                          "per-tenant node CPU-% standard deviation after the most recent "
                          "fleet round", t.name, rec.load_std)
        if rec.forecast is not None:
            # the proactive plane's per-tenant skill (through the label
            # budget) and the solo loop's mode counter, one a tenant-round
            tseries.gauge_set("fleet_forecast_skill",
                              "per-tenant forecast skill (1 - mae_model/mae_persistence) "
                              "after the most recent proactive fleet round",
                              t.name, rec.forecast["skill"])
            publish_forecast(registry, rec.forecast, skill_gauge=False)
        round_event = dict(tenant=t.name, round=rnd, moved=rec.moved, service=rec.service,
                           target=rec.target, communication_cost=rec.communication_cost,
                           load_std=rec.load_std, breaker=rec.breaker_state,
                           degraded=rec.degraded, boundary_failures=rec.boundary_failures)
        if logger is not None:
            logger.info("fleet_round", **round_event)
        if ops is not None:
            # the solo loop's per-round feed, per tenant-round (the
            # watchdog keys its per-source state on the tenant), and the
            # /tenants drill-down ring
            ops.observe_round(rec, t.state, events=[{"event": "fleet_round", **round_event}],
                              tenant=t.name)
            ops.observe_tenant(
                t.name,
                record={"round": rnd, "moved": rec.moved, "service": rec.service,
                        "target": rec.target, "communication_cost": rec.communication_cost,
                        "load_std": rec.load_std, "degraded": rec.degraded},
                breaker=rec.breaker_state, drift=t.last_drift,
            )
        if on_round is not None:
            on_round(t.name, rec, t.state)

    def apply_tenant_move(t: _Tenant, row, hazard_row, *, apply: bool = True):
        """The greedy apply half both schedules share: decode the packed row,
        issue the boundary move, record the intent. Returns ``(service_name,
        first_hazard, landed, attempted)``."""
        state = t.state
        most_i, victim_i = int(row[ROW_MOST]), int(row[ROW_VICTIM])
        svc_i, target_i = int(row[ROW_SERVICE]), int(row[ROW_TARGET])
        service_name = t.graph.names[svc_i] if victim_i >= 0 else None
        first_hazard = state.node_names[most_i] if most_i >= 0 else None
        landed = None
        attempted = apply and most_i >= 0 and victim_i >= 0 and target_i >= 0
        if attempted:
            target_name = state.node_names[target_i]
            landed = t.boundary.apply_move(MoveRequest(
                service=service_name, target_node=target_name,
                hazard_nodes=tuple(n for n, h in zip(state.node_names, hazard_row) if h),
                mechanism=mech,
            ))
            if t.ledger is not None:
                t.ledger.record_moves([move_intent(mech, service_name, target_name, landed)])
        return service_name, first_hazard, landed, attempted

    def apply_tenant_global_moves(t: _Tenant, moves_t):
        """The global apply half: the decoded ``(service, target)`` list in
        the solo round's first-moved-pod order, with its intent rule.
        Returns ``(moved_names, applied_moves)``."""
        state = t.state
        moved_names, applied = [], []
        for s, target_i in moves_t:
            service_name, target_name = t.graph.names[s], state.node_names[target_i]
            landed = t.boundary.apply_move(MoveRequest(service=service_name,
                                                       target_node=target_name,
                                                       mechanism=mech))
            if t.ledger is not None:
                t.ledger.record_moves([move_intent(mech, service_name, target_name, landed)])
            if landed is not None:
                moved_names.append(service_name)
                applied.append((service_name, landed))
        return moved_names, applied

    def close_tenant_round(t: _Tenant, rnd: int, rec: RoundRecord, carried) -> None:
        """Pace, post-move monitor, churn info and reconcile of one tenant's
        round (the solo round's close, per tenant); ``carried`` holds the
        tenant's pending churn events, None when it is not churned."""
        t.boundary.advance(config.sleep_after_action_s)
        new_state = _admitted_monitor(t)
        rec.degraded = rec.degraded or new_state is None
        if new_state is not None:
            t.state = new_state
        if carried is not None:
            rec.churn = churn[t.index].round_info(carried)
        rec.reconcile, t.last_drift = reconcile_round_block(
            t.guard, t.ledger, state=t.state, service_names=t.graph.names,
            churn_events=(rec.churn or {}).get("events") or (), fresh=new_state is not None,
            last_drift=t.last_drift, boundary=t.boundary,
            repair_budget=config.repair_budget_per_round,
        )
        rec.breaker_state = t.breaker.state
        rec.boundary_failures = t.boundary.round_failures

    def step_churn(rnd: int) -> None:
        promoted = False
        changed: list[int] = []
        for idx in sorted(churn):
            applied = churn[idx].step(rnd)
            if applied:
                pending_churn.setdefault(idx, []).extend(applied)
                promoted = promoted or churn[idx].promoted
                if churn[idx].graph_changed:
                    changed.append(idx)
                tenants[idx].remask = True
        if promoted:
            # a shared-bucket promotion re-pads EVERY tenant: graphs refresh,
            # every tenant owes a re-monitor (behind its own gate) and its
            # derived-graph caches are stale
            for t in tenants:
                t.refresh_graph()
                t.remask = True
                t.boundary.evict_solver_caches(reason="promotion")
        else:
            for idx in changed:
                tenants[idx].refresh_graph()
                tenants[idx].boundary.evict_solver_caches(reason="churn")

    def round_once(rnd: int) -> None:
        if churn:
            step_churn(rnd)
        active: list[int] = []
        for i, t in enumerate(tenants):
            mode = t.boundary.begin_round(rnd)
            if mode == OPEN:
                skip_round(t, rnd)
                continue
            if mode == HALF_OPEN or t.state is None or t.remask:
                # one monitor behind the gate decides whether this round runs
                probe = _admitted_monitor(t)
                if probe is None:
                    skip_round(t, rnd)
                    continue
                t.state = probe
                t.remask = False
            active.append(i)
        if not active:
            update_fleet_health()
            return
        if prof is not None:
            prof.maybe_start(label="fleet_rounds", round=rnd)
        t0 = time.perf_counter()
        # inactive slots carry the first active tenant's snapshot (shapes
        # stay static) and are masked; their graphs are their own
        filler = tenants[active[0]].state
        active_set = set(active)
        slot_states = [device_view(t.state if i in active_set else filler)
                       for i, t in enumerate(tenants)]
        graphs = [t.solve_graph(staged) for t in tenants]
        mask_np = np.zeros((T,), bool)
        mask_np[active] = True
        mask = torch.from_numpy(mask_np).to(dev)
        g_moves = g_objs = decisions = hazard = fc_rows = hbm = None
        if fleet_mode == "global":
            gens, plans = [], []
            for t in tenants:
                gens.append(round_generator(t.seed, rnd))
                plans.append(t.solver_plans(rnd) if t.solver_plans is not None else None)
            solve_kw = dict(config=solver_cfg, generators=gens, plans=plans,
                            n_restarts=config.solver_restarts)
            with span("fleet/global_solve", round=rnd, tenants=len(active)):
                if dp_mesh is not None:
                    out = dp_fleet.fleet_global_solve_dp(slot_states, graphs, mask,
                                                         mesh=dp_mesh, with_hbm=with_hbm,
                                                         **solve_kw)
                    flat_dev = torch.cat(out) if with_hbm else out
                else:
                    flat_dev = fleet_global_solve(slot_states, graphs, mask, **solve_kw)
                flat = pull(flat_dev, site=DECISION_SITE, registry=registry)
            mesh_bytes = int(flat.nbytes)
            if with_hbm:
                flat, hbm = flat[:-dp_mesh.shape["dp"]], flat[-dp_mesh.shape["dp"]:]
            num_services = graphs[0].num_services
            if dp_mesh is not None:
                g_moves, g_objs = dp_fleet.decode_fleet_global_dp(
                    flat, tenants=T, num_services=num_services, dp=dp_mesh.shape["dp"])
            else:
                g_moves, g_objs = decode_fleet_global(flat, tenants=T,
                                                      num_services=num_services)
        else:
            gumbel = None
            if scoring == "random":
                rows = [tenants[i].noise_row(rnd) if i in active_set
                        else torch.zeros(filler.num_nodes) for i in range(T)]
                gumbel = to_device(torch.stack(rows), dev)
            stacked = stack_tenants(slot_states)
            parts = []
            if forecast_plane is not None:
                # every active tenant's observed loads into its model, one
                # step for the fleet; the diag matrix rides the decision read
                with span("fleet/forecast", round=rnd, tenants=len(active)):
                    deltas, diag_dev = forecast_plane.observe_and_predict(stacked, mask)
            with span("fleet/solve", round=rnd, tenants=len(active)):
                if forecast_plane is not None:
                    parts.append(diag_dev.reshape(-1))
                if dp_mesh is not None:
                    out = (dp_fleet.fleet_solve_proactive_dp(
                        stacked, graphs, pid, thr, mask, deltas, gumbel, mesh=dp_mesh,
                        with_hbm=with_hbm) if forecast_plane is not None else
                        dp_fleet.fleet_solve_dp(stacked, graphs, pid, thr, mask, gumbel,
                                                mesh=dp_mesh, with_hbm=with_hbm))
                    dec_dev, hz_dev = out[:2]
                    parts.extend(out[2:])
                elif forecast_plane is not None:
                    dec_dev, hz_dev = fleet_solve_proactive(stacked, graphs, pid, thr, mask,
                                                            deltas, gumbel)
                else:
                    dec_dev, hz_dev = fleet_solve(stacked, graphs, pid, thr, mask, gumbel)
                n_nodes = int(hz_dev.shape[1])
                flat = pull(torch.cat([dec_dev.reshape(-1).float(), hz_dev.reshape(-1).float(),
                                       *parts]),
                            site=DECISION_SITE, registry=registry)
            mesh_bytes = int(flat.nbytes)
            if with_hbm:
                flat, hbm = flat[:-dp_mesh.shape["dp"]], flat[-dp_mesh.shape["dp"]:]
            decisions = flat[:T * 4].reshape(T, 4).astype(np.int64)
            hazard = flat[T * 4:T * 4 + T * n_nodes].reshape(T, n_nodes) > 0.5
            if forecast_plane is not None:
                fc_rows = flat[T * 4 + T * n_nodes:].reshape(T, DIAG_SIZE)
        solve_s = time.perf_counter() - t0
        result.batched_solves += 1
        result.device_solve_s += solve_s
        per_tenant_s = solve_s / len(active)
        # the churned tenants' pending events, taken here on the main thread
        carried = {}
        for i in active:
            if i in churn:
                carried[i] = pending_churn.pop(i, [])
                pending_churn[i] = []

        def tenant_round(i: int) -> RoundRecord:
            """Tenant ``i``'s boundary phase: apply, pace, post-move monitor,
            reconcile."""
            t = tenants[i]
            if fleet_mode == "global":
                moved_names, applied = apply_tenant_global_moves(t, g_moves[i])
                before, after, improved, _pen = g_objs[i]
                rec = RoundRecord(
                    round=rnd, moved=bool(moved_names), most_hazard=None, service=None,
                    target=None, communication_cost=0.0, load_std=0.0,
                    services_moved=tuple(moved_names), decision_latencies_s=(per_tenant_s,),
                    objective_before=before, objective_after=after, solver_improved=improved,
                    applied_moves=tuple(applied),
                )
            else:
                service_name, first_hazard, landed, _ = apply_tenant_move(t, decisions[i],
                                                                          hazard[i])
                moved_name = service_name if landed is not None else None
                rec = RoundRecord(
                    round=rnd, moved=moved_name is not None, most_hazard=first_hazard,
                    service=moved_name, target=landed, communication_cost=0.0, load_std=0.0,
                    services_moved=(moved_name,) if moved_name else (),
                    decision_latencies_s=(per_tenant_s,),
                    applied_moves=((moved_name, landed),) if moved_name else (),
                    forecast=decode_diag(fc_rows[i]) if fc_rows is not None else None,
                )
            close_tenant_round(t, rnd, rec, carried.get(i))
            return rec

        def pooled_round(i: int):
            """Tenant ``i``'s boundary phase on a worker: on its own stream,
            with an event after it. Returns ``(record, event, seconds)``."""
            t_bg = time.perf_counter()
            ctx, stream = tenants[i].phase_stream()
            with ctx:
                rec = tenant_round(i)
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
            return rec, event, time.perf_counter() - t_bg

        if pool is not None and len(active) > 1:
            t_par = time.perf_counter()
            futures = {i: pool.submit(pooled_round, i) for i in active}
            records, busy = {}, 0.0
            for i in active:
                records[i], event, secs = futures[i].result()
                busy += secs
                t = tenants[i]
                t.state = adopt_snapshot(t.state, event, dev)
            par_wall = time.perf_counter() - t_par
            ratio = max(0.0, min(1.0, 1.0 - par_wall / busy)) if busy > 1e-9 else 0.0
            overlap_gauge.set(ratio)
            result.pipeline_overlap.append(ratio)
        else:
            records = {i: tenant_round(i) for i in active}

        # ONE metrics bundle closes the round for every tenant (with the
        # rollup riding it); inactive slots' rows use the filler snapshot
        filler = tenants[active[0]].state
        after_states = [device_view(t.state if i in active_set else filler)
                        for i, t in enumerate(tenants)]
        after_graphs = [t.graph for t in tenants]
        edges = [t.edges() for t in tenants]
        rollup = None
        if rollup_on:
            flags = np.zeros((T, 3), np.float32)
            for i, t in enumerate(tenants):
                if i in active_set:
                    flags[i, 0] = float(records[i].degraded)
                else:
                    flags[i, 1] = 1.0
                flags[i, 2] = float(t.last_drift)
            merge = torch.from_numpy(mask_np | ~ever_good)
            flat = pull(dispatch_fleet_bundle(after_states, after_graphs, edges,
                                              torch.from_numpy(last_pair).to(dev),
                                              torch.from_numpy(flags), merge, top_k=rollup_k),
                        site=METRICS_SITE, registry=registry)
            metrics, rollup = decode_fleet_bundle(flat, tenants=T, top_k=rollup_k)
            mesh_bytes += int(flat.nbytes)
        else:
            metrics = pull(fleet_metrics(after_states, after_graphs, edges),
                           site=METRICS_SITE, registry=registry)
            mesh_bytes += int(metrics.nbytes)
        wall = time.perf_counter() - t0
        observe_wall_round(registry, "fleet", wall)
        result.round_wall_s.append(wall)
        for i in range(T):
            if i not in active_set and not ever_good[i]:
                last_pair[i] = metrics[i]
        for i in active:
            rec = records[i]
            rec.communication_cost = float(metrics[i, 0])
            rec.load_std = float(metrics[i, 1])
            rec.wall_s = wall
            last_pair[i] = metrics[i]
            ever_good[i] = True
            emit_tenant_round(tenants[i], rec, rnd)
        # attribution weights: this round's per-tenant comm cost (tenant
        # block i's share of the dispatch lands on device i)
        observe_mesh(dispatch_s=solve_s, transfer_bytes=mesh_bytes, weights=metrics[:, 0],
                     rounds=1, rnd=rnd, hbm=hbm)
        if rollup is not None:
            emit_rollup(rollup, rnd)
        update_fleet_health()
        if prof is not None:
            prof.advance(1)

    scan_k = config.scan_block
    trip_on = bool(scan_k) and config.scan_tripwires
    # the pipelined fleet's worker pool (config.validate() keeps it apart
    # from the fleet scan)
    pool = overlap_gauge = None
    if config.pipeline and T > 1:
        pool = ThreadPoolExecutor(max_workers=min(T, 8), thread_name_prefix="krt-fleet")
        pipeline_depth_gauge(registry).set(config.pipeline_depth)
        overlap_gauge = pipeline_overlap_gauge(registry)

    def scan_static_reason() -> str | None:
        from kubernetes_rescheduling_tpu_torch.backends.sim_device import scan_compatible

        if on_round is not None:
            return "on-round"
        if churn:
            return "churn"
        if any(not scan_compatible(t.boundary.backend) for t in tenants):
            return "backend"
        return None

    def scan_block(start: int, k: int) -> int:
        """One fleet block: every tenant advanced ``k`` rounds on the device,
        read as ONE counted ``round_end`` transfer, then the moves replayed
        per tenant in the sequential call order. Returns the rounds
        committed: ``k``, or the earliest tripped round across tenants."""
        if ops is not None:
            ops.health.mark_block_inflight(k)
        if prof is not None:
            prof.maybe_start(label="fleet_scan_block", rounds=k, round=start)
        t0 = time.perf_counter()
        states = [device_view(t.state) for t in tenants]
        n_nodes = states[0].num_nodes
        scan_rollup_k = rollup_k if rollup_on else 0
        gumbel = None
        if scoring == "random":
            gumbel = to_device(torch.stack([
                torch.stack([t.noise_row(start + r) for t in tenants]) for r in range(k)
            ]), dev)
        drift = (torch.tensor([float(t.last_drift) for t in tenants], dtype=torch.float32)
                 if scan_rollup_k else None)
        with span("fleet/scan_block", round=start, rounds=k, tenants=T):
            flat = scan_mod.pull_block(
                scan_mod.fleet_scan_rounds(
                    states, [t.graph for t in tenants], [t.edges() for t in tenants], pid, thr,
                    gumbel, drift,
                    tripwire_mod.trip_config_array(config, dev) if trip_on else None,
                    rounds=k, pinned=True, rollup_k=scan_rollup_k, tripwire=trip_on,
                ),
                registry,
            )
        fence_s = time.perf_counter() - t0
        scan_mod.count_scan_block(registry, k)
        result.batched_solves += 1
        result.device_solve_s += fence_s
        # the whole block bundle's bytes, tripwire lanes included
        block_bytes = int(flat.nbytes)
        trip = None
        if trip_on:
            flat, trip = tripwire_mod.split_fleet_tripwire(flat, rounds=k, tenants=T)
        decoded = scan_mod.decode_fleet_block(flat, rounds=k, tenants=T, num_nodes=n_nodes,
                                              rollup_k=scan_rollup_k)
        decisions, hazard, landed_idx, metrics = decoded[:4]
        rollups = decoded[4] if scan_rollup_k else None
        # per-tenant comm cost summed over the block's rounds
        observe_mesh(dispatch_s=fence_s, transfer_bytes=block_bytes,
                     weights=metrics[..., 0].sum(axis=0), rounds=k, rnd=start)
        commit = k
        trip_info = None
        if trip is not None and trip.tripped:
            # fleet-wide truncation at the earliest trip: every tenant's
            # ledger advances in lockstep, and the tripped round re-runs
            # per round (the untripped tenants re-decide identically)
            trip_rounds = np.asarray(trip.trip_round)
            commit = int(trip_rounds[trip_rounds >= 0].min())
            tripped = {}
            for i, t in enumerate(tenants):
                if trip_rounds[i] < 0:
                    continue
                rules = tripwire_mod.rules_from_mask(int(trip.trip_mask[i]))
                tripwire_mod.count_tripwire(registry, rules)
                tseries.counter_inc(
                    "fleet_scan_tripwires_total",
                    "scan blocks tripped by this tenant's in-block tripwire lane", t.name)
                tripped[t.name] = {"round": start + int(trip_rounds[i]),
                                   "block_round": int(trip_rounds[i]), "rules": list(rules),
                                   "mask": int(trip.trip_mask[i])}
            trip_info = {"round": start + commit, "block_start": start,
                         "block_round": commit, "rules": list(trip.rules),
                         "mask": int(np.bitwise_or.reduce(np.asarray(trip.trip_mask))),
                         "tenants": tripped}
            if logger is not None:
                logger.warn("scan_tripwire", **trip_info)
        per_tenant_s = fence_s / (k * T)
        resync: set[int] = set()  # tenants whose replay diverged from the twin
        for r in range(commit):
            rnd = start + r
            t_r0 = time.perf_counter()
            last = r == commit - 1
            for t in tenants:
                t.boundary.begin_round(rnd)  # CLOSED stays CLOSED
            for i, t in enumerate(tenants):
                state = t.state
                service_name, first_hazard, landed, attempted = apply_tenant_move(
                    t, decisions[r, i], hazard[r, i], apply=i not in resync)
                moved_name = service_name if landed is not None else None
                if attempted:
                    expected = (state.node_names[int(landed_idx[r, i])]
                                if landed_idx[r, i] >= 0 else None)
                    if landed != expected:
                        # the backend disagreed with the twin: stop applying
                        # this tenant's block, degrade, re-monitor next round
                        resync.add(i)
                        t.remask = True
                        if logger is not None:
                            logger.warn("scan_twin_divergence", tenant=t.name, round=rnd,
                                        service=service_name, expected=expected,
                                        landed=landed)
                t.boundary.advance(config.sleep_after_action_s)
                degraded = i in resync
                fresh = False
                if last and i not in resync:
                    new_state = _admitted_monitor(t)
                    degraded = new_state is None
                    if not degraded:
                        t.state = new_state
                        fresh = True
                reconcile, t.last_drift = reconcile_round_block(
                    t.guard, t.ledger, state=t.state, service_names=t.graph.names,
                    churn_events=(), fresh=fresh, last_drift=t.last_drift,
                    boundary=t.boundary, repair_budget=config.repair_budget_per_round,
                )
                rec = RoundRecord(
                    round=rnd, moved=moved_name is not None, most_hazard=first_hazard,
                    service=moved_name, target=landed,
                    communication_cost=float(metrics[r, i, 0]),
                    load_std=float(metrics[r, i, 1]),
                    services_moved=(moved_name,) if moved_name else (),
                    decision_latencies_s=(per_tenant_s,), breaker_state=t.breaker.state,
                    degraded=degraded, boundary_failures=t.boundary.round_failures,
                    applied_moves=((moved_name, landed),) if moved_name else (),
                    reconcile=reconcile,
                    wall_s=fence_s / k + time.perf_counter() - t_r0,
                )
                last_pair[i] = metrics[r, i]
                ever_good[i] = True
                emit_tenant_round(t, rec, rnd)
            if rollups is not None:
                emit_rollup(decode_rollup(rollups[r], top_k=scan_rollup_k), rnd)
            observe_wall_round(registry, "scanned", fence_s / k + time.perf_counter() - t_r0)
            update_fleet_health()
        result.round_wall_s.append(time.perf_counter() - t0)
        if ops is not None:
            # every block reports: a clean one clears the scan_tripwire rule
            # and the in-flight staleness scaling
            ops.observe_scan_block(rounds=k, trip=trip_info)
        if prof is not None:
            prof.advance(k)
        return commit

    def run_rounds() -> None:
        """Scanned blocks in the steady state (``config.scan_block``), the
        per-round path otherwise; a round the scan cannot honor drains,
        counted in ``scan_drains_total{reason}``."""
        static_reason = scan_static_reason() if scan_k else None
        rnd = 1
        while rnd <= config.max_rounds:
            if scan_k:
                reason = static_reason
                if reason is None:
                    if any(t.breaker.state != CLOSED for t in tenants):
                        reason = "breaker"
                    elif any(t.state is None for t in tenants):
                        reason = "backend"
                    elif any(t.remask for t in tenants):
                        reason = "churn"
                    elif config.max_rounds - rnd + 1 < scan_k:
                        reason = "tail"
                if reason is None:
                    consumed = scan_block(rnd, scan_k)
                    rnd += consumed
                    if consumed < scan_k:
                        scan_mod.count_scan_drain(registry, "tripwire")
                        if ops is not None:
                            ops.observe_scan_drain("tripwire")
                        round_once(rnd)
                        rnd += 1
                    continue
                scan_mod.count_scan_drain(registry, reason)
                if ops is not None:
                    ops.observe_scan_drain(reason)
            round_once(rnd)
            rnd += 1

    try:
        run_rounds()
    except BaseException as e:
        # whatever escapes the loop leaves a flight-recorder bundle behind
        if ops is not None:
            ops.on_crash(e)
        raise
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        if prev_logger_state is not None:
            logger.registry, logger.max_records_per_tenant = prev_logger_state

    for t in tenants:
        t.result.breaker_transitions = list(t.breaker.transitions)
        t.result.boundary_failures = t.boundary.total_failures
        result.results[t.name] = t.result
    return result
