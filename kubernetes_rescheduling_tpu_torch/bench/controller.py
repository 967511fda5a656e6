"""Backend-driven control loop — the port of the sequential schedule of
``kubernetes_rescheduling_tpu.bench.controller``.

The live counterpart of ``solver.run_rounds``: the same decision
(detect → victim → choose) runs one round at a time, with cluster I/O
between rounds going through a :class:`~bench.boundary.BoundaryClient`.
This is the loop the reference runs against a real cluster
(main.py:56-112); here it runs against the simulator.

The ``global`` algorithm (and ``moves_per_round="all"``) routes a round
through the batched solver instead: one solve — dense, or block-local
sparse with ``solver_backend="sparse"`` — then every service whose node
changed is moved, or with a numeric ``global_moves_cap`` k only the k
best strictly improving moves (the wave cap). ``placement_unit="pod"``
solves on the pod-level graph and moves single replicas in one wave.

Around the rounds: every monitor snapshot passes the admission guard
(``bench/admission.py``), the intent ledger (``bench/reconcile.py``) diffs
it against the controller's own moves and repairs drift, rounds carry
decision explanations when a logger listens, a checkpoint directory makes
a run resumable, a churn engine (``elastic/``) deploys, tears down,
scales and drains between rounds, and in shadow mode (``config.shadow``,
a replayed trace behind ``backends/replay.py``) the shadow plane
(``bench/shadow.py``) scores a counterfactual twin of our placement against
the recorded one, riding the round-end read.

Three schedules run the rounds, with the same records:

- sequential (:meth:`_Runtime.sequential_round`);
- pipelined (``config.pipeline``, :func:`_pipelined_loop`): the previous
  round's flush and host tail overlap this round's device work, and the
  post-move advance and monitor run on a background thread (with its own
  CUDA stream on the card), while the backend sees the sequential call
  order;
- scanned (``config.scan_block`` K, :func:`_scanned_loop`): K steady-state
  rounds as one device block (``bench/scan.py``) and one counted transfer,
  the moves replayed into the backend afterwards in the sequential call
  order.

A round either schedule cannot honor drains to the sequential path.

Host reads per executed round: one batched :func:`~bench.round_end.fence`
per decision or solve (two in a pod round: the pod set before the solve,
the placement after it), one :meth:`~bench.round_end.RoundCloser.flush`
that carries the round's closing metrics, the solver's objectives and the
explanation bundles, one admission read per monitor, and on capped or
explained global rounds one read of the move-scoring inputs. A scan block
reads the device once (its bundle, a ``round_end`` transfer) and admits one
monitor at its end, whatever its K.

``algorithm="proactive"`` runs the greedy round against the state the
forecast plane (``forecast/plane.py``) predicts for the next window: one
captured forecast step a round before the decision, its diagnostics riding
the round-end read into ``RoundRecord.forecast``.

Randomness: round ``r`` draws from the generator of ``(config.seed, r)``
(``_random.round_generator``), so a round's decisions do not depend on
the rounds before it. Keyword arguments of :func:`run_controller`, used by
the tests, supply the draws instead: ``gumbel_rows`` (the ``random``
policy's noise row of each decision) and ``solver_plans`` (the global
solver's per-sweep plans of each round); ``forecast_deltas`` supplies the
forecast's load deltas the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch._random import gumbel as draw_gumbel
from kubernetes_rescheduling_tpu_torch._random import round_generator
import numpy as np

from kubernetes_rescheduling_tpu_torch.backends.base import Backend, MoveRequest, PlacementMechanism
from kubernetes_rescheduling_tpu_torch.backends.chaos import with_chaos
from kubernetes_rescheduling_tpu_torch.bench import scan as scan_mod
from kubernetes_rescheduling_tpu_torch.bench.admission import AdmissionGuard
from kubernetes_rescheduling_tpu_torch.bench.boundary import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BoundaryClient,
    CircuitBreaker,
)
from kubernetes_rescheduling_tpu_torch.bench.reconcile import (
    KIND_UNKNOWN_LANDING,
    IntentLedger,
    count_divergence,
    move_intent,
    reconcile_round_block,
)
from kubernetes_rescheduling_tpu_torch.bench.round_end import (
    METRIC_COST,
    METRIC_HEAD,
    METRIC_LOAD_STD,
    RoundCloser,
    dispatch_round_end,
    fence,
)
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
from kubernetes_rescheduling_tpu_torch.objectives.metrics import comm_edge_list
from kubernetes_rescheduling_tpu_torch.policies.proactive import scoring_policy
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    GlobalSolverConfig,
    global_assign,
    pct_balance_terms,
)
from kubernetes_rescheduling_tpu_torch.solver.compiled import to_device
from kubernetes_rescheduling_tpu_torch.solver.round_loop import (
    decide,
    decide_explain,
    decide_explain_with_forecast,
    decide_with_forecast,
)
from kubernetes_rescheduling_tpu_torch.telemetry import attribution as attribution_mod
from kubernetes_rescheduling_tpu_torch.telemetry import costmodel
from kubernetes_rescheduling_tpu_torch.telemetry import tripwire as tripwire_mod
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull_arrays
from kubernetes_rescheduling_tpu_torch.telemetry.explain import (
    greedy_explanation,
    solver_explanation,
)
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from kubernetes_rescheduling_tpu_torch.telemetry.spans import span
from kubernetes_rescheduling_tpu_torch.utils.checkpoint import CheckpointManager
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger

# the wave cap's and the global explanation's host read of the move-scoring
# inputs (device_transfers_total{site=...})
MOVE_GAINS_SITE = "move_gains"


@dataclass
class RoundRecord:
    round: int
    moved: bool
    most_hazard: str | None
    service: str | None
    target: str | None  # node the first move actually landed on
    communication_cost: float
    load_std: float
    services_moved: tuple[str, ...] = ()  # every Deployment recreated this round
    decision_latencies_s: tuple[float, ...] = ()  # one sample per decide/solve
    # global rounds: the solver's own before/after accounting
    objective_before: float | None = None
    objective_after: float | None = None
    solver_improved: bool | None = None
    # the breaker state the round ran under, whether it closed on a stale
    # snapshot (the post-move monitor failed), and its boundary failures
    breaker_state: str = "closed"
    degraded: bool = False
    boundary_failures: int = 0
    # one DecisionExplanation dict per decide/solve (telemetry.explain);
    # empty when explanations are off
    explanations: tuple[dict, ...] = ()
    # cost attribution (telemetry.attribution): the per-edge / node-pair
    # decomposition of communication_cost plus the round's move provenance
    # — None when attribution is off
    attribution: dict | None = None
    # every move that LANDED this round as (service, landed_node) pairs
    applied_moves: tuple[tuple[str, str], ...] = ()
    # the churn applied before this round (elastic/engine.py): events, live
    # S/N/P counts, the shape buckets and the promotions so far — None on
    # static runs
    churn: dict | None = None
    # the reconcile and admission planes' activity this round: admission
    # quarantine/reject counts, classified divergences, corrective moves
    # and the pods still diverged — None when the round was clean
    reconcile: dict | None = None
    # proactive rounds: the forecast plane's block (skill, MAEs, cold /
    # predictive / degraded path) — None on reactive rounds
    forecast: dict | None = None
    # shadow mode (bench/shadow.py): the round's head-to-head against the
    # replayed trace's scheduler (costs, delta, running win rate, the twin's
    # attribution with attribution on) — None outside shadow runs and on
    # unscored (degraded) rounds
    shadow: dict | None = None
    # timing fields: execute start to record finalize, and wall seconds of
    # the round's phases ("decide" or "solve", "select" on capped or
    # explained global rounds, "forecast" on proactive rounds, "apply",
    # "monitor", "admission", "reconcile", "round_end"; "shadow" in shadow
    # mode: the twin's host realign and re-homing)
    wall_s: float = 0.0
    phase_s: dict[str, float] = field(default_factory=dict)
    # the pipelined schedule's telemetry (timing field): depth, the share of
    # the background advance+monitor hidden behind foreground work, and
    # the raw background and blocked seconds — None on sequential rounds
    pipeline: dict | None = None

    @property
    def decision_latency_s(self) -> float:
        """Total decision time this round (no cluster I/O)."""
        return sum(self.decision_latencies_s)

    @property
    def decisions(self) -> int:
        return len(self.decision_latencies_s)

    def as_dict(self) -> dict:
        return {
            **self.__dict__,
            "decision_latency_s": self.decision_latency_s,
            "decisions": self.decisions,
        }


@dataclass
class ControllerResult:
    rounds: list[RoundRecord] = field(default_factory=list)
    resumed_from_round: int = 0  # > 0 when a checkpoint resume skipped rounds
    # rounds the open breaker froze: max_rounds == len(rounds) + skipped_rounds
    skipped_rounds: int = 0
    breaker_transitions: list[dict] = field(default_factory=list)
    boundary_failures: int = 0

    @property
    def degraded_rounds(self) -> int:
        return sum(1 for r in self.rounds if r.degraded)

    @property
    def decisions_per_sec(self) -> float:
        lat = sum(r.decision_latency_s for r in self.rounds)
        n = sum(r.decisions for r in self.rounds if r.decision_latency_s > 0)
        return n / lat if lat > 0 else 0.0

    @property
    def moves(self) -> int:
        return sum(1 for r in self.rounds if r.moved)

    def latency_summary(self) -> dict[str, float]:
        """The per-decision latency distribution, from every decision's
        own sample (a capture-heavy first solve shows in max and p99)."""
        from kubernetes_rescheduling_tpu_torch.utils.profiling import LatencyHistogram

        hist = LatencyHistogram()
        for r in self.rounds:
            for s in r.decision_latencies_s:
                hist.add(s)
        return hist.summary()


def _emit_round_metrics(registry: MetricsRegistry, algorithm: str, record: RoundRecord) -> None:
    """One metric sample set per completed round."""
    lab = {"algorithm": algorithm}
    registry.counter(
        "rounds_total", "rescheduling rounds executed", labelnames=("algorithm",)
    ).labels(**lab).inc()
    registry.counter(
        "services_moved_total", "deployments recreated by rescheduling moves",
        labelnames=("algorithm",),
    ).labels(**lab).inc(len(record.services_moved))
    hist = registry.histogram(
        "decision_seconds", "decision latency per decide/solve", labelnames=("algorithm",),
    ).labels(**lab)
    for s in record.decision_latencies_s:
        hist.observe(s)
    registry.gauge(
        "communication_cost", "communication cost after the most recent round",
        labelnames=("algorithm",),
    ).labels(**lab).set(record.communication_cost)
    registry.gauge(
        "load_std", "node CPU-% standard deviation after the most recent round",
        labelnames=("algorithm",),
    ).labels(**lab).set(record.load_std)
    if record.objective_before is not None:
        registry.gauge(
            "solver_objective_before",
            "solver objective of the incoming placement (global rounds)",
            labelnames=("algorithm",),
        ).labels(**lab).set(record.objective_before)
    if record.objective_after is not None:
        registry.gauge(
            "solver_objective_after",
            "solver objective of the adopted placement (global rounds)",
            labelnames=("algorithm",),
        ).labels(**lab).set(record.objective_after)


# wall-clock round-latency buckets (milliseconds)
_WALL_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)


def adopt_snapshot(state, event, device):
    """Make a snapshot that a background thread built on its own stream
    usable on this thread's stream: wait for the event recorded after its
    upload, and mark its tensors used here, so the allocator does not hand
    their memory to that stream's next upload while this stream still reads
    them. ``event`` None (the CPU) returns ``state`` as it is."""
    if event is None:
        return state
    cur = torch.cuda.current_stream(device)
    cur.wait_event(event)
    if state is not None:
        for f in dataclasses.fields(state):
            t = getattr(state, f.name)
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(cur)
    return state


def observe_wall_round(registry: MetricsRegistry, mode: str, wall_s: float) -> None:
    """One executed round's wall time under ``mode`` (``sequential``,
    ``pipelined`` or ``scanned``)."""
    registry.histogram(
        "wall_round_ms",
        "wall-clock lifecycle of one executed controller round "
        "(execute start to record finalize), by schedule",
        labelnames=("mode",),
        buckets=_WALL_MS_BUCKETS,
    ).labels(mode=mode).observe(wall_s * 1e3)


def pipeline_depth_gauge(registry: MetricsRegistry):
    """``pipeline_depth`` (set only by pipelined runs)."""
    return registry.gauge(
        "pipeline_depth",
        "configured software-pipeline depth of the control loop (0/absent = sequential)",
    )


def pipeline_overlap_gauge(registry: MetricsRegistry):
    """``pipeline_overlap_ratio`` (set only by pipelined runs)."""
    return registry.gauge(
        "pipeline_overlap_ratio",
        "fraction of the background boundary (advance+monitor) time hidden behind "
        "foreground work, most recent pipelined round",
    )


class _Runtime:
    """The loop's machinery: boundary, breaker, admission guard, intent
    ledger, churn, checkpoints, the round-end protocol and the per-round
    helpers the three schedules compose."""

    def __init__(self, backend, config: RescheduleConfig, *, device, registry,
                 gumbel_rows=None, solver_plans=None, forecast_deltas=None,
                 logger: StructuredLogger | None = None,
                 checkpoint_dir: str | None = None, graph=None, on_round=None, churn=None,
                 ops=None):
        self.config = config
        self.ops = ops
        self.registry = registry
        self.device = device
        self.gumbel_rows = gumbel_rows
        self.solver_plans = solver_plans
        self.forecast_deltas = forecast_deltas
        # the forecast plane: one online forecaster a proactive run
        self.forecast_plane = None
        if config.algorithm == "proactive":
            from kubernetes_rescheduling_tpu_torch.forecast.plane import ForecastPlane

            self.forecast_plane = ForecastPlane(config.forecast, registry=registry,
                                                device=device)
        self.logger = logger
        self.on_round = on_round
        if config.chaos != "none":
            # the loop's view of the backend injects the profile's faults;
            # everything below (boundary, churn, checkpoints) sees the wrapper
            backend = with_chaos(backend, config.chaos, seed=config.chaos_seed,
                                 registry=registry)
        self.breaker = CircuitBreaker(
            max_consecutive_failures=config.max_consecutive_failures,
            cooldown_rounds=config.breaker_cooldown_rounds,
            logger=logger,
            registry=registry,
        )
        self.boundary = BoundaryClient(
            backend,
            policy=config.retry,
            breaker=self.breaker,
            failure_budget_per_round=config.failure_budget_per_round,
            registry=registry,
        )
        # every monitor result passes the admission guard before it becomes
        # device state (monitor_admitted), and the intent ledger closes the
        # loop on this controller's own moves
        self.guard = (
            AdmissionGuard(max_quarantine_frac=config.max_quarantine_frac, registry=registry,
                           logger=logger, on_reject=self.boundary.admission_reject)
            if config.reconcile_admission else None
        )
        # an advisory-only backend (shadow replay) makes the snapshot stream
        # ground truth: the ledger's diffs adopt, never charge
        self.ledger = (IntentLedger(registry=registry, logger=logger,
                                    adopt_observed=self.advisory_only)
                       if config.reconcile_enabled else None)
        self.shadow = None
        if config.shadow.enabled:
            # recommendations land in the replay backend's shadow ledger, and
            # a counterfactual twin scores our cumulative placement against
            # the trace's, riding the round-end read
            from kubernetes_rescheduling_tpu_torch.bench.shadow import ShadowPlane

            self.shadow = ShadowPlane(config.shadow, registry=registry, logger=logger)
        if churn is None and config.elastic != "none":
            from kubernetes_rescheduling_tpu_torch.elastic.engine import ChurnEngine

            churn = ChurnEngine(config.elastic, seed=config.elastic_seed,
                                bucket_floor=config.bucket_floor, registry=registry)
        self.churn = churn
        if churn is not None:
            # through the boundary's passthrough; bind() pushes the initial
            # bucket capacities, so even round 1's snapshot is padded
            churn.bind(self.boundary, config.max_rounds, registry=registry)
        if ops is not None:
            ops.bind(breaker=self.breaker, logger=logger, algorithm=config.algorithm)
            self.breaker.on_transition = ops.on_breaker_transition
        # explanations: on when configured AND someone listens (a logger or
        # the ops plane) — the bare loop keeps the plain decision
        listening = ops is not None or logger is not None
        self.explain_k = config.explain_top_k if config.explain and listening else 0
        # cost attribution rides the same gate: its bundle rides the
        # round-end transfer the loop pays anyway
        self.attr_k = config.attribution_top_k if config.attribution and listening else 0
        self.timeline = attribution_mod.PlacementTimeline() if self.attr_k > 0 else None
        # the captured graph whose recorded cost the round's roofline reads
        # (costmodel.observe_round_device): the solve of a global round
        # (sparse and pod rounds go through the sparse solve, which routes a
        # one-block graph through the dense one), the forecast step of a
        # proactive round; a greedy decide is not captured
        if config.algorithm == "global" or config.moves_per_round == "all":
            self.roofline_fns = (
                ("global_assign_sparse", "global_assign")
                if config.solver_backend == "sparse" or config.placement_unit == "pod"
                else ("global_assign",))
        elif self.forecast_plane is not None:
            self.roofline_fns = ("controller_forecast",)
        else:
            self.roofline_fns = ()
        # in-block tripwires of the scanned schedule; the latest tripped
        # block's report waits in scan_trip until _scanned_loop drains it
        self.scan_tripwire = bool(config.scan_block and config.scan_tripwires)
        self.scan_trip: dict | None = None
        # decisions may run on a caller's graph (a callable is re-read each
        # round); the round-end metrics always use the backend's declared one
        self.metric_graph = self.boundary.comm_graph().to(device)
        self.graph_static = graph is None or not callable(graph)
        if graph is None:
            self.graph_src = lambda: self.metric_graph
        elif callable(graph):
            self.graph_src = lambda: graph().to(device)
        else:
            static = graph.to(device)
            self.graph_src = lambda: static
        self.result = ControllerResult()
        # the monitor's own stream in the pipelined schedule (made at first use)
        self._monitor_stream = None

        self.mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.start_round = 1
        resumed_pending_churn: list[dict] = []
        if self.mgr is not None:
            latest = self.mgr.latest(device=device)
            if latest is not None:
                done_round, saved_state, extra = latest
                if churn is not None:
                    # the event stream depends only on (profile, seed, round,
                    # topology), never on moves: replaying it over the
                    # completed rounds rebuilds the checkpoint's topology and
                    # puts the churn generator where the uninterrupted run had it
                    for past in range(1, done_round + 1):
                        churn.step(past)
                    self.metric_graph = self.boundary.comm_graph().to(device)
                restore = getattr(backend, "restore_placement", None)
                if restore is not None:
                    restore(saved_state)
                if self.ledger is not None:
                    # the first admitted snapshot is reconciled against the
                    # checkpointed intent instead of trusted: whatever moved
                    # while the controller was down is a counted divergence
                    self.ledger.restore(extra.get("reconcile"))
                # churn a skipped round applied and no record carried yet
                resumed_pending_churn = [dict(e) for e in extra.get("pending_churn") or []]
                self.start_round = done_round + 1
                self.result.resumed_from_round = self.start_round
                if logger is not None:
                    logger.info("resume", round=self.start_round, checkpoint=done_round)

        # churn debt that survives skipped rounds: events applied but not
        # yet carried by a record (pending_churn), and a snapshot that
        # predates applied churn (remask_needed: the next executed round
        # monitors afresh before deciding)
        self.remask_needed = False
        self.rebind_timeline = False
        self.pending_churn: list[dict] = resumed_pending_churn
        # the previous round's unrepaired drift: a round that resolves it
        # still carries an explicit drift_pods=0
        self._last_drift = 0
        self._admit_s = self._diff_s = 0.0
        # one snapshot per round: the post-move snapshot gives this round's
        # metrics AND the next round's state. Startup has no last good
        # snapshot to fall back on, so the first monitor gets a bounded
        # probe loop on top of the per-call retries
        self.state = None
        self._pending_end: dict | None = None
        self._edge_cache = None
        for _ in range(max(3, config.max_consecutive_failures + 1)):
            probe = self.monitor_admitted()
            if probe is not None:
                self.note_fresh_snapshot(probe)
                break
        if self.state is None:
            raise ConnectionError(
                "backend unavailable: initial monitor() failed after retries "
                "(no last good snapshot to degrade to)"
            )
        if self.timeline is not None:
            # the provenance model: the initial residency, collapsed on the
            # host once a run, the per-move deltas telescope from
            self.timeline.bind(self.state, self.metric_graph)
        if self.ledger is not None:
            if not self.ledger.intent:
                # startup baseline: intent := the first admitted snapshot (a
                # restored intent is reconciled at the first observe instead)
                arrays = self.guard.host_arrays(self.state) if self.guard is not None else None
                self.ledger.rebase(self.state, service_names=self.metric_graph.names,
                                   host_arrays=arrays)
            # the intent as of the last closed round, what a checkpoint saves
            self._ledger_snap = self.ledger.snapshot()
        if self.shadow is not None:
            # twin := the first admitted snapshot's recorded placement, from
            # the guard's host arrays (shadow mode requires admission)
            self.shadow.bind(self.state, self.metric_graph, self._host_arrays(self.state))

    @property
    def advisory_only(self) -> bool:
        """The backend only records moves (the shadow plane's replay
        backend): every intent is advisory."""
        return getattr(self.boundary.raw_backend, "advisory_only", False)

    def _host_arrays(self, state):
        return self.guard.host_arrays(state) if self.guard is not None else None

    def monitor_admitted(self):
        """A boundary monitor on the controller's device, through the
        admission guard: the loop's only call of ``boundary.monitor()``. A
        rejection returns None (the protocol's failure signal) after
        charging the boundary."""
        out = self.boundary.monitor()
        if out is not None:
            out = out.to(self.device)
        t0 = time.perf_counter()
        if self.guard is not None:
            out = self.guard.admit(out)
        self._admit_s = time.perf_counter() - t0
        return out

    def ckpt_extra(self, **extra) -> dict:
        """The checkpoint's sidecar payload: the algorithm, the intent ledger
        as of the last closed round, and churn events no record has carried
        yet (a skipped round's), which a resume reconciles against."""
        extra["algorithm"] = self.config.algorithm
        if self.ledger is not None:
            extra["reconcile"] = self._ledger_snap
        if self.pending_churn:
            extra["pending_churn"] = [dict(e) for e in self.pending_churn]
        return extra

    def save_checkpoint(self, rnd: int, state=None, **extra) -> None:
        if self.mgr is not None:
            self.mgr.save(rnd, self.state if state is None else state,
                          extra=self.ckpt_extra(**extra), registry=self.registry)

    # ---- round-end protocol ----

    def metric_edges(self):
        """The round-end cost's edge list (``comm_edge_list``), built once
        per metric-graph object: churn's graph changes rebuild it. None with
        attribution on: the round end then takes the dense form, whose S×S
        work the attribution bundle needs anyway. None in shadow mode too:
        the twin's round end is the dense form, and the head-to-head's two
        sides must sum in one order."""
        if self.attr_k > 0 or self.shadow is not None:
            return None
        graph = self.metric_graph
        if self._edge_cache is None or self._edge_cache[0] is not graph:
            self._edge_cache = (graph, comm_edge_list(graph))
        return self._edge_cache[1]

    def round_end_ctx(self, state) -> dict:
        """What decoding a snapshot's attribution bundle needs: the names
        and the (bucket-padded) shapes it was computed at."""
        return {"node_names": state.node_names, "svc_names": self.metric_graph.names,
                "num_nodes": state.num_nodes, "num_services": self.metric_graph.num_services}

    def note_fresh_snapshot(self, state) -> None:
        """Adopt a fresh snapshot and queue its round-end metrics (and the
        attribution bundle with attribution on) on the device; they are
        read only when a record closes on them."""
        self.state = state
        self._pending_end = {
            "dev": dispatch_round_end(state, self.metric_graph, top_k=self.attr_k,
                                      edges=self.metric_edges()),
            "ctx": self.round_end_ctx(state),
        }

    def apply_round_metrics(self, rnd: int, record: RoundRecord, cost: float, lstd: float,
                            attr_flat, ctx: dict) -> None:
        """Land a round's closing metrics on its record: the cost and load
        spread and, with attribution on, the decoded bundle with the
        round's move provenance, the gauges and the attribution book. One
        definition for the per-round close and the scan block's decode."""
        record.communication_cost = cost
        record.load_std = lstd
        if self.attr_k <= 0:
            return
        attr = attribution_mod.decode_attribution(
            attr_flat, node_names=ctx["node_names"], service_names=ctx["svc_names"],
            top_k=self.attr_k, num_nodes=ctx["num_nodes"], num_services=ctx["num_services"],
        )
        attr["round"] = rnd
        attr["algorithm"] = self.config.algorithm
        attr.update(self.timeline.observe_round(
            rnd, record.applied_moves, pod_level=self.config.placement_unit == "pod"))
        record.attribution = attr
        attribution_mod.publish_attribution(self.registry, attr, top_k=self.attr_k)
        attribution_mod.get_attribution_book().update(self.config.algorithm, rnd, attr)

    def _attach_metrics(self, rnd: int, record: RoundRecord, closer: RoundCloser) -> None:
        """Register the record's closing metrics on the closer: the pending
        snapshot's tensor, or — when a degraded round closes on a snapshot
        already read — its cached host values (no transfer)."""
        pend = self._pending_end
        ctx = pend["ctx"]
        if "host" in pend:
            cost, lstd, attr_flat = pend["host"]
            closer.defer_host(
                lambda: self.apply_round_metrics(rnd, record, cost, lstd, attr_flat, ctx))
            return
        dev = pend.pop("dev")

        def decode(flat) -> None:
            attr_flat = flat[METRIC_HEAD:] if self.attr_k > 0 else None
            pend["host"] = (float(flat[METRIC_COST]), float(flat[METRIC_LOAD_STD]), attr_flat)
            self.apply_round_metrics(rnd, record, *pend["host"], ctx)

        closer.defer(dev, decode)

    def begin_close(self, record: RoundRecord, closer: RoundCloser, new_state) -> None:
        if self.churn is not None:
            # every event since the last record, a skipped round's included
            record.churn = self.churn.round_info(self.pending_churn)
            self.pending_churn = []
        if new_state is None:
            # the post-move snapshot failed (or was rejected): finish
            # DEGRADED on the last good snapshot instead of crashing
            record.degraded = True
        else:
            self.note_fresh_snapshot(new_state)
        t0 = time.perf_counter()
        self._reconcile_round(record, fresh=new_state is not None)
        self._diff_s = time.perf_counter() - t0
        # the ledger's time this round: its intents at apply and its diff
        record.phase_s["reconcile"] = record.phase_s.get("reconcile", 0.0) + self._diff_s
        # the counters after the repairs: a corrective move is a boundary
        # move like any other, and a failed one shows in this round
        record.breaker_state = self.breaker.state
        record.boundary_failures = self.boundary.round_failures
        self._attach_metrics(record.round, record, closer)
        if self.shadow is not None:
            # AFTER the metrics piece: decode order inside the single flush
            # puts the actual cost on the record before the shadow decode
            # scores against it, and the twin's piece rides the SAME read
            self.shadow.observe_round(
                record.round, record, self.state, self.metric_graph, closer,
                arrays=self._host_arrays(self.state), fresh=new_state is not None,
                top_k=self.attr_k,
            )

    def _reconcile_round(self, record: RoundRecord, *, fresh: bool) -> None:
        """The reconcile plane's step: the admission counts, the round's
        churn events noted on the ledger, and on a fresh snapshot the
        ledger's diff and rate-limited repairs. A degraded round carries
        only the admission counts and the standing drift; its churn events
        wait in the ledger for the next fresh diff."""
        record.reconcile, self._last_drift = reconcile_round_block(
            self.guard,
            self.ledger,
            state=self.state,
            service_names=self.metric_graph.names,
            churn_events=(record.churn or {}).get("events") or (),
            fresh=fresh,
            last_drift=self._last_drift,
            boundary=self.boundary,
            repair_budget=self.config.repair_budget_per_round,
        )
        if self.ledger is not None:
            self._ledger_snap = self.ledger.snapshot()

    # ---- per-round helpers ----

    def skip_round(self, rnd: int) -> None:
        """Safe mode: the open breaker froze this round — count it, pace,
        and checkpoint the carried-over snapshot so resume holds."""
        self.result.skipped_rounds += 1
        self.registry.counter(
            "rounds_skipped_total", "rounds frozen by the open circuit breaker",
            labelnames=("algorithm",),
        ).labels(algorithm=self.config.algorithm).inc()
        # a rejection in this round's probe belongs to this skip
        adm = self.guard.take_info() if self.guard is not None else {}
        if self.logger is not None:
            self.logger.info("round_skipped", round=rnd, breaker=self.breaker.state,
                             consecutive_failures=self.breaker.consecutive_failures,
                             **({"admission": adm} if adm else {}))
        if self.ops is not None:
            self.ops.observe_skip(rnd, breaker_state=self.breaker.state)
        self.boundary.advance(self.config.sleep_after_action_s)
        self.save_checkpoint(rnd, skipped=True)

    def preamble(self, rnd: int) -> bool:
        """Everything before a round may decide: churn events, the breaker
        gate, the half-open probe and the churn re-mask. Returns False when
        the round was a counted skip."""
        if self.churn is not None:
            # the cluster churns whether or not the breaker lets this round
            # run, as real deploys and autoscaling go on under an ailing
            # controller
            events = self.churn.step(rnd)
            if events:
                self.pending_churn.extend(events)
                self.remask_needed = True
                if self.churn.graph_changed:
                    self.metric_graph = self.boundary.comm_graph().to(self.device)
                    self.rebind_timeline = True
        mode = self.boundary.begin_round(rnd)
        if mode == OPEN:
            self.skip_round(rnd)
            return False
        refreshed = False
        if mode == HALF_OPEN:
            # one probe before trusting the backend with a full round; a
            # success closes the breaker and refreshes the stale snapshot
            probe = self.monitor_admitted()
            if probe is None:
                self.skip_round(rnd)
                return False
            self.note_fresh_snapshot(probe)
            refreshed = True
        if self.remask_needed and not refreshed:
            # the carried snapshot predates applied churn: one fresh monitor
            # realigns pod sets and validity masks (shapes stay in their
            # buckets); a dark backend makes this a counted skip and the
            # debt carries to the next executed round
            fresh = self.monitor_admitted()
            if fresh is None:
                self.skip_round(rnd)
                return False
            self.note_fresh_snapshot(fresh)
            refreshed = True
        if refreshed:
            self.remask_needed = False
        if self.rebind_timeline and self.timeline is not None:
            # the provenance model is defined over a fixed service set:
            # re-anchor it at the post-churn snapshot (move deltas
            # telescope within a churn epoch)
            self.timeline = attribution_mod.PlacementTimeline()
            self.timeline.bind(self.state, self.metric_graph)
        self.rebind_timeline = False
        return True

    def solve_graph(self, graph):
        """The decision graph as a solve takes it. Under churn a deploy or a
        teardown builds a new adjacency tensor, which would key a new capture
        (``solver/compiled.py`` keys its operands by identity): the graph's
        adjacency is written in place into one buffer per bucket shape
        instead, so a churned run captures each solve shape once plus once
        a promotion (a promotion clears the backend's solver caches, this
        slot with them). Static runs pass the graph through."""
        if self.churn is None:
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

    def noise_rows(self, rnd: int) -> Callable[[int], torch.Tensor]:
        """The ``random`` policy's noise row of round ``rnd``'s ``i``-th
        decision, on the host, asked for in decision order: the
        ``gumbel_rows`` seam, else the draws of the round's generator."""
        if self.gumbel_rows is not None:
            return lambda i: self.gumbel_rows(rnd, i).cpu()
        gen = round_generator(self.config.seed, rnd)
        return lambda i: draw_gumbel((self.state.num_nodes,), gen, "cpu")

    def execute_round(self, rnd: int, closer: RoundCloser, pre_fence_hook=None) -> RoundRecord:
        """Decide and apply one round's moves (no advance or monitor: the
        schedules own those). ``pre_fence_hook`` runs once after the first
        decision or solve is queued on the device and before its fence —
        the pipelined schedule's overlap window."""
        config = self.config
        graph = self.graph_src()
        # every boundary move this round, as the ledger's intents
        intents: list | None = [] if self.ledger is not None else None
        if config.algorithm == "global" or config.moves_per_round == "all":
            record = _global_round(
                self.boundary, self.state, self.solve_graph(graph), config, rnd,
                generator=round_generator(config.seed, rnd),
                plan=self.solver_plans(rnd) if self.solver_plans is not None else None,
                closer=closer, registry=self.registry, logger=self.logger,
                explain=self.explain_k > 0, intents=intents, pre_fence_hook=pre_fence_hook,
            )
        else:
            forecast_delta = None
            forecast_s = 0.0
            if self.forecast_plane is not None:
                # fold this round's observed loads into the online model and
                # predict the next window: one captured step, its diag
                # riding the round-end read
                t_fc = time.perf_counter()
                with span("controller/forecast", round=rnd):
                    forecast_delta = self.forecast_plane.observe_and_predict(self.state,
                                                                             closer=closer)
                if self.forecast_deltas is not None:
                    forecast_delta = self.forecast_deltas(rnd).to(self.device)
                forecast_s = time.perf_counter() - t_fc
            rows = self.noise_rows(rnd)
            record = _greedy_round(self.boundary, self.state, graph, config, rnd,
                                   noise=lambda i: rows(i).to(self.device),
                                   registry=self.registry, closer=closer,
                                   logger=self.logger, explain_k=self.explain_k,
                                   forecast_delta=forecast_delta,
                                   intents=intents, pre_fence_hook=pre_fence_hook)
            if self.forecast_plane is not None:
                # the forecast step is decision work: it counts in the
                # round's decision latencies, first
                record.decision_latencies_s = (forecast_s,) + record.decision_latencies_s
                record.phase_s["forecast"] = forecast_s
                plane, registry = self.forecast_plane, self.registry

                def finish_forecast() -> None:
                    record.forecast = plane.round_info()
                    plane.publish(registry)

                closer.defer_host(finish_forecast)
        if intents:
            t0 = time.perf_counter()
            self.record_intents(intents)
            record.phase_s["reconcile"] = time.perf_counter() - t0
        return record

    def record_intents(self, intents) -> None:
        """The ledger's capture of a round's applied moves. An advisory-only
        backend (the shadow plane's replay backend) makes every intent
        advisory whatever its mechanism: a recommendation is advisory by
        definition, and the ledger adopts the recorded placement at the next
        diff instead of charging the recorded scheduler's choices as lost
        moves or drift."""
        if self.advisory_only:
            intents = [(*i[:4], True) for i in intents]
        self.ledger.record_moves(intents)

    def emit(self, record: RoundRecord, mode: str = "sequential") -> None:
        """The record's host tail: the result, the round's metrics, the
        logger's round event and ``on_round``."""
        self.result.rounds.append(record)
        _emit_round_metrics(self.registry, self.config.algorithm, record)
        observe_wall_round(self.registry, mode, record.wall_s)
        # device memory gauges and the round's roofline against the
        # captured graph's recorded cost
        costmodel.observe_round_device(self.registry, fn_labels=self.roofline_fns,
                                       seconds=record.decision_latency_s)
        if record.degraded:
            self.registry.counter(
                "degraded_rounds_total",
                "rounds completed on a stale snapshot after boundary failure",
                labelnames=("algorithm",),
            ).labels(algorithm=self.config.algorithm).inc()
        round_event = dict(
            round=record.round,
            moved=record.moved,
            services=list(record.services_moved),
            most_hazard=record.most_hazard,
            communication_cost=record.communication_cost,
            load_std=record.load_std,
            decision_latency_s=record.decision_latency_s,
            objective_before=record.objective_before,
            objective_after=record.objective_after,
            breaker=record.breaker_state,
            degraded=record.degraded,
            boundary_failures=record.boundary_failures,
        )
        if self.logger is not None:
            self.logger.info("round", **round_event)
        if self.ops is not None:
            self.ops.observe_round(
                record, self.state,
                events=[{"event": "decision", **e} for e in record.explanations]
                + [{"event": "round", **round_event}],
            )
        if self.on_round is not None:
            self.on_round(record, self.state)

    def sequential_round(self, rnd: int) -> None:
        """One full round: preamble, execute, advance + monitor, close,
        flush, emit, checkpoint."""
        if not self.preamble(rnd):
            return
        t0 = time.perf_counter()
        closer = RoundCloser(self.registry)
        with span("controller/round", round=rnd, algorithm=self.config.algorithm):
            record = self.execute_round(rnd, closer)
            self.boundary.advance(self.config.sleep_after_action_s)
            t_mon = time.perf_counter()
            with span("backend/monitor"):
                new_state = self.monitor_admitted()
        t_end = time.perf_counter()
        self.begin_close(record, closer, new_state)
        closer.flush()
        t_done = time.perf_counter()
        record.phase_s["admission"] = self._admit_s
        record.phase_s["monitor"] = t_end - t_mon - self._admit_s
        record.phase_s["round_end"] = t_done - t_end - self._diff_s
        record.wall_s = t_done - t0
        self.emit(record)
        # checkpoint last: a crash in on_round replays this round on resume
        self.save_checkpoint(rnd)

    def advance_and_monitor(self):
        """The background half of a pipelined round: pace, then the
        post-move monitor — the boundary calls of the sequential loop in its
        order, off the main thread. On the card they run on the monitor's
        own stream, and an event recorded there marks the snapshot's upload
        done. Returns ``(snapshot or None, event or None, seconds)``."""
        t0 = time.perf_counter()
        stream = None
        if self.device.type == "cuda":
            if self._monitor_stream is None:
                self._monitor_stream = torch.cuda.Stream(device=self.device)
            stream = self._monitor_stream
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            self.boundary.advance(self.config.sleep_after_action_s)
            out = self.monitor_admitted()
            event = None
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
        return out, event, time.perf_counter() - t0

    def adopt_background(self, state, event):
        return adopt_snapshot(state, event, self.device)

    # ---- the scanned schedule (bench/scan.py) ----

    def scan_static_reason(self) -> str | None:
        """Run-level conditions the scanned schedule can never honor, checked
        once (``config.validate()`` refused the config-level ones). Returns
        the drain reason, or None when blocks may run."""
        from kubernetes_rescheduling_tpu_torch.backends.sim_device import scan_compatible

        if self.on_round is not None:
            # on_round may mutate the backend's load mid-run, which breaks the
            # twin's placement-only monitor
            return "on-round"
        if not scan_compatible(self.boundary.backend):
            # a wrapper, another backend or a noisy load model
            return "backend"
        if self.mgr is not None:
            # the sequential loop checkpoints every round; a block cannot
            return "checkpoint"
        if not self.graph_static:
            return "streaming-graph"
        return None

    def scan_block_rounds(self, start: int, rounds: int) -> int:
        """One scan block: dispatch K rounds on the device, read the block's
        diagnostics in ONE counted ``round_end`` transfer, then replay the
        moves into the backend through the boundary in the sequential call
        order (``begin_round``, ``apply_move``, the ledger's intents,
        ``advance``), with one admitted monitor at the block's end. The
        decoded rounds emit ordinary records, equal to the sequential
        loop's. Returns the rounds consumed: fewer than ``rounds`` when a
        replayed landing diverged from the twin (the round finishes
        degraded) or when the tripwire latched (the replay commits the
        rounds BEFORE the trip, and the report waits in ``scan_trip``)."""
        config = self.config
        graph = self.graph_src()
        scoring = scoring_policy(config.algorithm, config.forecast)
        mech = PlacementMechanism[scoring]
        state0 = self.state
        names = state0.node_names
        ctx = self.round_end_ctx(state0)
        prof = getattr(self.ops, "profiler", None)
        if self.ops is not None:
            # K rounds of healthy silence follow: scale the /healthz
            # staleness budget so a long block never reads as a stale loop
            self.ops.health.mark_block_inflight(rounds)
            if prof is not None:
                # an armed capture covers the whole block (a block is atomic)
                prof.maybe_start(label="scan_block", rounds=rounds, round=start)
        t0 = time.perf_counter()
        with span("controller/scan_block", round=start, rounds=rounds,
                  algorithm=config.algorithm):
            gumbel = None
            if scoring == "random":
                gumbel = to_device(torch.stack([self.noise_rows(start + i)(0)
                                                for i in range(rounds)]), self.device)
            flat_dev = scan_mod.scan_rounds(
                state0, graph, self.metric_graph, POLICY_IDS[scoring],
                config.hazard_threshold_pct, gumbel, self.metric_edges(),
                tripwire_mod.trip_config_array(config, self.device) if self.scan_tripwire else None,
                rounds=rounds, pinned=True, explain_k=self.explain_k, attr_k=self.attr_k,
                tripwire=self.scan_tripwire,
            )
            flat = scan_mod.pull_block(flat_dev, self.registry)
        fence_s = time.perf_counter() - t0
        if prof is not None:
            prof.advance(rounds)
        scan_mod.count_scan_block(self.registry, rounds)
        self.scan_trip = None
        trip = None
        if self.scan_tripwire:
            flat, trip = tripwire_mod.split_tripwire(flat, rounds=rounds)
        views = scan_mod.decode_block(flat, rounds=rounds, num_nodes=state0.num_nodes,
                                      explain_k=self.explain_k, attr_k=self.attr_k)
        if trip is not None and trip.tripped:
            # the trip round decided on a state the rules judged unhealthy:
            # commit only the rounds before it
            views = views[:trip.trip_round]
            tripwire_mod.count_tripwire(self.registry, trip.rules)
            self.scan_trip = {"round": start + trip.trip_round, "block_start": start,
                              "block_round": trip.trip_round, "rules": list(trip.rules),
                              "mask": trip.trip_mask}
            if self.logger is not None:
                self.logger.warn("scan_tripwire", **self.scan_trip)

        consumed = 0
        for i, v in enumerate(views):
            rnd = start + i
            t_r = time.perf_counter()
            self.boundary.begin_round(rnd)  # CLOSED stays CLOSED
            service_name = graph.names[v.service] if v.victim >= 0 else None
            target_name = names[v.target] if v.target >= 0 else None
            hazard_node = names[v.most] if v.most >= 0 else None
            landed_name: str | None = None
            diverged = False
            # the sequential loop's apply condition: a victim and a target
            attempted = v.victim >= 0 and v.target >= 0
            if attempted:
                landed_name = self.boundary.apply_move(MoveRequest(
                    service=service_name, target_node=target_name,
                    hazard_nodes=tuple(names[j] for j in np.flatnonzero(v.hazard)),
                    mechanism=mech,
                ))
                if self.ledger is not None:
                    self.ledger.record_moves([move_intent(mech, service_name, target_name,
                                                          landed_name)])
                expected = names[v.landed] if v.landed >= 0 else None
                if landed_name != expected:
                    # the backend disagrees with the twin: every later decision
                    # of the block saw a diverged state. Finish this round
                    # degraded, resync on a fresh monitor and hand the rest
                    # back to the per-round path
                    diverged = True
                    count_divergence(self.registry, KIND_UNKNOWN_LANDING)
                    if self.logger is not None:
                        self.logger.warn("scan_twin_divergence", round=rnd,
                                         service=service_name, expected=expected,
                                         landed=landed_name)
            moved = attempted and landed_name is not None
            record = RoundRecord(
                round=rnd,
                moved=moved,
                most_hazard=hazard_node,
                service=service_name if moved else None,
                target=landed_name if moved else None,
                communication_cost=v.cost,
                load_std=v.load_std,
                services_moved=(service_name,) if moved else (),
                decision_latencies_s=(fence_s / rounds,),
                applied_moves=((service_name, landed_name),) if moved else (),
                degraded=diverged,
                phase_s={"scan": fence_s / rounds},
            )
            if v.explain is not None:
                expl = greedy_explanation(
                    v.explain, names, round=rnd, seq=0, policy=config.algorithm,
                    service=service_name, hazard_node=hazard_node,
                    chosen=target_name if v.victim >= 0 else None,
                )
                if attempted:
                    # the apply outcome, as the sequential loop patches it in
                    expl["landed"] = landed_name
                    expl["applied"] = landed_name is not None
                    if landed_name is None:
                        expl["stop"] = "boundary move failed"
                        expl["why"] += " (boundary move failed)"
                record.explanations = (expl,)
                if self.logger is not None:
                    self.logger.info("decision", **expl)
            self.boundary.advance(config.sleep_after_action_s)
            fresh = False
            if i == len(views) - 1 or diverged:
                # the block's end: ONE admitted monitor realigns the
                # controller with the backend and arms the degraded-close
                # fallback for a following drained round
                with span("backend/monitor"):
                    new_state = self.monitor_admitted()
                if new_state is None:
                    record.degraded = True
                else:
                    self.note_fresh_snapshot(new_state)
                    fresh = True
            self._reconcile_round(record, fresh=fresh)
            record.breaker_state = self.breaker.state
            record.boundary_failures = self.boundary.round_failures
            self.apply_round_metrics(rnd, record, v.cost, v.load_std, v.attr_flat, ctx)
            record.wall_s = fence_s / rounds + time.perf_counter() - t_r
            self.emit(record, mode="scanned")
            consumed += 1
            if diverged:
                break
        if self.ops is not None:
            # every block reports: a clean one clears the scan_tripwire rule
            # and the in-flight staleness scaling, a tripped one flips
            # /healthz and dumps a bundle scoped to the partial block
            self.ops.observe_scan_block(rounds=rounds, trip=self.scan_trip)
        return consumed


def _sequential_loop(rt: _Runtime) -> None:
    for rnd in range(rt.start_round, rt.config.max_rounds + 1):
        rt.sequential_round(rnd)


def _pipelined_loop(rt: _Runtime) -> None:
    """The software-pipelined schedule (``config.pipeline``): in a steady
    round the previous round's flush, record and ``on_round`` run while this
    round's decision or solve executes on the device (``pre_fence_hook``),
    and the post-move advance + monitor run on a background thread while
    the main thread writes the previous round's checkpoint. The backend
    sees the sequential call order — apply(r), advance, monitor(r),
    [on_round(r)], apply(r+1), ... — which is why the records equal the
    sequential loop's.

    Rounds that cannot pipeline — churn (the sequential loop re-masks before
    deciding), a streaming decision graph, or a breaker that is not CLOSED —
    drain the pipeline (the pending round finishes) and run sequentially,
    so the skip and degraded accounting stays exact: ``max_rounds ==
    records + skipped``."""
    cfg = rt.config
    depth = cfg.pipeline_depth
    pipeline_depth_gauge(rt.registry).set(depth)
    overlap_gauge = pipeline_overlap_gauge(rt.registry)
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="krt-boundary")
    pend: dict | None = None  # the one round in flight (depth 2)
    mon_future = None

    def finish(p: dict, end_t: float | None = None) -> None:
        if p["closed"]:
            return
        p["closed"] = True
        rec = p["record"]
        bg, blocked = p["bg_s"], p["blocked_s"]
        ratio = max(bg - blocked, 0.0) / bg if bg > 1e-9 else 0.0
        rec.pipeline = {"depth": depth, "overlap_ratio": ratio, "background_s": bg,
                        "blocked_s": blocked}
        overlap_gauge.set(ratio)
        p["closer"].flush()
        # wall: round start to the NEXT round's start when pipelined, so
        # per-round walls sum to the loop's total
        rec.wall_s = (end_t if end_t is not None else time.perf_counter()) - p["t0"]
        rt.emit(rec, mode="pipelined")

    def checkpoint(p: dict) -> None:
        rt.save_checkpoint(p["rnd"], p["state"])

    def settle(p: dict, future) -> None:
        """Join the pending round's advance + monitor and run its close."""
        t_w = time.perf_counter()
        new_state, event, bg_s = future.result()
        p["blocked_s"] = time.perf_counter() - t_w
        p["bg_s"] = bg_s
        p["record"].phase_s["monitor"] = bg_s
        rt.begin_close(p["record"], p["closer"], rt.adopt_background(new_state, event))
        p["state"] = rt.state

    try:
        for rnd in range(rt.start_round, cfg.max_rounds + 1):
            if mon_future is not None:
                # settle the pending round's monitor BEFORE this round's
                # begin_round resets the failure counters
                settle(pend, mon_future)
                mon_future = None
            can_pipeline = (rt.churn is None and rt.graph_static
                            and rt.breaker.state == CLOSED)
            if pend is not None and not can_pipeline:
                finish(pend)
                checkpoint(pend)
                pend = None
            if not can_pipeline:
                rt.sequential_round(rnd)
                continue
            rt.boundary.begin_round(rnd)  # CLOSED stays CLOSED
            t0 = time.perf_counter()
            closer = RoundCloser(rt.registry)
            hook = None
            if pend is not None:
                def hook(prev=pend, end_t=t0):
                    finish(prev, end_t)

            with span("controller/round", round=rnd, algorithm=cfg.algorithm):
                record = rt.execute_round(rnd, closer, pre_fence_hook=hook)
            if pend is not None:
                # a round that never reached its fence still owes the
                # previous round its close
                finish(pend)
            prev_pend = pend
            mon_future = ex.submit(rt.advance_and_monitor)
            if prev_pend is not None:
                # host IO overlapping the background monitor
                checkpoint(prev_pend)
            pend = {"rnd": rnd, "record": record, "closer": closer, "t0": t0,
                    "closed": False, "bg_s": 0.0, "blocked_s": 0.0, "state": rt.state}
        # the tail: the last round's monitor and close
        if mon_future is not None:
            settle(pend, mon_future)
        if pend is not None:
            finish(pend)
            checkpoint(pend)
    finally:
        ex.shutdown(wait=True)


def _scanned_loop(rt: _Runtime) -> None:
    """The scanned schedule (``config.scan_block`` K): steady-state rounds
    advance K at a time through one device block and one counted
    ``round_end`` transfer (``bench/scan.py``), the moves replayed into the
    backend afterwards in the sequential call order. A round the scan
    cannot honor — churn or re-mask debt, a breaker that is not CLOSED, a
    checkpoint manager, an incompatible backend, a streaming decision
    graph, an ``on_round`` hook, or a tail shorter than one block — DRAINS
    to the sequential path, counted in ``scan_drains_total{reason}``; a
    tripped block drains its trip round under ``tripwire``."""
    cfg = rt.config
    k = cfg.scan_block
    static_reason = rt.scan_static_reason()
    rnd = rt.start_round
    while rnd <= cfg.max_rounds:
        reason = static_reason
        if reason is None:
            if (rt.churn is not None or rt.pending_churn or rt.remask_needed
                    or rt.rebind_timeline):
                reason = "churn"
            elif rt.breaker.state != CLOSED:
                reason = "breaker"
            elif cfg.max_rounds - rnd + 1 < k:
                # a partial block would be a new capture per tail length
                reason = "tail"
        if reason is not None:
            scan_mod.count_scan_drain(rt.registry, reason)
            if rt.ops is not None:
                rt.ops.observe_scan_drain(reason)
            rt.sequential_round(rnd)
            rnd += 1
            continue
        rnd += rt.scan_block_rounds(rnd, k)
        if rt.scan_trip is not None:
            # the replay committed the rounds before the trip; the trip round
            # re-runs on the per-round path (the same decision: the same
            # state and noise row), which guarantees progress
            scan_mod.count_scan_drain(rt.registry, "tripwire")
            if rt.ops is not None:
                rt.ops.observe_scan_drain("tripwire")
            rt.scan_trip = None
            rt.sequential_round(rnd)
            rnd += 1


def run_controller(
    backend: Backend,
    config: RescheduleConfig,
    *,
    device: str | torch.device | None = DEFAULT_DEVICE,
    registry: MetricsRegistry | None = None,
    logger: StructuredLogger | None = None,
    checkpoint_dir: str | None = None,
    graph=None,
    on_round: Callable | None = None,
    churn=None,
    gumbel_rows: Callable[[int, int], torch.Tensor] | None = None,
    solver_plans: Callable[[int], list] | None = None,
    forecast_deltas: Callable[[int], torch.Tensor] | None = None,
    ops=None,
) -> ControllerResult:
    """Run ``config.max_rounds`` rounds against a backend on ``device``
    (the card unless the caller passes ``device="cpu"``); the backend's
    snapshots and graph move to that device.

    Every boundary call goes through a :class:`BoundaryClient` (retry +
    circuit breaker). When the breaker opens, moves freeze, the last good
    snapshot is kept, and each frozen round is a COUNTED skip
    (``max_rounds == len(result.rounds) + result.skipped_rounds``).

    Every monitor snapshot passes the admission guard
    (``config.reconcile_admission``): poisoned readings are quarantined to
    last-good values, structurally broken snapshots degrade the round. The
    intent ledger (``config.reconcile_enabled``) diffs each admitted
    snapshot against the controller's recorded moves, classifies and counts
    divergences, and issues up to ``config.repair_budget_per_round``
    corrective moves a round. A clean run is identical to one with both
    planes off; rounds with activity carry a ``reconcile`` block.

    ``registry`` (default: the process registry) receives one metric
    sample set per round: ``rounds_total``, ``services_moved_total``, the
    ``decision_seconds`` and ``wall_round_ms`` histograms, the cost and
    objective gauges, and the ``device_transfers_total`` of the loop's
    host reads.

    ``logger`` records one structured ``round`` event per round; with
    ``config.explain`` on, each decide or solve also records a
    ``DecisionExplanation`` (``record.explanations`` and a ``decision``
    event), its device bundle riding the round-end transfer.

    ``checkpoint_dir`` makes the run resumable: the post-move snapshot and
    the ledger's intent are saved every round (the JAX package's format),
    and a start finds the latest checkpoint, replays the churn stream over
    the completed rounds, restores the simulator's placement
    (``restore_placement``) and skips the completed rounds. Round ``r``'s
    draws depend only on ``(config.seed, r)``, so a resumed run decides as
    the uninterrupted one would.

    Churn: ``churn`` (an ``elastic.engine.ChurnEngine``, or one built from
    ``config.elastic``) applies seeded events between rounds through the
    boundary's passthrough; snapshots stay padded to the shape buckets, and
    a round that churned re-reads the comm graph and re-monitors before it
    decides. The events land on ``RoundRecord.churn`` and on the intent
    ledger, which re-anchors instead of counting them as drift.

    ``config.pipeline`` and ``config.scan_block`` pick the pipelined or the
    scanned schedule (module docstring); the records equal the sequential
    loop's apart from timing fields.

    ``graph`` overrides the backend's declared graph for the decisions (a
    zero-argument callable is re-read every round); the metrics stay on the
    declared graph. ``on_round(record, state)`` runs after each round with
    the post-move snapshot.

    ``gumbel_rows(round, i)`` gives the ``random`` policy's noise row of the
    round's ``i``-th decision and ``solver_plans(round)`` the global or pod
    solver's per-sweep plans, in place of the round's generator (the tests
    feed both from the JAX package's key stream). ``forecast_deltas(round)``
    gives a proactive round's load delta (f32[N]) in place of the forecast
    plane's; the plane still observes the round and fills its record's
    ``forecast`` block (the tests feed the JAX package's deltas).

    ``algorithm="proactive"``: each greedy round first folds the snapshot
    into the forecast plane (``config.forecast``) and decides against the
    predicted state; the step's latency leads ``decision_latencies_s`` and
    the record carries the ``forecast`` block.

    ``config.chaos`` names a ``backends/chaos.py`` profile that wraps the
    backend (seeded ``config.chaos_seed``, counted in ``registry``) before
    the boundary is built: the faults hit every schedule through the
    boundary's retries and breaker, and a scanned run drains every round
    (reason ``"backend"``).

    ``ops`` (a ``telemetry.server.OpsPlane``) attaches the live ops plane:
    it binds the breaker (an open transition dumps a flight-recorder
    bundle), observes every executed and skipped round (``/healthz``, the
    SLO watchdog, the flight recorder's ring, the SLO v2 history plane) and
    every scan block and drain, arms its profiler gate around scan blocks,
    and dumps a ``crash`` bundle for whatever escapes the loop. A logger or
    the plane turns on explanations (``config.explain``) and cost
    attribution (``config.attribution``): each record then carries the
    round's edge / node-pair decomposition of the cost and its move
    provenance (``record.attribution``), the bundle riding the round-end
    transfer, and the round end takes the dense cost form.

    ``config.shadow`` (with a ``backends.replay.ReplayBackend``) runs shadow
    mode: the recommendations land in the backend's shadow ledger, every
    intent is advisory (the ledger adopts the recorded placement), and each
    fresh round's record carries the shadow plane's head-to-head block
    (``record.shadow``), its twin's round end riding the round-end transfer
    in the dense cost form.
    """
    config = config.validate()
    dev = resolve_device(device)
    registry = registry if registry is not None else get_registry()
    rt = _Runtime(backend, config, device=dev, registry=registry, gumbel_rows=gumbel_rows,
                  solver_plans=solver_plans, forecast_deltas=forecast_deltas, logger=logger,
                  checkpoint_dir=checkpoint_dir,
                  graph=graph, on_round=on_round, churn=churn, ops=ops)
    try:
        if config.scan_block:
            _scanned_loop(rt)
        elif config.pipeline:
            _pipelined_loop(rt)
        else:
            _sequential_loop(rt)
    except BaseException as e:
        # whatever escapes the loop leaves a flight-recorder bundle behind
        if ops is not None:
            ops.on_crash(e)
        raise
    rt.result.breaker_transitions = list(rt.breaker.transitions)
    rt.result.boundary_failures = rt.boundary.total_failures
    return rt.result


def _greedy_round(boundary, state, graph, config, rnd, *, noise, registry, closer,
                  logger=None, explain_k: int = 0, forecast_delta=None, intents=None,
                  pre_fence_hook=None) -> RoundRecord:
    """Up to ``config.moves_per_round`` greedy moves: after each move the
    working snapshot re-homes the moved service (reference main.py:73's
    ``edit_cluster`` intent, done correctly), so the next decision sees the
    drained hazard node and stops once nothing is hazardous any more.
    ``noise(i)`` is the ``random`` policy's noise row of the ``i``-th
    decision.

    With ``explain_k > 0`` each decide is :func:`decide_explain` (the same
    decision) and its bundle rides the round's single round-end transfer;
    the ``DecisionExplanation`` is built at flush, with the apply outcome
    recorded during the round.

    ``forecast_delta`` (proactive rounds) routes every decide through the
    forecast-aware decisions: the base policy scored against the predicted
    next-window state. A zero delta decides as the reactive round.

    ``pre_fence_hook`` (the pipelined schedule) runs once, after the first
    decision is queued on the device and before its fence."""
    scoring = scoring_policy(config.algorithm, config.forecast)
    pid = POLICY_IDS[scoring]
    mechanism = PlacementMechanism[scoring]
    node_index = {name: i for i, name in enumerate(state.node_names)}
    first_hazard: str | None = None
    moved_names: list[str] = []
    applied_moves: list[tuple[str, str]] = []
    latencies: list[float] = []
    explanations: list[dict] = []
    apply_s = 0.0
    degraded = False

    def defer_explanation(bundle, meta) -> None:
        def decode(flat) -> None:
            expl = greedy_explanation(
                flat, meta["node_names"], round=rnd, seq=meta["seq"], policy=config.algorithm,
                service=meta["service"], hazard_node=meta["hazard_node"], chosen=meta["chosen"],
            )
            if meta.get("applied_known"):
                expl["landed"] = meta["landed"]
                expl["applied"] = meta["landed"] is not None
            stop = meta.get("stop")
            if stop is not None:
                expl["stop"] = stop
                expl["why"] += f" ({stop})"
            explanations.append(expl)
            if logger is not None:
                logger.info("decision", **expl)

        closer.defer(bundle, decode)

    for i in range(config.moves_per_round):
        t0 = time.perf_counter()
        with span("controller/decide", round=rnd):
            g = noise(i) if scoring == "random" else None
            thr = config.hazard_threshold_pct
            if explain_k > 0:
                if forecast_delta is not None:
                    most, hazard_mask, victim, svc, target, bundle = decide_explain_with_forecast(
                        state, graph, pid, thr, g, forecast_delta, top_k=explain_k)
                else:
                    most, hazard_mask, victim, svc, target, bundle = decide_explain(
                        state, graph, pid, thr, g, top_k=explain_k)
            else:
                bundle = None
                if forecast_delta is not None:
                    most, hazard_mask, victim, svc, target = decide_with_forecast(
                        state, graph, pid, thr, g, forecast_delta)
                else:
                    most, hazard_mask, victim, svc, target = decide(state, graph, pid, thr, g)
            # the apply boundary: ONE batched host read of the decision
            scalars, hazard = fence([torch.stack([most, victim, svc.long(), target]), hazard_mask],
                                    registry)
        latencies.append(time.perf_counter() - t0)
        most_i, victim_i, svc_i, target_i = (int(v) for v in scalars)
        service_name = graph.names[svc_i] if victim_i >= 0 else None
        target_name = state.node_names[target_i] if target_i >= 0 else None
        meta = None
        if bundle is not None:
            meta = {
                "node_names": state.node_names,
                "seq": i,
                "service": service_name,
                "hazard_node": state.node_names[most_i] if most_i >= 0 else None,
                "chosen": target_name if victim_i >= 0 else None,
            }
            defer_explanation(bundle, meta)
        if first_hazard is None and most_i >= 0:
            first_hazard = state.node_names[most_i]
        if most_i < 0 or victim_i < 0 or target_i < 0:
            break  # no hazard left (or nowhere to go): the round is done
        if service_name in moved_names:
            # the drain started ping-ponging (the move made the target the
            # new hazard node and elected the same service back)
            if meta is not None:
                meta["stop"] = "ping-pong stop: service already moved this round"
            break
        t_apply = time.perf_counter()
        landed = boundary.apply_move(
            MoveRequest(
                service=service_name,
                target_node=target_name,
                hazard_nodes=tuple(n for n, h in zip(state.node_names, hazard) if h),
                mechanism=mechanism,
            )
        )
        apply_s += time.perf_counter() - t_apply
        if intents is not None:
            intents.append(move_intent(mechanism, service_name, target_name, landed))
        if meta is not None:
            meta["applied_known"] = True
            meta["landed"] = landed
            if landed is None:
                meta["stop"] = "boundary move failed"
        if landed is None:
            break
        moved_names.append(service_name)
        applied_moves.append((service_name, landed))
        if landed not in node_index:
            # landed on a node the working snapshot does not know: count
            # the divergence, stop, and close the round degraded; the next
            # monitor realigns and the reconcile plane repairs the pod
            count_divergence(registry, KIND_UNKNOWN_LANDING)
            degraded = True
            if meta is not None:
                meta["stop"] = "landed on a node unknown to the snapshot"
            if logger is not None:
                logger.warn("unknown_landing", round=rnd, service=service_name, landed=landed)
            break
        if i + 1 < config.moves_per_round:
            # re-home the moved service where it actually LANDED (the
            # scheduler may override the target under affinityOnly)
            svc_pods = (state.pod_service == svc_i) & state.pod_valid
            state = state.replace(
                pod_node=torch.where(svc_pods, node_index[landed], state.pod_node)
                .to(state.pod_node.dtype)
            )
    record = RoundRecord(
        round=rnd,
        moved=bool(moved_names),
        most_hazard=first_hazard,
        service=moved_names[0] if moved_names else None,
        target=applied_moves[0][1] if applied_moves else None,
        communication_cost=0.0,  # filled at the round-end flush
        load_std=0.0,
        services_moved=tuple(moved_names),
        decision_latencies_s=tuple(latencies),
        applied_moves=tuple(applied_moves),
        degraded=degraded,
        phase_s={"decide": sum(latencies), "apply": apply_s},
    )
    if explain_k > 0:
        # the decodes above fill `explanations` at flush; land them on the
        # record after the last one ran
        closer.defer_host(lambda: setattr(record, "explanations", tuple(explanations)))
    return record


# ---- the wave cap: host-side move scoring with the solver's accounting ----


def _move_scoring_env(state, graph, solver_cfg, services=None, *, placement=None,
                      registry=None):
    """Host-side scoring context over one snapshot, shared by the wave cap
    (:func:`_top_gain_moves`) and the global explanation's per-move gains.

    The device inputs come home in ONE counted transfer
    (``site="move_gains"``): pod loads, node capacities, validity and used
    loads, and only the adjacency rows of ``services`` (every service when
    None) — the gains read no other row. ``placement`` is the host
    ``(pod_node, pod_valid, pod_service)`` a round already fenced; without
    it they ride the same transfer. The arrays keep the JAX package's
    host dtypes (f32 loads and capacities, f64 per-service sums, i64
    replica counts), which decide its ties and its 1e-9 threshold."""
    S = graph.num_services
    rows = sorted(set(int(s) for s in services)) if services is not None else list(range(S))
    parts = {
        "pod_cpu": state.pod_cpu,
        "pod_mem": state.pod_mem,
        "node_cpu_cap": state.node_cpu_cap,
        "node_mem_cap": state.node_mem_cap,
        "node_valid": state.node_valid,
        "used": state.node_cpu_used(),
        "mem_used": state.node_mem_used(),
        "adj": graph.adj.index_select(0, torch.as_tensor(rows, dtype=torch.long,
                                                         device=graph.adj.device)),
    }
    if placement is None:
        parts.update(pod_node=state.pod_node, pod_valid=state.pod_valid,
                     pod_service=state.pod_service)
    host = pull_arrays(parts, MOVE_GAINS_SITE, registry)
    old_nodes, valid, svc_arr = placement if placement is not None else (
        host["pod_node"], host["pod_valid"], host["pod_service"])
    pod_cpu, pod_mem = host["pod_cpu"], host["pod_mem"]
    svc_node = np.full(S, -1, dtype=np.int64)
    svc_cpu = np.zeros(S)
    svc_mem = np.zeros(S)
    for i in np.flatnonzero(valid):
        s = int(svc_arr[i])
        if 0 <= s < S:
            if svc_node[s] < 0:
                svc_node[s] = old_nodes[i]
            svc_cpu[s] += float(pod_cpu[i])
            svc_mem[s] += float(pod_mem[i])
    replicas = np.bincount(svc_arr[valid & (svc_arr >= 0) & (svc_arr < S)], minlength=S)
    placed = svc_node >= 0

    node_valid = host["node_valid"]
    ow = solver_cfg.overload_weight if solver_cfg.enforce_capacity else 0.0
    cpu_cap = host["node_cpu_cap"]
    cap = np.where(cpu_cap > 0, cpu_cap, 1.0) * solver_cfg.capacity_frac
    mem_cap_raw = host["node_mem_cap"]
    mem_cap = np.where(mem_cap_raw > 0, mem_cap_raw, np.inf) * solver_cfg.capacity_frac

    def balance_terms(loads):
        # the solver's own expression, evaluated host-side
        return float(pct_balance_terms(loads, cap, node_valid, solver_cfg.balance_weight, ow,
                                       xp=np))

    return SimpleNamespace(
        svc_node=svc_node, svc_cpu=svc_cpu, svc_mem=svc_mem,
        replicas=replicas, adj=dict(zip(rows, host["adj"])), placed=placed,
        cap=cap, mem_cap=mem_cap, used=host["used"], mem_used=host["mem_used"],
        enforce_capacity=solver_cfg.enforce_capacity,
        balance_terms=balance_terms,
    )


def _move_gain(env, work_node, loads, mem_loads, bal_now, s, t):
    """(gain, feasible) of relocating service ``s`` to ``t`` at the given
    working state: the solver's own accounting (comm cut + balance terms,
    capacity feasibility when enforced)."""
    w = env.adj[s] * env.replicas[s] * env.replicas
    cut_before = float(np.sum(w[env.placed & (work_node != work_node[s])]))
    cut_after = float(np.sum(w[env.placed & (work_node != t)]))
    new_loads = loads.copy()
    if 0 <= work_node[s] < len(new_loads):
        new_loads[work_node[s]] -= env.svc_cpu[s]
    new_loads[t] += env.svc_cpu[s]
    feasible = not (
        env.enforce_capacity
        and t != work_node[s]
        and (new_loads[t] > env.cap[t] or mem_loads[t] + env.svc_mem[s] > env.mem_cap[t])
    )
    gain = cut_before - cut_after + bal_now - env.balance_terms(new_loads)
    return gain, feasible


def _individual_move_gains(changed: list[tuple[int, int]], state=None, graph=None,
                           solver_cfg=None, *, env=None) -> list[tuple[int, int, float]]:
    """Each candidate move's INDIVIDUAL gain at the round-start state
    (every other service held in place): what the uncapped global round's
    explanation records as candidate scores."""
    if env is None:
        env = _move_scoring_env(state, graph, solver_cfg, [s for s, _ in changed])
    work_node = env.svc_node.copy()
    loads = env.used.copy()
    mem_loads = env.mem_used.copy()
    bal_now = env.balance_terms(loads)
    return [
        (s, t, _move_gain(env, work_node, loads, mem_loads, bal_now, s, t)[0])
        for s, t in changed
    ]


def _top_gain_moves(changed: list[tuple[int, int]], state=None, graph=None, solver_cfg=None,
                    k: int = 0, *, env=None) -> list[tuple[int, int, float]]:
    """≤ ``k`` strictly improving moves selected greedily and sequentially
    with the solver's own accounting (comm + λ·std of CPU-% of the packing
    budget + the over-budget term when capacity is enforced).

    Each accepted move updates the working placement and loads, and every
    remaining candidate is re-scored against them, so the wave is jointly
    consistent: two moves cannot together over-budget one node, and a move
    that only pays off once an earlier one vacates its target is scored
    with that vacancy. A candidate whose gain is ≤ 1e-9 is never taken
    (the capped loop converges when no single move helps); ties go to the
    earliest candidate. Returns ``(service, target, gain)`` triples in
    ``changed``'s order, each gain at its evaluation state."""
    if env is None:
        env = _move_scoring_env(state, graph, solver_cfg, [s for s, _ in changed])
    work_node = env.svc_node.copy()
    loads = env.used.copy()
    mem_loads = env.mem_used.copy()
    picked: list[int] = []
    gains: dict[int, float] = {}
    remaining = list(range(len(changed)))
    for _ in range(min(k, len(changed))):
        bal_now = env.balance_terms(loads)
        best_i, best_gain = None, 1e-9
        for i in remaining:
            s, t = changed[i]
            gain, feasible = _move_gain(env, work_node, loads, mem_loads, bal_now, s, t)
            if not feasible:
                continue  # would newly exceed a budget at the CURRENT loads
            if gain > best_gain:  # strict: ties go to the earliest candidate
                best_i, best_gain = i, gain
        if best_i is None:
            break  # no remaining move helps on its own: the wave converged
        s, t = changed[best_i]
        if 0 <= work_node[s] < len(loads):
            loads[work_node[s]] -= env.svc_cpu[s]
            mem_loads[work_node[s]] -= env.svc_mem[s]
        loads[t] += env.svc_cpu[s]
        mem_loads[t] += env.svc_mem[s]
        work_node[s] = t
        picked.append(best_i)
        gains[best_i] = best_gain
        remaining.remove(best_i)
    return [(*changed[i], gains[i]) for i in sorted(picked)]


def _defer_solver_objectives(closer: RoundCloser, info: dict, apply_cb) -> None:
    """Defer the solver's before/after accounting onto the round closer, so
    it rides the round's single transfer. ``apply_cb(before, after,
    improved)`` runs at flush."""
    def decode(flat) -> None:
        apply_cb(float(flat[0]), float(flat[1]), bool(flat[2]))

    closer.defer(torch.stack([info[k].float() for k in
                              ("objective_before", "objective_after", "improved")]), decode)


def _solver_config(config: RescheduleConfig) -> GlobalSolverConfig:
    return GlobalSolverConfig(
        sweeps=config.global_solver_iters,
        balance_weight=config.balance_weight,
        enforce_capacity=config.enforce_capacity,
        capacity_frac=config.capacity_frac,
        move_cost=config.move_cost,
    )


def _pod_round(boundary, state, graph, config, rnd, *, generator, plan, closer, registry,
               logger=None, explain=False, intents=None, pre_fence_hook=None) -> RoundRecord:
    """Per-replica global round: one solve on the pod-level graph, then the
    moved pods in one ``apply_pod_moves`` wave (the simulator's), or one
    ``apply_move`` each through the boundary for a backend without it. The
    pod graph is cached per (declared graph, pod set)."""
    from kubernetes_rescheduling_tpu_torch.solver.pod_mode import (
        global_assign_pods,
        pod_level_graph,
    )

    t0 = time.perf_counter()
    # the pod set keys the pod-graph cache, so it is read before the solve
    old_nodes, valid, svc_arr = fence([state.pod_node, state.pod_valid, state.pod_service],
                                      registry)
    sig = (svc_arr.tobytes(), valid.tobytes())
    cache = boundary.solver_cache("pod_graph")
    if cache.get("graph") is not graph or cache.get("sig") != sig:
        # build BEFORE keying: a failed build must not leave a matching
        # key over a stale value
        value = pod_level_graph(state, graph)
        cache["graph"], cache["sig"], cache["value"] = graph, sig, value
    pod_graph = cache["value"]
    with span("controller/pod_solve", round=rnd):
        new_state, info = global_assign_pods(state, graph, generator, _solver_config(config),
                                             pod_graph=pod_graph, plan=plan)
        if pre_fence_hook is not None:
            # the pipelined overlap window, while the solve executes
            pre_fence_hook()
        # the apply boundary: ONE batched host read of the new placement
        (new_nodes,) = fence([new_state.pod_node], registry)
    latency = time.perf_counter() - t0

    t_apply = time.perf_counter()
    mechanism = PlacementMechanism["global"]
    moves = [
        MoveRequest(
            service=graph.names[int(svc_arr[i])],
            pod=state.pod_names[int(i)],
            target_node=state.node_names[int(new_nodes[i])],
            mechanism=mechanism,
        )
        for i in np.flatnonzero(valid & (old_nodes != new_nodes))
    ]
    batch = getattr(boundary, "apply_pod_moves", None)
    if batch is not None:
        # one reconcile wave for the whole round's replica moves, past the
        # retry wrapper (the simulator's wave cannot transiently fail)
        landed_of = dict(batch(moves)) if moves else {}
    else:
        # a backend without the wave: one retried boundary move a replica
        landed_of = {}
        for mv in moves:
            landed = boundary.apply_move(mv)
            if landed is not None:
                landed_of[mv.pod] = landed
    landed_moves = [mv for mv in moves if mv.pod in landed_of]
    applied_moves = [(mv.service, landed_of[mv.pod]) for mv in landed_moves]  # LANDED node
    if intents is not None:
        intents.extend(move_intent(mv.mechanism, mv.service, mv.target_node,
                                   landed_of.get(mv.pod), pod=mv.pod) for mv in moves)
    moved_services = {mv.service for mv in landed_moves}

    # services_moved carries the SERVICE names of moves that landed
    record = RoundRecord(
        round=rnd,
        moved=bool(moved_services),
        most_hazard=None,
        service=None,
        target=None,
        communication_cost=0.0,  # filled at the round-end flush
        load_std=0.0,
        services_moved=tuple(sorted(moved_services)),
        decision_latencies_s=(latency,),
        applied_moves=tuple(applied_moves),
        phase_s={"solve": latency, "apply": time.perf_counter() - t_apply},
    )

    def apply_objectives(before, after, improved) -> None:
        record.objective_before = before
        record.objective_after = after
        record.solver_improved = improved
        if not explain:
            return
        # per-service candidates scored by replicas relocated; chosen = the
        # most-relocated service
        per_svc: dict[str, dict] = {}
        for mv in landed_moves:
            d = per_svc.setdefault(mv.service, {"service": mv.service, "node": mv.target_node,
                                                "node_index": None, "score": 0.0,
                                                "applied": True})
            d["score"] += 1.0
        expl = solver_explanation(
            kind="pod", round=rnd, policy=config.algorithm,
            candidates=sorted(per_svc.values(), key=lambda d: d["service"]),
            objective_before=before, objective_after=after,
            applied=len(landed_moves), proposed=len(moves),
        )
        if logger is not None:
            logger.info("decision", **expl)
        record.explanations = (expl,)

    _defer_solver_objectives(closer, info, apply_objectives)
    return record


def _global_round(boundary, state, graph, config, rnd, *, generator, plan, closer,
                  registry, logger=None, explain=False, intents=None,
                  pre_fence_hook=None) -> RoundRecord:
    """One batched solve (one restart, tp 1), then every service whose node
    changed is moved — or, with a numeric ``global_moves_cap``, the wave
    cap's selection. ``placement_unit="pod"`` takes :func:`_pod_round`. The
    JAX package can donate the snapshot's buffers to the solve and
    resurrect them afterwards; torch has nothing to donate, so that path
    does not exist here."""
    if config.placement_unit == "pod":
        return _pod_round(boundary, state, graph, config, rnd, generator=generator, plan=plan,
                          closer=closer, registry=registry, logger=logger, explain=explain,
                          intents=intents, pre_fence_hook=pre_fence_hook)
    cfg = _solver_config(config)
    t0 = time.perf_counter()
    with span("controller/global_solve", round=rnd):
        if config.solver_backend == "sparse":
            from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
            from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import global_assign_sparse

            # the block-local form is built once per graph: the controller
            # re-solves the same declared graph every round
            cache = boundary.solver_cache("sparse_graph")
            if cache.get("graph") is not graph:
                cache["graph"], cache["value"] = graph, from_comm_graph(graph)
            new_state, info = global_assign_sparse(state, cache["value"], generator, cfg, plan=plan)
        else:
            new_state, info = global_assign(state, graph, generator, cfg, plan=plan)
        if pre_fence_hook is not None:
            # the pipelined overlap window, while the solve executes
            pre_fence_hook()
        # the apply boundary: ONE batched host read of the old and new placement
        old_nodes, new_nodes, valid, svc_arr = fence(
            [state.pod_node, new_state.pod_node, state.pod_valid, state.pod_service], registry
        )
    latency = time.perf_counter() - t0

    changed: list[tuple[int, int]] = []  # (service, target node), first pod order
    seen: set[int] = set()
    for i in np.flatnonzero(valid & (old_nodes != new_nodes)):
        s = int(svc_arr[i])
        if s not in seen:
            seen.add(s)
            changed.append((s, int(new_nodes[i])))

    proposed = len(changed)
    cap = config.global_moves_cap
    gains: dict[tuple[int, int], float] = {}
    phase_s = {"solve": latency}
    if isinstance(cap, int) or (explain and changed):
        t_sel = time.perf_counter()
        env = _move_scoring_env(state, graph, cfg, [s for s, _ in changed],
                                placement=(old_nodes, valid, svc_arr), registry=registry)
        if isinstance(cap, int):
            # the wave cap: only the k best strictly improving moves; the
            # rest of the solve is re-derived next round
            scored = _top_gain_moves(changed, k=cap, env=env)
            changed = [(s, t) for s, t, _ in scored]
        else:
            # uncapped rounds score the moves once, for the explanation
            scored = _individual_move_gains(changed, env=env)
        gains = {(s, t): g for s, t, g in scored}
        phase_s["select"] = time.perf_counter() - t_sel

    t_apply = time.perf_counter()
    mechanism = PlacementMechanism["global"]
    moved_names: list[str] = []
    applied_moves: list[tuple[str, str]] = []
    for s, target in changed:
        landed = boundary.apply_move(
            MoveRequest(service=graph.names[s], target_node=state.node_names[target],
                        mechanism=mechanism)
        )
        if intents is not None:
            intents.append(move_intent(mechanism, graph.names[s], state.node_names[target],
                                       landed))
        if landed is not None:
            moved_names.append(graph.names[s])
            applied_moves.append((graph.names[s], landed))
    phase_s["apply"] = time.perf_counter() - t_apply
    record = RoundRecord(
        round=rnd,
        moved=bool(moved_names),
        most_hazard=None,
        service=None,
        target=None,
        communication_cost=0.0,  # filled at the round-end flush
        load_std=0.0,
        services_moved=tuple(moved_names),
        decision_latencies_s=(latency,),
        applied_moves=tuple(applied_moves),
        phase_s=phase_s,
    )

    def apply_objectives(before, after, improved) -> None:
        record.objective_before = before
        record.objective_after = after
        record.solver_improved = improved
        if not explain:
            return
        moved = set(moved_names)
        candidates = [
            {
                "service": graph.names[s],
                "node": state.node_names[t],
                "node_index": int(t),
                "score": float(gains.get((s, t), 0.0)),
                "applied": graph.names[s] in moved,
            }
            for s, t in changed
        ]
        expl = solver_explanation(
            kind="global", round=rnd, policy=config.algorithm, candidates=candidates,
            objective_before=before, objective_after=after,
            applied=len(moved_names), proposed=proposed,
        )
        if logger is not None:
            logger.info("decision", **expl)
        record.explanations = (expl,)

    _defer_solver_objectives(closer, info, apply_objectives)
    return record
