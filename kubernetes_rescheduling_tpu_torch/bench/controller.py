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
changed is moved.

Host reads per executed round: one batched :func:`~bench.round_end.fence`
per decision or solve, and one :meth:`~bench.round_end.RoundCloser.flush`
that carries the round's closing metrics and the solver's objectives.

Randomness: round ``r`` draws from the generator of ``(config.seed, r)``
(``_random.round_generator``), so a round's decisions do not depend on
the rounds before it. Two keyword arguments of :func:`run_controller`,
used by the tests, supply the draws instead: ``gumbel_rows`` (the
``random`` policy's noise row of each decision) and ``solver_plans`` (the
global solver's per-sweep plans of each round).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch._random import gumbel as draw_gumbel
from kubernetes_rescheduling_tpu_torch._random import round_generator
from kubernetes_rescheduling_tpu_torch.backends.base import Backend, MoveRequest, PlacementMechanism
from kubernetes_rescheduling_tpu_torch.bench.boundary import (
    HALF_OPEN,
    OPEN,
    BoundaryClient,
    CircuitBreaker,
)
from kubernetes_rescheduling_tpu_torch.bench.round_end import (
    METRIC_COST,
    METRIC_LOAD_STD,
    RoundCloser,
    dispatch_round_end,
    fence,
)
from kubernetes_rescheduling_tpu_torch.config import RescheduleConfig
from kubernetes_rescheduling_tpu_torch.objectives.metrics import comm_edge_list
from kubernetes_rescheduling_tpu_torch.policies.proactive import scoring_policy
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig, global_assign
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry


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
    # every move that LANDED this round as (service, landed_node) pairs
    applied_moves: tuple[tuple[str, str], ...] = ()
    # timing fields: execute start to record finalize, and wall seconds of
    # the round's phases ("decide" or "solve", "apply", "monitor",
    # "round_end")
    wall_s: float = 0.0
    phase_s: dict[str, float] = field(default_factory=dict)

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


def observe_wall_round(registry: MetricsRegistry, mode: str, wall_s: float) -> None:
    registry.histogram(
        "wall_round_ms",
        "wall-clock lifecycle of one executed controller round "
        "(execute start to record finalize), by schedule",
        labelnames=("mode",),
        buckets=_WALL_MS_BUCKETS,
    ).labels(mode=mode).observe(wall_s * 1e3)


class _Runtime:
    """The loop's machinery: boundary, breaker, the round-end protocol and
    the per-round helpers of the sequential schedule."""

    def __init__(self, backend, config: RescheduleConfig, *, device, registry,
                 gumbel_rows, solver_plans):
        self.config = config
        self.registry = registry
        self.device = device
        self.gumbel_rows = gumbel_rows
        self.solver_plans = solver_plans
        self.breaker = CircuitBreaker(
            max_consecutive_failures=config.max_consecutive_failures,
            cooldown_rounds=config.breaker_cooldown_rounds,
            registry=registry,
        )
        self.boundary = BoundaryClient(
            backend,
            policy=config.retry,
            breaker=self.breaker,
            failure_budget_per_round=config.failure_budget_per_round,
            registry=registry,
        )
        self.graph = self.boundary.comm_graph().to(device)
        self._edges = comm_edge_list(self.graph)
        self.result = ControllerResult()
        # one snapshot per round: the post-move snapshot gives this round's
        # metrics AND the next round's state. Startup has no last good
        # snapshot to fall back on, so the first monitor gets a bounded
        # probe loop on top of the per-call retries
        self.state = None
        self._pending_end: dict | None = None
        for _ in range(max(3, config.max_consecutive_failures + 1)):
            probe = self.monitor()
            if probe is not None:
                self.note_fresh_snapshot(probe)
                break
        if self.state is None:
            raise ConnectionError(
                "backend unavailable: initial monitor() failed after retries "
                "(no last good snapshot to degrade to)"
            )

    def monitor(self):
        """A boundary monitor, on the controller's device."""
        out = self.boundary.monitor()
        return out.to(self.device) if out is not None else None

    # ---- round-end protocol ----

    def note_fresh_snapshot(self, state) -> None:
        """Adopt a fresh snapshot and queue its round-end metrics on the
        device; they are read only when a record closes on them."""
        self.state = state
        self._pending_end = {"dev": dispatch_round_end(state, self.graph, edges=self._edges)}

    def _attach_metrics(self, record: RoundRecord, closer: RoundCloser) -> None:
        """Register the record's closing metrics on the closer: the pending
        snapshot's tensor, or — when a degraded round closes on a snapshot
        already read — its cached host values (no transfer)."""
        pend = self._pending_end
        if "host" in pend:
            cost, lstd = pend["host"]

            def apply_cached() -> None:
                record.communication_cost, record.load_std = cost, lstd

            closer.defer_host(apply_cached)
            return
        dev = pend.pop("dev")

        def decode(flat) -> None:
            pend["host"] = (float(flat[METRIC_COST]), float(flat[METRIC_LOAD_STD]))
            record.communication_cost, record.load_std = pend["host"]

        closer.defer(dev, decode)

    def begin_close(self, record: RoundRecord, closer: RoundCloser, new_state) -> None:
        if new_state is None:
            # the post-move snapshot failed: finish DEGRADED on the last
            # good snapshot instead of crashing
            record.degraded = True
        else:
            self.note_fresh_snapshot(new_state)
        record.breaker_state = self.breaker.state
        record.boundary_failures = self.boundary.round_failures
        self._attach_metrics(record, closer)

    # ---- per-round helpers ----

    def skip_round(self) -> None:
        """Safe mode: the open breaker froze this round — count it, pace."""
        self.result.skipped_rounds += 1
        self.registry.counter(
            "rounds_skipped_total", "rounds frozen by the open circuit breaker",
            labelnames=("algorithm",),
        ).labels(algorithm=self.config.algorithm).inc()
        self.boundary.advance(self.config.sleep_after_action_s)

    def preamble(self, rnd: int) -> bool:
        """The breaker gate and the half-open probe. Returns False when the
        round was a counted skip."""
        mode = self.boundary.begin_round(rnd)
        if mode == OPEN:
            self.skip_round()
            return False
        if mode == HALF_OPEN:
            # one probe before trusting the backend with a full round; a
            # success closes the breaker and refreshes the stale snapshot
            probe = self.monitor()
            if probe is None:
                self.skip_round()
                return False
            self.note_fresh_snapshot(probe)
        return True

    def execute_round(self, rnd: int, closer: RoundCloser) -> RoundRecord:
        """Decide and apply one round's moves (no advance or monitor)."""
        config = self.config
        if config.algorithm == "global" or config.moves_per_round == "all":
            return _global_round(
                self.boundary, self.state, self.graph, config, rnd,
                generator=round_generator(config.seed, rnd),
                plan=self.solver_plans(rnd) if self.solver_plans is not None else None,
                closer=closer, registry=self.registry,
            )
        if self.gumbel_rows is not None:
            def noise(i: int) -> torch.Tensor:
                return self.gumbel_rows(rnd, i).to(self.device)
        else:
            gen = round_generator(config.seed, rnd)

            def noise(i: int) -> torch.Tensor:
                return draw_gumbel((self.state.num_nodes,), gen, "cpu").to(self.device)

        return _greedy_round(self.boundary, self.state, self.graph, config, rnd,
                             noise=noise, registry=self.registry)

    def emit(self, record: RoundRecord) -> None:
        """The record's host tail: the result and the round's metrics."""
        self.result.rounds.append(record)
        _emit_round_metrics(self.registry, self.config.algorithm, record)
        observe_wall_round(self.registry, "sequential", record.wall_s)
        if record.degraded:
            self.registry.counter(
                "degraded_rounds_total",
                "rounds completed on a stale snapshot after boundary failure",
                labelnames=("algorithm",),
            ).labels(algorithm=self.config.algorithm).inc()

    def sequential_round(self, rnd: int) -> None:
        """One full round: preamble, execute, advance + monitor, close,
        flush, emit."""
        if not self.preamble(rnd):
            return
        t0 = time.perf_counter()
        closer = RoundCloser(self.registry)
        record = self.execute_round(rnd, closer)
        self.boundary.advance(self.config.sleep_after_action_s)
        t_mon = time.perf_counter()
        new_state = self.monitor()
        t_end = time.perf_counter()
        self.begin_close(record, closer, new_state)
        closer.flush()
        t_done = time.perf_counter()
        record.phase_s["monitor"] = t_end - t_mon
        record.phase_s["round_end"] = t_done - t_end
        record.wall_s = t_done - t0
        self.emit(record)


def run_controller(
    backend: Backend,
    config: RescheduleConfig,
    *,
    device: str | torch.device | None = DEFAULT_DEVICE,
    registry: MetricsRegistry | None = None,
    gumbel_rows: Callable[[int, int], torch.Tensor] | None = None,
    solver_plans: Callable[[int], list] | None = None,
) -> ControllerResult:
    """Run ``config.max_rounds`` rounds against a backend on ``device``
    (the card unless the caller passes ``device="cpu"``); the backend's
    snapshots and graph move to that device.

    Every boundary call goes through a :class:`BoundaryClient` (retry +
    circuit breaker). When the breaker opens, moves freeze, the last good
    snapshot is kept, and each frozen round is a COUNTED skip
    (``max_rounds == len(result.rounds) + result.skipped_rounds``).

    ``registry`` (default: the process registry) receives one metric
    sample set per round: ``rounds_total``, ``services_moved_total``, the
    ``decision_seconds`` and ``wall_round_ms`` histograms, the cost and
    objective gauges, and the ``device_transfers_total`` of the loop's
    host reads.

    ``gumbel_rows(round, i)`` gives the ``random`` policy's noise row of the
    round's ``i``-th decision and ``solver_plans(round)`` the global
    solver's per-sweep plans, in place of the round's generator (the tests
    feed both from the JAX package's key stream).

    Not carried yet (refused by ``config.validate()``): the pipelined and
    scanned schedules, checkpoints, the logger and ops plane, explanations,
    reconcile and admission, churn, forecast and chaos.
    """
    config = config.validate()
    dev = resolve_device(device)
    registry = registry if registry is not None else get_registry()
    rt = _Runtime(backend, config, device=dev, registry=registry,
                  gumbel_rows=gumbel_rows, solver_plans=solver_plans)
    for rnd in range(1, config.max_rounds + 1):
        rt.sequential_round(rnd)
    rt.result.breaker_transitions = list(rt.breaker.transitions)
    rt.result.boundary_failures = rt.boundary.total_failures
    return rt.result


def _greedy_round(boundary, state, graph, config, rnd, *, noise, registry) -> RoundRecord:
    """Up to ``config.moves_per_round`` greedy moves: after each move the
    working snapshot re-homes the moved service (reference main.py:73's
    ``edit_cluster`` intent, done correctly), so the next decision sees the
    drained hazard node and stops once nothing is hazardous any more.
    ``noise(i)`` is the ``random`` policy's noise row of the ``i``-th
    decision."""
    scoring = scoring_policy(config.algorithm)
    pid = POLICY_IDS[scoring]
    mechanism = PlacementMechanism[scoring]
    node_index = {name: i for i, name in enumerate(state.node_names)}
    first_hazard: str | None = None
    moved_names: list[str] = []
    applied_moves: list[tuple[str, str]] = []
    latencies: list[float] = []
    apply_s = 0.0
    degraded = False
    for i in range(config.moves_per_round):
        t0 = time.perf_counter()
        g = noise(i) if scoring == "random" else None
        most, hazard_mask, victim, svc, target = decide(
            state, graph, pid, config.hazard_threshold_pct, g
        )
        # the apply boundary: ONE batched host read of the decision
        scalars, hazard = fence([torch.stack([most, victim, svc.long(), target]), hazard_mask],
                                registry)
        latencies.append(time.perf_counter() - t0)
        most_i, victim_i, svc_i, target_i = (int(v) for v in scalars)
        if first_hazard is None and most_i >= 0:
            first_hazard = state.node_names[most_i]
        if most_i < 0 or victim_i < 0 or target_i < 0:
            break  # no hazard left (or nowhere to go): the round is done
        service_name = graph.names[svc_i]
        if service_name in moved_names:
            # the drain started ping-ponging (the move made the target the
            # new hazard node and elected the same service back)
            break
        t_apply = time.perf_counter()
        landed = boundary.apply_move(
            MoveRequest(
                service=service_name,
                target_node=state.node_names[target_i],
                hazard_nodes=tuple(n for n, h in zip(state.node_names, hazard) if h),
                mechanism=mechanism,
            )
        )
        apply_s += time.perf_counter() - t_apply
        if landed is None:
            break
        moved_names.append(service_name)
        applied_moves.append((service_name, landed))
        if landed not in node_index:
            # landed on a node the working snapshot does not know: stop and
            # close the round degraded; the next monitor realigns
            degraded = True
            break
        if i + 1 < config.moves_per_round:
            # re-home the moved service where it actually LANDED (the
            # scheduler may override the target under affinityOnly)
            svc_pods = (state.pod_service == svc_i) & state.pod_valid
            state = state.replace(
                pod_node=torch.where(svc_pods, node_index[landed], state.pod_node)
                .to(state.pod_node.dtype)
            )
    return RoundRecord(
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


def _defer_solver_objectives(closer: RoundCloser, info: dict, apply_cb) -> None:
    """Defer the solver's before/after accounting onto the round closer, so
    it rides the round's single transfer. ``apply_cb(before, after,
    improved)`` runs at flush."""
    def decode(flat) -> None:
        apply_cb(float(flat[0]), float(flat[1]), bool(flat[2]))

    closer.defer(torch.stack([info[k].float() for k in
                              ("objective_before", "objective_after", "improved")]), decode)


def _global_round(boundary, state, graph, config, rnd, *, generator, plan, closer,
                  registry) -> RoundRecord:
    """One batched solve (one restart, tp 1, service unit), then every
    service whose node changed is moved. The JAX package can donate the
    snapshot's buffers to the solve and resurrect them afterwards; torch
    has nothing to donate, so that path does not exist here."""
    cfg = GlobalSolverConfig(
        sweeps=config.global_solver_iters,
        balance_weight=config.balance_weight,
        enforce_capacity=config.enforce_capacity,
        capacity_frac=config.capacity_frac,
        move_cost=config.move_cost,
    )
    t0 = time.perf_counter()
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
    # the apply boundary: ONE batched host read of the old and new placement
    old_nodes, new_nodes, valid, svc_arr = fence(
        [state.pod_node, new_state.pod_node, state.pod_valid, state.pod_service], registry
    )
    latency = time.perf_counter() - t0

    changed: list[tuple[int, int]] = []  # (service, target node), first pod order
    seen: set[int] = set()
    for i in (valid & (old_nodes != new_nodes)).nonzero()[0]:
        s = int(svc_arr[i])
        if s not in seen:
            seen.add(s)
            changed.append((s, int(new_nodes[i])))

    t_apply = time.perf_counter()
    moved_names: list[str] = []
    applied_moves: list[tuple[str, str]] = []
    for s, target in changed:
        landed = boundary.apply_move(
            MoveRequest(
                service=graph.names[s],
                target_node=state.node_names[target],
                mechanism=PlacementMechanism["global"],
            )
        )
        if landed is not None:
            moved_names.append(graph.names[s])
            applied_moves.append((graph.names[s], landed))
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
        phase_s={"solve": latency, "apply": time.perf_counter() - t_apply},
    )

    def apply_objectives(before, after, improved) -> None:
        record.objective_before = before
        record.objective_after = after
        record.solver_improved = improved

    _defer_solver_objectives(closer, info, apply_objectives)
    return record
