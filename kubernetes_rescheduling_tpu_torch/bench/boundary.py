"""The controller's resilient boundary: retry wrapper + circuit breaker —
the port of ``kubernetes_rescheduling_tpu.bench.boundary``.

The controller never calls ``backend.monitor()`` / ``backend.apply_move()``
itself; every boundary call goes through a :class:`BoundaryClient`, which

- retries transient failures under a :class:`~utils.retry.RetryPolicy`
  (backoff sleeps go through the backend's own ``advance``, so a simulated
  cluster waits on the simulated clock);
- turns exhausted calls into the protocol's failure signals
  (``monitor() -> None`` / ``apply_move() -> None``) instead of crashing
  the loop;
- feeds every outcome to a :class:`CircuitBreaker`.

Breaker states: **closed** (healthy); **open** after
``max_consecutive_failures`` failures in a row — moves freeze and the
controller reuses its last good snapshot for ``cooldown_rounds`` counted
skips; **half_open** once the cooldown has elapsed — one probe
``monitor()``, whose success closes the breaker and whose failure re-opens
it. Transitions are recorded on the breaker, counted as
``circuit_breaker_transitions_total{to=...}`` and shown by the
``circuit_breaker_state`` gauge (0=closed, 1=half_open, 2=open), and
logged as a ``breaker`` event when the breaker has a logger.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

from kubernetes_rescheduling_tpu_torch.backends.base import Backend, MoveRequest
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger
from kubernetes_rescheduling_tpu_torch.utils.retry import RetryPolicy, call_with_retry, is_transient

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


@dataclass
class CircuitBreaker:
    """Consecutive-failure breaker with a cooldown-then-probe reopen path.
    ``max_consecutive_failures=0`` disables it (it never leaves closed)."""

    max_consecutive_failures: int = 5
    cooldown_rounds: int = 2
    logger: StructuredLogger | None = None
    registry: MetricsRegistry | None = None

    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at_round: int = 0
    round: int = 0
    transitions: list[dict] = field(default_factory=list)

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    def _transition(self, to: str, **fields: Any) -> None:
        if to == self.state:
            return
        rec = {"round": self.round, "from": self.state, "to": to, **fields}
        self.transitions.append(rec)
        self.state = to
        reg = self._reg()
        reg.counter(
            "circuit_breaker_transitions_total", "circuit breaker state transitions",
            labelnames=("to",),
        ).labels(to=to).inc()
        reg.gauge(
            "circuit_breaker_state", "breaker state (0=closed, 1=half_open, 2=open)",
        ).set(_STATE_CODE[to])
        if self.logger is not None:
            self.logger.info("breaker", **rec)

    @property
    def enabled(self) -> bool:
        return self.max_consecutive_failures > 0

    def on_round_start(self, rnd: int) -> str:
        """Advance the per-round clock; OPEN moves to HALF_OPEN once the
        cooldown has elapsed. Returns the state the round runs under."""
        self.round = rnd
        if self.state == OPEN and rnd - self.opened_at_round >= self.cooldown_rounds:
            self._transition(HALF_OPEN)
        return self.state

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state in (HALF_OPEN, OPEN):
            # a success while OPEN comes from the startup probe loop: a
            # healthy backend must not keep the breaker open
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
            self.enabled
            and self.state == CLOSED
            and self.consecutive_failures >= self.max_consecutive_failures
        ):
            self.opened_at_round = self.round
            self._transition(OPEN, consecutive_failures=self.consecutive_failures)


class BoundaryClient:
    """The controller's only path to the cluster. ``monitor()`` and
    ``apply_move()`` return None once retries are exhausted, and a None
    return counts as a failure. A per-round failure budget freezes the
    round's remaining moves once spent (monitors stay allowed)."""

    def __init__(
        self,
        backend: Backend,
        *,
        policy: RetryPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        failure_budget_per_round: int = 0,
        registry: MetricsRegistry | None = None,
        tenant: str | None = None,
    ):
        self.backend = backend
        # fleet mode: the tenant this boundary fronts, part of the solver
        # cache's key so tenants over shared plumbing neither share nor
        # evict each other's slots
        self.tenant = tenant
        self.policy = (policy or RetryPolicy()).validate()
        # every boundary call treats a None return as transient
        self._policy_retry_none = dataclasses.replace(self.policy, retry_none=True)
        self.breaker = breaker or CircuitBreaker(registry=registry)
        self.failure_budget_per_round = failure_budget_per_round
        self.registry = registry
        self.round_failures = 0
        self.total_failures = 0

    # ---- per-round bookkeeping ----

    def begin_round(self, rnd: int) -> str:
        self.round_failures = 0
        return self.breaker.on_round_start(rnd)

    @property
    def moves_frozen(self) -> bool:
        """Moves stop for the round when the breaker is open or the round
        has spent its failure budget."""
        return self.breaker.state == OPEN or (
            self.failure_budget_per_round > 0
            and self.round_failures >= self.failure_budget_per_round
        )

    def _failed(self) -> None:
        self.round_failures += 1
        self.total_failures += 1
        self.breaker.record_failure()

    def _call(self, call: str, fn: Callable[[], Any]):
        try:
            out = call_with_retry(
                fn,
                policy=self._policy_retry_none,
                label=call,
                retryable=is_transient,
                sleeper=self.backend.advance,  # backoff waits on the backend's clock
                registry=self.registry,
            )
        except Exception as e:  # noqa: BLE001 — non-transient re-raises
            if not is_transient(e):
                raise
            self._failed()
            return None
        if out is None:
            self._failed()
            return None
        self.breaker.record_success()
        return out

    # ---- boundary surface ----

    def monitor(self):
        return self._call("monitor", self.backend.monitor)

    def admission_reject(self, reason: str) -> None:
        """An admission-guard rejection (``bench/admission.py``): the
        monitor call succeeded but its payload was unusable (duplicate pods,
        unknown node references, a mostly-garbage metrics wave). Charged as
        a failure, so the round's failure budget burns and the caller treats
        the snapshot as ``None`` (a degraded round on the last good one).
        The transport success already reset the breaker's consecutive
        count: a backend that is reachable but lying reads as degraded
        rounds, not as an open breaker."""
        self._failed()

    def apply_move(self, move: MoveRequest) -> str | None:
        if self.moves_frozen:
            return None  # safe mode: the round's remaining moves are dropped
        return self._call("apply_move", lambda: self.backend.apply_move(move))

    def comm_graph(self):
        return self.backend.comm_graph()

    def advance(self, seconds: float) -> None:
        self.backend.advance(seconds)

    @property
    def raw_backend(self):
        """The innermost backend (unwrapping layers that keep theirs in
        ``inner``): the host of caches that must outlive a run's wrappers."""
        b = self.backend
        while hasattr(b, "inner"):
            b = b.inner
        return b

    def solver_cache(self, name: str) -> dict:
        """A named mutable cache slot kept on the raw backend, keyed
        ``(name, tenant)``, so a value derived from its graph (the sparse
        form, the pod graph, a solve's adjacency buffer) outlives one run
        and its wrappers and is never another tenant's; callers own its
        contents and their invalidation rule."""
        host = self.raw_backend
        caches = getattr(host, "_solver_caches", None)
        if caches is None:
            caches = {}
            host._solver_caches = caches
        return caches.setdefault((name, self.tenant), {})

    def evict_solver_caches(self, *, reason: str = "teardown") -> int:
        """Drop every solver-cache slot of this boundary's tenant (churn
        rewrote its graph, or a promotion re-padded it), counted in
        ``solver_cache_evictions_total{reason}``. Returns the slots
        dropped."""
        caches = getattr(self.raw_backend, "_solver_caches", None)
        if not caches:
            return 0
        doomed = [k for k in caches if k[1] == self.tenant]
        for k in doomed:
            del caches[k]
        if doomed and self.registry is not None:
            self.registry.counter(
                "solver_cache_evictions_total",
                "tenant solver-cache slots dropped (churn rewrote the tenant's graph, or "
                "a promotion re-padded it)",
                labelnames=("reason",),
            ).labels(reason=reason).inc(len(doomed))
        return len(doomed)

    def __getattr__(self, name: str) -> Any:
        # simulator-only calls (apply_pod_moves, restore_placement,
        # external_move, ...) pass through to the backend un-retried
        return getattr(self.backend, name)
