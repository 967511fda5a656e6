"""Retry policy for cluster-boundary calls: exponential backoff + jitter —
the port's own copy of ``kubernetes_rescheduling_tpu.utils.retry``.

Bounded attempts, exponential backoff with deterministic seeded jitter, a
per-call wall-clock deadline, and an injectable sleeper (the simulator's
clock makes retried paths hermetic and instant; a live cluster really
waits). Telemetry, through the registry:

- ``boundary_retries_total{call=...}``  — backoff sleeps performed;
- ``boundary_failures_total{call=...}`` — calls that exhausted their
  attempts or deadline.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable

from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    get_registry,
)


# one seeded stream for default jitter: see call_with_retry
_default_jitter_rng = random.Random(0)


@dataclass(frozen=True)
class RetryPolicy:
    """How a boundary call retries.

    ``max_attempts=1`` means no retries (the call runs once); backoff for
    attempt ``k`` (1-based) is ``base_delay_s * multiplier**(k-1)`` capped
    at ``max_delay_s``, scaled by a seeded jitter factor in
    ``[1-jitter_frac, 1+jitter_frac]``. ``deadline_s`` bounds the whole
    call wall-clock: no retry starts if the budget (including its own
    backoff) would be exceeded. ``retry_none=True`` additionally treats a
    ``None`` return as a transient failure (the Backend protocol's
    "move failed, skip the round" signal).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.1
    max_delay_s: float = 10.0
    multiplier: float = 2.0
    jitter_frac: float = 0.1
    deadline_s: float | None = 60.0
    retry_none: bool = False

    def validate(self) -> "RetryPolicy":
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not (0.0 <= self.jitter_frac < 1.0):
            raise ValueError("jitter_frac must be in [0, 1)")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")
        return self

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        delay = min(
            self.base_delay_s * self.multiplier ** (attempt - 1),
            self.max_delay_s,
        )
        if self.jitter_frac > 0:
            delay *= 1.0 + rng.uniform(-self.jitter_frac, self.jitter_frac)
        return max(delay, 0.0)


# API statuses worth another attempt (throttling / server-side); a
# definitive answer (404, 403, 422, …) never is.
TRANSIENT_STATUSES: tuple[int, ...] = (429, 500, 502, 503, 504)

# OSError subclasses that are definitive local answers, not transport
# blips — a missing kubeconfig or unreadable CA bundle must fail fast
# with the actionable error, never burn a retry budget.
_NON_TRANSIENT_OS: tuple[type[BaseException], ...] = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
)


def is_transient(e: BaseException) -> bool:
    """The shared transient-failure predicate: transport-level errors
    (``OSError`` covers ``ConnectionError``/``TimeoutError`` too, minus
    the definitive local subclasses above), or an API exception carrying
    a throttling/server-side ``status`` (the kubernetes client's
    ``ApiException`` shape). The controller boundary
    (``bench/boundary.py``) retries exactly these."""
    if isinstance(e, _NON_TRANSIENT_OS):
        return False
    return isinstance(e, OSError) or (
        getattr(e, "status", None) in TRANSIENT_STATUSES
    )


def call_with_retry(
    fn: Callable[[], Any],
    *,
    policy: RetryPolicy,
    label: str = "call",
    retryable: Callable[[BaseException], bool] | None = None,
    sleeper: Callable[[float], None] = time.sleep,
    registry: MetricsRegistry | None = None,
) -> Any:
    """Run ``fn()`` under ``policy``.

    ``retryable(exc)`` decides whether an exception is transient (default:
    every ``Exception``); a non-retryable exception re-raises immediately.
    On exhaustion the LAST exception re-raises (its type intact — callers
    keep matching on it); when the policy retried only ``None`` returns,
    ``None`` comes back after the final attempt. ``sleeper`` receives each
    backoff (the simulator's clock, or a real sleep).
    """
    policy = policy.validate()
    reg = registry if registry is not None else get_registry()
    # jitter draws from ONE seeded module-level stream: sequential calls in
    # a process desynchronize (the point of jitter) while a whole run stays
    # reproducible
    rng = _default_jitter_rng
    clock = time.monotonic
    t0 = clock()
    last_exc: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — filtered by `retryable`
            if retryable is not None and not retryable(e):
                raise
            last_exc = e
            out = None
        else:
            if out is not None or not policy.retry_none:
                return out
            last_exc = None
        if attempt >= policy.max_attempts:
            break
        delay = policy.backoff_s(attempt, rng)
        if (
            policy.deadline_s is not None
            and clock() - t0 + delay > policy.deadline_s
        ):
            break  # the retry would overrun the call's wall budget
        reg.counter(
            "boundary_retries_total",
            "boundary-call retries (backoff sleeps performed)",
            labelnames=("call",),
        ).labels(call=label).inc()
        sleeper(delay)
    reg.counter(
        "boundary_failures_total",
        "boundary calls that exhausted retries or deadline",
        labelnames=("call",),
    ).labels(call=label).inc()
    if last_exc is not None:
        raise last_exc
    return None  # retry_none path: every attempt returned None
