"""The serving engine: bounded queue → batcher → one batched decision — the
port of ``kubernetes_rescheduling_tpu.serving.engine``.

Host-side request plumbing around :mod:`serving.kernel`:

- **Bounded admission**: ``place()`` sheds at once (counted
  ``serving_shed_total{reason="queue_full"}``) when the queue holds
  ``queue_depth`` requests, and rejects an unknown service with
  ``ValueError`` before a request exists.
- **Coalescing batcher**: one daemon thread collects up to ``max_batch``
  requests within ``batch_window_ms`` of the first dequeue and makes ONE
  ``place_batch`` call, padded to the static ``max_batch`` shape, so steady
  state replays one captured graph (``cuda_graph_captures_total{fn=
  "serving_place"}`` == 1) and reads its result home in one counted
  transfer (``device_transfers_total{site="serving"}``).
- **Per-request deadline**: a request whose deadline passed by the time its
  batch closes completes ``timeout`` (shed reason ``deadline``) without
  taking a batch slot.
- **Exact accounting**: each outcome has one owner — ``place()`` decides
  the sheds at admission, the batcher everything it dequeued — so
  ``placed + no_candidate + shed + timed_out == submitted`` under any
  interleaving.
- **Stage latencies**: every completed request carries queue_wait /
  batch_formation / device_dispatch / decode / total, published to the
  ``serving_request_seconds{stage}`` histograms (``MICRO_BUCKETS``).
- **Snapshot admission**: cluster state enters only through
  :meth:`ServingEngine._admitted_snapshot`, the backend's monitor through
  the admission guard (``bench/admission.py``).

The rolling summary (:meth:`ServingEngine.summary`) and the bounded
recent-request ring (:meth:`ServingEngine.ring`) feed the ops plane
(``ops=``, a ``telemetry.server.OpsPlane``) after every dispatched batch
and admission-time shed: the ``/healthz`` serving stanza, the
``serving_p99`` watchdog rule and its flight-recorder bundle. The plane's
``bind_serving`` puts the engine behind ``POST /place``: an HTTP handler
thread only enqueues, the batcher thread owns the device work. Lock order:
``_feed_lock`` → ``_cond`` / ``_feed_lock`` → the plane's lock; nothing
feeds the plane while holding ``_cond``.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch._random import gumbel as draw_gumbel
from kubernetes_rescheduling_tpu_torch._random import round_generator
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS
from kubernetes_rescheduling_tpu_torch.serving.kernel import place_batch
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import pull
from kubernetes_rescheduling_tpu_torch.telemetry.explain import greedy_explanation
from kubernetes_rescheduling_tpu_torch.telemetry.registry import (
    MICRO_BUCKETS,
    MetricsRegistry,
    get_registry,
)

OUTCOME_PLACED = "placed"
OUTCOME_NO_CANDIDATE = "no_candidate"
OUTCOME_SHED = "shed"
OUTCOME_TIMEOUT = "timeout"

SHED_QUEUE_FULL = "queue_full"
SHED_SHUTDOWN = "shutdown"
SHED_DEADLINE = "deadline"

STAGES = ("queue_wait", "batch_formation", "device_dispatch", "decode", "total")

# the batch's one device→host read (device_transfers_total{site=...})
SERVING_SITE = "serving"

# batch-size buckets: powers of two up to the largest supported max_batch
_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


@dataclass(frozen=True)
class PlaceResult:
    """One request's outcome."""

    request_id: int
    service: str
    outcome: str                       # placed|no_candidate|shed|timeout
    node: str | None = None
    node_index: int = -1
    shed_reason: str | None = None
    batch_size: int = 0
    timings_ms: dict[str, float] = field(default_factory=dict)
    explain: dict[str, Any] | None = None

    def as_dict(self) -> dict[str, Any]:
        """The JSON body ``POST /place`` answers with."""
        return {
            "request_id": self.request_id,
            "service": self.service,
            "outcome": self.outcome,
            "node": self.node,
            "node_index": self.node_index,
            **({"shed_reason": self.shed_reason} if self.shed_reason is not None else {}),
            "batch_size": self.batch_size,
            "timings_ms": dict(self.timings_ms),
            **({"explain": self.explain} if self.explain is not None else {}),
        }


class _Request:
    """A queue item; ``done`` releases the submitting thread."""

    __slots__ = ("seq", "service", "svc_idx", "deadline", "t_submit", "t_dequeue", "result",
                 "done", "ring_entry")

    def __init__(self, seq, service, svc_idx, deadline, ring_entry):
        self.seq = seq
        self.service = service
        self.svc_idx = svc_idx
        self.deadline = deadline          # absolute perf_counter, or None
        self.t_submit = time.perf_counter()
        self.t_dequeue: float | None = None
        self.result: PlaceResult | None = None
        self.done = threading.Event()
        self.ring_entry = ring_entry


class ServingEngine:
    """Request-grain placement over one backend's admitted snapshots, on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    ``policy`` is a greedy policy name; decisions use the snapshot admitted
    at construction (or by the latest :meth:`refresh_snapshot`) — serving
    scores the device-resident state, it does not monitor per request. The
    ``random`` policy's noise row of request ``seq`` comes from
    ``_random.round_generator(seed, seq)``, or from ``gumbel_rows(seq)``
    (the tests feed the JAX engine's ``fold_in(key, seq)`` rows). Call
    :meth:`start` before submitting and :meth:`stop` when done (``with
    engine:`` does both)."""

    def __init__(
        self,
        backend,
        *,
        config=None,
        policy: str = "communication",
        threshold: float = 30.0,
        seed: int = 0,
        top_k: int = 3,
        registry: MetricsRegistry | None = None,
        ops=None,
        guard=None,
        device: str | torch.device | None = DEFAULT_DEVICE,
        gumbel_rows: Callable[[int], torch.Tensor] | None = None,
    ) -> None:
        from kubernetes_rescheduling_tpu_torch.config import ServingConfig

        self.config = (config or ServingConfig()).validate()
        if policy not in POLICY_IDS:
            raise ValueError(
                f"unknown serving policy {policy!r}; expected one of {sorted(POLICY_IDS)}"
            )
        self.ops = ops
        self.device = resolve_device(device)
        self.policy = policy
        self.registry = registry
        self._backend = backend
        if guard is None:
            from kubernetes_rescheduling_tpu_torch.bench.admission import AdmissionGuard

            guard = AdmissionGuard(registry=registry)
        self._guard = guard
        self._policy_id = POLICY_IDS[policy]
        self._threshold = float(threshold)
        self._seed = int(seed)
        self._gumbel_rows = gumbel_rows
        self._top_k = int(top_k)
        self.graph = backend.comm_graph().to(self.device)
        self._svc_index = {n: i for i, n in enumerate(self.graph.names)}
        self.state = None
        self.state = self._admitted_snapshot(backend)
        self._node_names = list(self.state.node_names)

        self._cond = threading.Condition()
        self._queue: collections.deque[_Request] = collections.deque()
        self._running = False
        self._thread: threading.Thread | None = None
        self._seq = 0
        self._inflight = 0                 # queued + in the current batch
        # exact-accounting counters (single-owner writes under _cond)
        self.submitted = 0
        self.outcomes: dict[str, int] = {}
        self.shed_reasons: dict[str, int] = {}
        self.dispatches = 0
        self._batch_sizes: dict[int, int] = {}
        # rolling window of completed-request totals (seconds)
        self._recent: collections.deque[float] = collections.deque(maxlen=self.config.window)
        # bounded recent-request ring (newest last): an entry is written at
        # submit and updated in place at completion
        self._ring: collections.deque[dict[str, Any]] = collections.deque(
            maxlen=self.config.ring)
        self._started_mono = time.perf_counter()
        self._completed = 0
        # makes {compute summary → publish to ops} atomic: the plane's
        # state is last-write-wins, so without it a request thread's stale
        # summary could overwrite the batcher's fresher one
        self._feed_lock = threading.Lock()

    # ---- snapshot admission ----

    def _admitted_snapshot(self, backend):
        """The engine's only cluster-state ingest: a fresh monitor snapshot
        through the admission guard. A rejected snapshot keeps serving the
        last admitted state; a rejection with no state yet raises."""
        admitted = self._guard.admit(backend.monitor().to(self.device))
        if admitted is None:
            if self.state is None:
                raise RuntimeError(
                    "serving: the first monitor snapshot was rejected by the admission guard "
                    "— no admitted state to serve from"
                )
            return self.state
        return admitted

    def refresh_snapshot(self) -> None:
        """Admit a fresh snapshot (between soak phases; never per request)."""
        self.state = self._admitted_snapshot(self._backend)
        self._node_names = list(self.state.node_names)

    # ---- lifecycle ----

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._run, name="krt-serving-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- metrics ----

    def _reg(self) -> MetricsRegistry:
        return self.registry if self.registry is not None else get_registry()

    def _count_outcome(self, outcome: str) -> None:
        self._reg().counter(
            "serving_placements_total", "serving requests completed, by outcome",
            labelnames=("outcome",),
        ).labels(outcome=outcome).inc()

    def _count_shed(self, reason: str) -> None:
        self._reg().counter(
            "serving_shed_total", "serving requests shed under overload, by reason",
            labelnames=("reason",),
        ).labels(reason=reason).inc()

    def _observe_stage(self, stage: str, seconds: float) -> None:
        self._reg().histogram(
            "serving_request_seconds",
            "per-request serving latency decomposed by stage "
            "(queue_wait/batch_formation/device_dispatch/decode/total)",
            labelnames=("stage",),
            buckets=MICRO_BUCKETS,
        ).labels(stage=stage).observe(max(seconds, 0.0))

    def _set_inflight(self, n: int) -> None:
        self._inflight = n
        self._reg().gauge(
            "serving_inflight", "serving requests currently queued or in the forming batch",
        ).set(n)

    # ---- submission ----

    def place(self, service: str, *, deadline_ms: float | None = None) -> PlaceResult:
        """Submit one request and block until its outcome. An unknown
        service raises ``ValueError`` (nothing is submitted); every
        submitted request resolves to exactly one counted outcome."""
        svc_idx = self._svc_index.get(service)
        if svc_idx is None:
            raise ValueError(
                f"unknown service {service!r} (not in the snapshot's communication graph)"
            )
        if deadline_ms is None:
            deadline_ms = self.config.deadline_ms
        deadline = (time.perf_counter() + float(deadline_ms) / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        shed: PlaceResult | None = None
        with self._cond:
            self.submitted += 1
            seq = self._seq
            self._seq += 1
            ring_entry = {"request_id": seq, "service": service, "outcome": "inflight",
                          "submitted_ts": time.time()}
            self._ring.append(ring_entry)
            req = _Request(seq, service, svc_idx, deadline, ring_entry)
            if not self._running:
                shed = self._shed_locked(req, SHED_SHUTDOWN)
            elif len(self._queue) >= self.config.queue_depth:
                shed = self._shed_locked(req, SHED_QUEUE_FULL)
            else:
                self._queue.append(req)
                self._set_inflight(self._inflight + 1)
                self._cond.notify()
        if shed is not None:
            # feed the plane only AFTER _cond is released: _feed_ops
            # re-enters _cond through summary()/ring()
            self._feed_ops()
            return shed
        req.done.wait()
        assert req.result is not None
        return req.result

    def _shed_locked(self, req: _Request, reason: str) -> PlaceResult:
        """Complete a request as shed at admission (the caller holds _cond)."""
        timings = {"queue_wait": 0.0, "batch_formation": 0.0, "device_dispatch": 0.0,
                   "decode": 0.0, "total": (time.perf_counter() - req.t_submit) * 1e3}
        result = PlaceResult(request_id=req.seq, service=req.service, outcome=OUTCOME_SHED,
                             shed_reason=reason, timings_ms=timings)
        self.outcomes[OUTCOME_SHED] = self.outcomes.get(OUTCOME_SHED, 0) + 1
        self.shed_reasons[reason] = self.shed_reasons.get(reason, 0) + 1
        self._count_outcome(OUTCOME_SHED)
        self._count_shed(reason)
        req.ring_entry.update(outcome=OUTCOME_SHED, shed_reason=reason)
        req.result = result
        req.done.set()
        return result

    # ---- the batcher ----

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait()
                if not self._queue:
                    break  # stopped and drained
                batch = [self._queue.popleft()]
                batch[0].t_dequeue = time.perf_counter()
                window_end = batch[0].t_dequeue + self.config.batch_window_ms / 1e3
                while len(batch) < self.config.max_batch:
                    if self._queue:
                        req = self._queue.popleft()
                        req.t_dequeue = time.perf_counter()
                        batch.append(req)
                        continue
                    remaining = window_end - time.perf_counter()
                    if remaining <= 0 or not self._running:
                        break
                    self._cond.wait(remaining)
            self._process_batch(batch)
            with self._cond:
                self._set_inflight(len(self._queue))

    def noise_rows(self, seqs) -> torch.Tensor:
        """f32[len(seqs), N] on the host: the ``random`` policy's row of each
        request sequence number (``gumbel_rows`` when given)."""
        n = self.state.num_nodes
        if self._gumbel_rows is not None:
            return torch.stack([self._gumbel_rows(int(s)).cpu().float() for s in seqs])
        return torch.stack([draw_gumbel((n,), round_generator(self._seed, int(s)), "cpu")
                            for s in seqs])

    def _process_batch(self, batch: list[_Request]) -> None:
        t_closed = time.perf_counter()
        live: list[_Request] = []
        for req in batch:
            if req.deadline is not None and t_closed > req.deadline:
                self._complete_timeout(req, t_closed)
            else:
                live.append(req)
        if not live:
            return
        # pad to the static max_batch shape: one capture for every batch
        # size; padded slots score service 0 and are discarded
        B = self.config.max_batch
        svcs = np.zeros(B, dtype=np.int64)
        for i, req in enumerate(live):
            svcs[i] = req.svc_idx
        gumbel = None
        if self.policy == "random":
            gumbel = torch.zeros((B, self.state.num_nodes), dtype=torch.float32)
            gumbel[:len(live)] = self.noise_rows([r.seq for r in live])
        t0 = time.perf_counter()
        most, target, bundle = place_batch(self.state, self.graph, self._policy_id,
                                           self._threshold, torch.from_numpy(svcs), gumbel,
                                           top_k=self._top_k)
        k = int(bundle.shape[-1])
        flat = pull(torch.cat([most.float(), target.float(), bundle.reshape(-1)]),
                    site=SERVING_SITE, registry=self._reg())
        t1 = time.perf_counter()
        most_h, target_h = flat[:B].astype(np.int64), flat[B:2 * B].astype(np.int64)
        bundle_h = flat[2 * B:].reshape(B, 6, k)
        with self._cond:
            self.dispatches += 1
            n = len(live)
            self._batch_sizes[n] = self._batch_sizes.get(n, 0) + 1
        self._reg().histogram(
            "serving_batch_size", "live requests per coalesced serving dispatch",
            buckets=_BATCH_BUCKETS,
        ).observe(len(live))
        for i, req in enumerate(live):
            self._complete_placed(req, int(target_h[i]), int(most_h[i]), bundle_h[i],
                                  batch_size=len(live), t_closed=t_closed, t_dispatch=(t0, t1))
        self._feed_ops()

    def _complete_timeout(self, req: _Request, now: float) -> None:
        timings = {"queue_wait": ((req.t_dequeue or now) - req.t_submit) * 1e3,
                   "batch_formation": 0.0, "device_dispatch": 0.0, "decode": 0.0,
                   "total": (now - req.t_submit) * 1e3}
        result = PlaceResult(request_id=req.seq, service=req.service, outcome=OUTCOME_TIMEOUT,
                             shed_reason=SHED_DEADLINE, timings_ms=timings)
        # a timeout counts both as outcome `timeout` and shed reason
        # `deadline`, in the metrics and in the summary alike
        with self._cond:
            self.outcomes[OUTCOME_TIMEOUT] = self.outcomes.get(OUTCOME_TIMEOUT, 0) + 1
            self.shed_reasons[SHED_DEADLINE] = self.shed_reasons.get(SHED_DEADLINE, 0) + 1
        self._count_outcome(OUTCOME_TIMEOUT)
        self._count_shed(SHED_DEADLINE)
        req.ring_entry.update(shed_reason=SHED_DEADLINE)
        self._finish(req, result, timings)

    def _complete_placed(self, req: _Request, target: int, most: int, bundle, *,
                         batch_size: int, t_closed: float, t_dispatch: tuple[float, float]
                         ) -> None:
        t0, t1 = t_dispatch
        outcome = OUTCOME_PLACED if target >= 0 else OUTCOME_NO_CANDIDATE
        names = self._node_names
        node = names[target] if 0 <= target < len(names) else None
        hazard = names[most] if 0 <= most < len(names) else None
        explain = greedy_explanation(bundle, names, round=0, seq=req.seq, policy=self.policy,
                                     service=req.service, hazard_node=hazard, chosen=node)
        now = time.perf_counter()
        timings = {
            "queue_wait": ((req.t_dequeue or t_closed) - req.t_submit) * 1e3,
            "batch_formation": (t_closed - (req.t_dequeue or t_closed)) * 1e3,
            "device_dispatch": (t1 - t0) * 1e3,
            "decode": (now - t1) * 1e3,
            "total": (now - req.t_submit) * 1e3,
        }
        result = PlaceResult(request_id=req.seq, service=req.service, outcome=outcome,
                             node=node, node_index=target, batch_size=batch_size,
                             timings_ms=timings, explain=explain)
        with self._cond:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        self._count_outcome(outcome)
        req.ring_entry.update(node=node, batch_size=batch_size)
        self._finish(req, result, timings)

    def _finish(self, req: _Request, result: PlaceResult, timings: dict[str, float]) -> None:
        for stage in STAGES:
            self._observe_stage(stage, timings.get(stage, 0.0) / 1e3)
        with self._cond:
            self._recent.append(timings["total"] / 1e3)
            self._completed += 1
        req.ring_entry.update(outcome=result.outcome, total_ms=timings["total"])
        req.result = result
        req.done.set()

    # ---- summaries ----

    def summary(self) -> dict[str, Any]:
        """The rolling serving summary: totals, the request rate,
        p50/p95/p99 over the last ``window`` requests, the batch-size
        distribution and the sheds."""
        with self._cond:
            recent = list(self._recent)
            outcomes = dict(self.outcomes)
            sheds = dict(self.shed_reasons)
            batch_sizes = {str(k): v for k, v in sorted(self._batch_sizes.items())}
            submitted, completed = self.submitted, self._completed
            dispatches, inflight = self.dispatches, self._inflight
        uptime = max(time.perf_counter() - self._started_mono, 1e-9)
        q = (np.percentile(np.asarray(recent) * 1e3, [50, 95, 99]) if recent
             else (0.0, 0.0, 0.0))
        return {
            "submitted": submitted,
            "completed": completed,
            "count": len(recent),
            "rate_rps": completed / uptime,
            "p50_ms": float(q[0]),
            "p95_ms": float(q[1]),
            "p99_ms": float(q[2]),
            "batch_sizes": batch_sizes,
            "dispatches": dispatches,
            "outcomes": outcomes,
            "shed": sheds,
            "inflight": inflight,
        }

    def ring(self) -> list[dict[str, Any]]:
        """The bounded recent-request ring (newest last) — the payload
        breaker-open and serving_p99 flight-recorder bundles ship."""
        with self._cond:
            return [dict(e) for e in self._ring]

    def _feed_ops(self) -> None:
        """Publish the summary and ring to the ops plane. Never called while
        holding ``_cond`` (summary()/ring() take it briefly, and the plane
        takes its own lock inside): ``_feed_lock`` → ``_cond`` and
        ``_feed_lock`` → the plane's lock are the only orders."""
        if self.ops is None:
            return
        with self._feed_lock:
            self.ops.observe_serving(self.summary(), requests=self.ring())
