"""Replay backend: a recorded cluster trace behind the ``Backend`` surface —
the port of ``kubernetes_rescheduling_tpu.backends.replay``, the shadow
plane's transport.

``monitor()`` serves the trace's snapshot windows one per call: the TRACE
drives the clock, and each post-move monitor observes what the recorded
cluster (and its scheduler) did next. ``apply_move`` is advisory-only by
construction: it records the recommendation (``recommendations``,
``shadow_recommendations_total``) and returns the requested target, and
the class holds no cluster state it could mutate. The controller marks
every intent of an ``advisory_only`` backend advisory, so the intent
ledger adopts the recorded placement instead of charging the recorded
scheduler's choices as drift.

Every window builds at the trace-wide node table and largest window's pod
count (``traces.corpus.ClusterTrace``), and the backend hands out ONE
``CommGraph`` object, so a replay keys one capture of its solve.
Snapshots are built fresh per ``monitor`` on the host and uploaded to
``device`` (the card unless the caller asks for the CPU); the trace is the
only state, so fresh builds are identical and two replays recommend
identically.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest
from kubernetes_rescheduling_tpu_torch.backends.sim import _upload
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import timed_call
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry
from kubernetes_rescheduling_tpu_torch.traces.corpus import (
    REASON_UNKNOWN_NODE_REF,
    ClusterTrace,
    count_quarantine,
    window_state,
)


class ReplayBackend:
    """Serve a :class:`~traces.corpus.ClusterTrace` as a cluster."""

    # the controller reads this and marks every intent advisory: a
    # recommendation is advisory by definition, and the recorded
    # scheduler's placement is the ground truth the ledger adopts
    advisory_only = True
    supports_pod_moves = True  # recommendations may be pod-granular

    def __init__(self, trace: ClusterTrace, *, pod_capacity: int | None = None,
                 registry=None, device: str | torch.device | None = DEFAULT_DEVICE) -> None:
        windows = trace.windows()
        if not windows:
            raise ValueError(f"empty trace: {trace.source}")
        if not any(w.pods for w in windows):
            raise ValueError(
                f"trace {trace.source} carries no pod records — nothing to replay "
                "(rounds.jsonl-converted traces are usage/placement corpora for the "
                "schema tooling, not replay inputs; use an external-format or native trace)")
        self.trace = trace
        self.registry = registry
        self.device = resolve_device(device)
        self._windows = windows
        self._pod_capacity = pod_capacity or trace.max_window_pods
        self._graph = trace.comm_graph(self.device)
        self._idx = -1
        # phantom node references count ONCE, at load: monitor() rebuilds
        # windows every serve (the clamped tail included)
        declared = set(trace.node_names)
        unknown = sum(1 for w in windows for rec in w.pods
                      if rec.get("node") is not None and rec["node"] not in declared)
        count_quarantine(registry, REASON_UNKNOWN_NODE_REF, unknown)
        self.clock_s = 0.0
        # the shadow ledger: every recommendation the controller issued, in
        # order, with the window it was decided against
        self.recommendations: list[dict] = []

    # ---- Backend protocol ----

    def comm_graph(self) -> CommGraph:
        return self._graph

    @property
    def window(self) -> int:
        """Index of the most recently served window."""
        return max(self._idx, 0)

    @property
    def exhausted(self) -> bool:
        """True once the last window has been served (further monitors
        re-serve it: the steady tail)."""
        return self._idx >= len(self._windows) - 1

    def monitor(self) -> ClusterState:
        """Serve the next snapshot window (clamped at the trace's end),
        built fresh on the host and uploaded to the backend's device."""
        with timed_call("replay", "monitor"):
            self._idx = min(self._idx + 1, len(self._windows) - 1)
            self.clock_s = float(self._windows[self._idx].t)
            state = window_state(self.trace, self._idx, pod_capacity=self._pod_capacity,
                                 registry=self.registry, count_refs=False, device="cpu")
            return _upload(state, self.device)

    def apply_move(self, move: MoveRequest) -> str | None:
        """Record the recommendation; mutate nothing. Returns the requested
        target (the advisory echo: the recorded scheduler's choice shows at
        the next monitor)."""
        with timed_call("replay", "apply_move"):
            self.recommendations.append({
                "t": self.clock_s,
                "window": self.window,
                "service": move.service,
                "pod": move.pod,
                "target": move.target_node,
                "mechanism": move.mechanism,
            })
            reg = self.registry if self.registry is not None else get_registry()
            reg.counter(
                "shadow_recommendations_total",
                "rescheduling moves recommended (never applied) by the shadow plane's "
                "replay backend",
            ).inc()
            return move.target_node

    def advance(self, seconds: float) -> None:
        """Pacing is informational: the trace drives the clock (each monitor
        stamps the served window's timestamp)."""
        self.clock_s += float(seconds)
