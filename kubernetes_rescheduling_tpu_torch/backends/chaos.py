"""Fault-injecting wrapper around any backend — the port of
``kubernetes_rescheduling_tpu.backends.chaos`` (numpy and stdlib, as there).

``ChaosBackend`` wraps a backend and injects seeded faults at the surface
the controller consumes:

- ``monitor()`` exceptions (:class:`ChaosError`), stale snapshots (the
  previous good snapshot served again, the very object), partial snapshots
  (a random share of valid pods dropped from validity: a watch cache that
  lags), corrupt snapshots (NaN, Inf, negative or over-capacity usage
  readings) and transient ``None`` returns;
- ``apply_move`` exceptions, timeouts (:class:`ChaosTimeoutError`, after the
  move's budget has been spent on the inner clock), transient ``None``
  returns, moves that land on the WRONG node, and lost moves (acknowledged
  at the target while nothing moved); ``apply_pod_moves`` waves get the
  landing faults per move;
- another actor's drift (a pod moved behind the controller's back, before
  the snapshot is taken), and node flap: every ``node_flap_period``
  monitors a node is killed and revived ``node_flap_down_calls`` monitors
  later (through the inner backend's ``kill_node`` / ``revive_node``).

Every injected fault is counted twice: ``chaos_faults_total{kind}`` in the
metrics registry and the wrapper's own ``fault_counts``.

The faults draw from two seeded ``random.Random`` streams in the JAX
package's call order: the main one, and the reconciliation kinds' own
(corrupt, drift, lost; seeded ``(seed << 1) ^ 0x5EED``), so turning those
kinds on never shifts the older kinds' sequence. The same profile and seed
over the same simulator give the JAX package's faults call by call.

A poisoned snapshot is a new ``ClusterState``: the arrays are read to the
host, copied, poisoned and put back on the snapshot's device as new
tensors (on the current stream, which is the monitor's in the pipelined
schedules); nothing is written in place, so the stale fault's cached
snapshot stays what it was. Everything the profile does not inject passes
straight through ``__getattr__`` (``node_names``, ``inject_imbalance``,
``restore_placement``, ``events``, the churn mutators, ...).
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.backends.base import Backend, MoveRequest
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry


class ChaosError(ConnectionError):
    """Injected boundary failure (transient by construction)."""


class ChaosTimeoutError(TimeoutError):
    """Injected boundary timeout; the inner clock has already advanced."""


@dataclass(frozen=True)
class ChaosProfile:
    """Per-call fault probabilities plus the node-flap schedule."""

    name: str = "custom"
    monitor_error_rate: float = 0.0    # monitor() raises ChaosError
    monitor_stale_rate: float = 0.0    # previous snapshot served again
    monitor_partial_rate: float = 0.0  # a random pod subset goes invalid
    monitor_none_rate: float = 0.0     # transient None return
    move_error_rate: float = 0.0       # apply_move raises ChaosError
    move_timeout_rate: float = 0.0     # apply_move raises ChaosTimeoutError
    move_none_rate: float = 0.0        # transient None return (move "failed")
    move_wrong_node_rate: float = 0.0  # lands on a different node
    move_timeout_s: float = 30.0       # clock consumed by an injected timeout
    partial_drop_frac: float = 0.2     # pod fraction dropped by a partial snapshot
    node_flap_period: int = 0          # kill a node every N monitor calls (0 = off)
    node_flap_down_calls: int = 2      # monitors the node stays dead
    # the reconciliation kinds, drawn from the dedicated stream
    monitor_corrupt_rate: float = 0.0  # NaN/Inf/negative/over-capacity loads
    external_drift_rate: float = 0.0   # a pod moves behind the controller's back
    move_lost_rate: float = 0.0        # apply_move reports success, moves nothing
    corrupt_max_pods: int = 3          # entries poisoned per corrupt snapshot

    def validate(self) -> "ChaosProfile":
        for f in dataclasses.fields(self):
            if f.name.endswith("_rate") or f.name.endswith("_frac"):
                v = getattr(self, f.name)
                if not (0.0 <= v <= 1.0):
                    raise ValueError(f"{f.name} must be in [0, 1], got {v}")
        if self.node_flap_period < 0 or self.node_flap_down_calls < 1:
            raise ValueError("node flap schedule must be non-negative / >= 1")
        if self.corrupt_max_pods < 1:
            raise ValueError("corrupt_max_pods must be >= 1")
        return self


# the named profiles of ``reschedule --chaos-profile``; "soak" is the
# acceptance soak's (every degraded path in 30 rounds), "reconcile" the
# reconciliation plane's own (transport faults off, so every round's
# snapshot is reconciled). config.CHAOS_PROFILES holds the same names.
PROFILES: dict[str, ChaosProfile] = {
    "none": ChaosProfile(name="none"),
    "flaky-monitor": ChaosProfile(
        name="flaky-monitor",
        monitor_error_rate=0.2,
        monitor_stale_rate=0.1,
        monitor_none_rate=0.05,
    ),
    "flaky-moves": ChaosProfile(
        name="flaky-moves",
        move_error_rate=0.15,
        move_timeout_rate=0.1,
        move_none_rate=0.1,
        move_wrong_node_rate=0.1,
    ),
    "node-flap": ChaosProfile(name="node-flap", node_flap_period=5, node_flap_down_calls=2),
    "soak": ChaosProfile(
        name="soak",
        monitor_error_rate=0.25,
        monitor_stale_rate=0.10,
        monitor_partial_rate=0.05,
        monitor_none_rate=0.05,
        move_error_rate=0.15,
        move_timeout_rate=0.15,
        move_none_rate=0.10,
        move_wrong_node_rate=0.10,
        node_flap_period=7,
        node_flap_down_calls=2,
        monitor_corrupt_rate=0.08,
        external_drift_rate=0.08,
        move_lost_rate=0.05,
    ),
    "reconcile": ChaosProfile(
        name="reconcile",
        monitor_corrupt_rate=0.30,
        external_drift_rate=0.35,
        move_lost_rate=0.30,
        move_wrong_node_rate=0.30,
        node_flap_period=9,
        node_flap_down_calls=2,
    ),
}


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a snapshot array (read on the current stream)."""
    return t.cpu().numpy().copy()


class ChaosBackend:
    """Wrap ``inner`` with the faults of ``profile`` (seeded)."""

    def __init__(self, inner: Backend, profile: ChaosProfile, seed: int = 0, registry=None):
        self.inner = inner
        self.profile = profile.validate()
        self.seed = seed
        self.registry = registry  # None = the process default, per call
        self._rng = random.Random(seed)
        # the reconciliation kinds' own stream (see the module docstring)
        self._rng_aux = random.Random((seed << 1) ^ 0x5EED)
        self._last_state: ClusterState | None = None
        self._monitor_calls = 0
        self._flapped_node: str | None = None
        self._flap_revive_at = 0
        self.fault_counts: dict[str, int] = {}

    # ---- fault bookkeeping ----

    def _count(self, kind: str) -> None:
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        reg = self.registry if self.registry is not None else get_registry()
        reg.counter(
            "chaos_faults_total", "faults injected by the chaos backend", labelnames=("kind",),
        ).labels(kind=kind).inc()

    def _hit(self, rate: float) -> bool:
        return rate > 0 and self._rng.random() < rate

    def _hit_aux(self, rate: float) -> bool:
        return rate > 0 and self._rng_aux.random() < rate

    # ---- Backend protocol ----

    def comm_graph(self) -> CommGraph:
        return self.inner.comm_graph()

    def _flap(self) -> None:
        """Kill/revive sequencing, driven by the monitor-call counter."""
        p = self.profile
        if p.node_flap_period <= 0:
            return
        kill = getattr(self.inner, "kill_node", None)
        revive = getattr(self.inner, "revive_node", None)
        if kill is None or revive is None:
            return  # the inner backend cannot express node death
        if self._flapped_node is not None and self._monitor_calls >= self._flap_revive_at:
            revive(self._flapped_node)
            self._count("node_revive")
            self._flapped_node = None
        if (self._flapped_node is None and self._monitor_calls % p.node_flap_period == 0
                and self._monitor_calls > 0):
            names = list(self.inner.node_names)
            if names:
                self._flapped_node = names[self._rng.randrange(len(names))]
                self._flap_revive_at = self._monitor_calls + p.node_flap_down_calls
                kill(self._flapped_node)
                self._count("node_kill")

    def monitor(self) -> ClusterState | None:
        p = self.profile
        self._monitor_calls += 1
        self._flap()
        if self._hit(p.monitor_error_rate):
            self._count("monitor_error")
            raise ChaosError("chaos: injected monitor failure")
        if self._hit(p.monitor_none_rate):
            self._count("monitor_none")
            return None
        if self._hit(p.monitor_stale_rate) and self._last_state is not None:
            self._count("monitor_stale")
            return self._last_state
        if self._hit_aux(p.external_drift_rate):
            # another actor moves a pod BEFORE the snapshot is taken, so this
            # call's snapshot already shows the drift
            drift = getattr(self.inner, "external_move_random", None)
            if drift is not None and drift(self._rng_aux) is not None:
                self._count("external_drift")
        state = self.inner.monitor()
        partial = self._hit(p.monitor_partial_rate)
        if partial:
            self._count("monitor_partial")
            state = self._partial(state)
        if self._hit_aux(p.monitor_corrupt_rate):
            self._count("monitor_corrupt")
            # a lying Metrics API: not cached as the last good snapshot
            return self._corrupt(state)
        if partial:
            return state  # not cached as the last good snapshot either
        self._last_state = state
        return state

    def _partial(self, state: ClusterState) -> ClusterState:
        """Drop a random ``partial_drop_frac`` of the valid pods. Shapes are
        untouched (only validity flips), so no capture key changes."""
        valid = _host(state.pod_valid)
        idx = np.flatnonzero(valid)
        n_drop = int(len(idx) * self.profile.partial_drop_frac)
        if n_drop > 0:
            drop = self._rng.sample(list(idx), n_drop)
            valid[np.asarray(drop, dtype=np.int64)] = False
        return state.replace(pod_valid=torch.from_numpy(valid).to(state.pod_valid.device))

    # each poisoned entry draws one of these (the admission guard quarantines
    # the first three and clamps the impossibly large reading)
    _CORRUPT_MODES = ("nan", "inf", "negative", "huge")

    def _corrupt(self, state: ClusterState) -> ClusterState:
        """Poison 1..``corrupt_max_pods`` valid pods' usage readings (CPU or
        memory, what a Metrics API reports; node capacities stay honest)
        with NaN, Inf, negative or over-capacity values."""
        idx = np.flatnonzero(state.pod_valid.cpu().numpy())
        if idx.size == 0:
            return state
        arrays = {"pod_cpu": _host(state.pod_cpu), "pod_mem": _host(state.pod_mem)}
        caps = {"pod_cpu": float(np.max(state.node_cpu_cap.cpu().numpy(), initial=0.0)),
                "pod_mem": float(np.max(state.node_mem_cap.cpu().numpy(), initial=0.0))}
        n = self._rng_aux.randint(1, min(self.profile.corrupt_max_pods, int(idx.size)))
        touched: set[str] = set()
        for i in self._rng_aux.sample(list(idx), n):
            field = "pod_cpu" if self._rng_aux.random() < 0.7 else "pod_mem"
            arr, cap = arrays[field], caps[field]
            mode = self._CORRUPT_MODES[self._rng_aux.randrange(len(self._CORRUPT_MODES))]
            if mode == "nan":
                arr[i] = np.nan
            elif mode == "inf":
                arr[i] = np.inf
            elif mode == "negative":
                arr[i] = -abs(arr[i]) - 1.0
            else:  # above any node's capacity
                arr[i] = (cap if cap > 0 else 1.0) * 50.0
            touched.add(field)
        return state.replace(**{
            f: torch.from_numpy(arrays[f]).to(getattr(state, f).device) for f in touched})

    def apply_move(self, move: MoveRequest) -> str | None:
        p = self.profile
        if self._hit(p.move_error_rate):
            self._count("move_error")
            raise ChaosError(f"chaos: injected apply_move failure ({move.service})")
        if self._hit(p.move_timeout_rate):
            self._count("move_timeout")
            # the budget was really spent: the inner clock moves first
            self.inner.advance(p.move_timeout_s)
            raise ChaosTimeoutError(
                f"chaos: apply_move({move.service}) exceeded {p.move_timeout_s}s")
        if self._hit(p.move_none_rate):
            self._count("move_none")
            return None
        if self._hit(p.move_wrong_node_rate):
            names = [n for n in getattr(self.inner, "node_names", []) if n != move.target_node]
            if names:
                self._count("move_wrong_node")
                wrong = names[self._rng.randrange(len(names))]
                return self.inner.apply_move(dataclasses.replace(move, target_node=wrong))
        if self._hit_aux(p.move_lost_rate):
            # acknowledged and recorded as landed, while nothing changed: only
            # the intent ledger's diff can see it
            self._count("move_lost")
            return move.target_node
        return self.inner.apply_move(move)

    def apply_pod_moves(self, moves):
        """A per-pod wave gets the landing faults, per move: a wrong-node
        redirect stays in the wave aimed elsewhere, a lost move is reported
        landed at its target while nothing is sent. Transport faults stay on
        :meth:`apply_move` (the wave passes the boundary un-retried, so a
        raise here would end the loop). The survivors land as ONE inner wave
        (one clock advance), which runs even when every move was lost."""
        p = self.profile
        send, lost = [], []
        names_all = list(getattr(self.inner, "node_names", []))
        for mv in moves:
            if self._hit(p.move_wrong_node_rate):
                names = [n for n in names_all if n != mv.target_node]
                if names:
                    self._count("move_wrong_node")
                    send.append(dataclasses.replace(
                        mv, target_node=names[self._rng.randrange(len(names))]))
                    continue
            if self._hit_aux(p.move_lost_rate):
                self._count("move_lost")
                if mv.pod is not None:
                    lost.append((mv.pod, mv.target_node))
                continue
            send.append(mv)
        landed = dict(self.inner.apply_pod_moves(send))
        for pod, target in lost:
            landed.setdefault(pod, target)
        return landed

    def advance(self, seconds: float) -> None:
        self.inner.advance(seconds)

    def __getattr__(self, name: str) -> Any:
        # everything not injected passes through
        return getattr(self.inner, name)


def with_chaos(backend: Backend, profile: str | ChaosProfile, seed: int = 0, registry=None):
    """Wrap ``backend`` unless the profile injects nothing (then return it
    as it is). ``profile`` is a name from :data:`PROFILES` or a
    :class:`ChaosProfile`; ``registry`` receives the fault counters
    (default: the process registry, resolved per call)."""
    if isinstance(profile, str):
        if profile not in PROFILES:
            raise ValueError(
                f"unknown chaos profile {profile!r}; expected one of {sorted(PROFILES)}")
        profile = PROFILES[profile]
    if profile.name == "none" or profile == ChaosProfile(name=profile.name):
        return backend
    return ChaosBackend(backend, profile, seed=seed, registry=registry)


__all__ = ["ChaosBackend", "ChaosError", "ChaosProfile", "ChaosTimeoutError", "PROFILES",
           "with_chaos"]
