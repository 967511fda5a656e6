"""Typed churn events and seeded churn profiles — the port of
``kubernetes_rescheduling_tpu.elastic.events``.

The profiles:

- ``steady`` — background replica jitter: a quiet cluster that still moves;
- ``diurnal-autoscale`` — per-service replica targets follow the request
  rate series (:func:`~elastic.rates.service_rate_series`), ×0.5–×2 over
  the horizon, plus one node drain/add cycle;
- ``deploy-waves`` — periodic waves of new services wired into the live
  call graph, the oldest wave torn down as new ones land;
- ``node-flap`` — a rotating node drains and returns, with one
  mid-horizon spot-preemption burst.

Events are frozen dataclasses (``as_dict`` for telemetry); the
:class:`~elastic.engine.ChurnEngine` applies them between rounds. A
profile is deterministic under its seed: the same ``(profile, seed,
horizon, workload)`` gives the same event stream as the JAX package's.
Host code only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from kubernetes_rescheduling_tpu_torch.config import ELASTIC_PROFILES
from kubernetes_rescheduling_tpu_torch.core.workmodel import ServiceSpec


@dataclass(frozen=True)
class ServiceDeploy:
    """A new service lands (one deploy of a wave): its spec carries the
    callees wiring it into the live call graph."""

    spec: ServiceSpec
    kind: str = field(default="service_deploy", init=False)

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "service": self.spec.name,
            "replicas": self.spec.replicas,
            "callees": list(self.spec.callees),
        }


@dataclass(frozen=True)
class ServiceTeardown:
    service: str
    kind: str = field(default="service_teardown", init=False)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "service": self.service}


@dataclass(frozen=True)
class ReplicaScale:
    """Autoscale one service to a new replica target (up or down)."""

    service: str
    replicas: int
    kind: str = field(default="replica_scale", init=False)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "service": self.service, "replicas": self.replicas}


@dataclass(frozen=True)
class NodeDrain:
    """Cordon+drain: the node leaves the pool, its pods reschedule."""

    node: str
    kind: str = field(default="node_drain", init=False)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "node": self.node}


@dataclass(frozen=True)
class NodeAdd:
    """A node (re)joins the pool: a drained slot revives, or a brand-new
    node name grows the cluster."""

    node: str
    kind: str = field(default="node_add", init=False)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "node": self.node}


@dataclass(frozen=True)
class SpotPreemption:
    """A burst of simultaneous node losses (spot/preemptible reclaim)."""

    nodes: tuple[str, ...]
    kind: str = field(default="spot_preemption", init=False)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "nodes": list(self.nodes)}


ChurnEvent = (
    ServiceDeploy
    | ServiceTeardown
    | ReplicaScale
    | NodeDrain
    | NodeAdd
    | SpotPreemption
)

# event kinds that change the communication graph (service set / edges):
# the controller refreshes its decision+metric graphs when one applies
GRAPH_EVENTS = ("service_deploy", "service_teardown")


@dataclass(frozen=True)
class WorkloadView:
    """What a profile may read about the live cluster each round —
    assembled by the engine so profiles never touch backend internals."""

    services: tuple[str, ...]                 # live service names, index order
    replicas: Mapping[str, int]               # live replica targets
    base_replicas: Mapping[str, int]          # replica targets at bind time
    nodes: tuple[str, ...]                    # every node slot (incl. drained)
    alive: tuple[bool, ...]                   # index-aligned with ``nodes``

    @property
    def alive_nodes(self) -> tuple[str, ...]:
        return tuple(n for n, a in zip(self.nodes, self.alive) if a)


class ChurnProfileBase:
    """One named churn source. Stateful where the schedule needs memory
    (deployed waves, drained nodes); all randomness flows through the
    engine's seeded rng argument, so state never hides a seed."""

    name: str = "base"

    def events(
        self,
        rng: np.random.Generator,
        rnd: int,
        horizon: int,
        view: WorkloadView,
    ) -> list:
        raise NotImplementedError


class SteadyProfile(ChurnProfileBase):
    """Background churn: roughly every third round one service's replica
    count jitters ±1 around its bind-time target. Structural shapes never
    change — the profile that pins "a quiet cluster stays at 1 trace"."""

    name = "steady"

    def __init__(self, rate: float = 0.35):
        self.rate = rate

    def events(self, rng, rnd, horizon, view):
        if not view.services or rng.random() >= self.rate:
            return []
        svc = str(view.services[int(rng.integers(len(view.services)))])
        base = int(view.base_replicas.get(svc, 1))
        cur = int(view.replicas.get(svc, base))
        target = max(1, base + int(rng.integers(-1, 2)))
        if target == cur:
            return []
        return [ReplicaScale(service=svc, replicas=target)]


class DiurnalAutoscaleProfile(ChurnProfileBase):
    """Traffic-driven autoscaling: each service's replica target follows
    its request-rate factor from the load generator's rate series
    (``elastic.rates.service_rate_series`` — the engine binds one over
    the live workmodel), swinging ×1/amplitude–×amplitude across the
    horizon, plus ONE node drain/add cycle (a pool scale-down that comes
    back) — the acceptance-soak scenario.
    """

    name = "diurnal-autoscale"

    def __init__(
        self,
        amplitude: float = 2.0,
        drain_frac: float = 1 / 3,
        revive_frac: float = 2 / 3,
    ):
        self.amplitude = amplitude
        self.drain_frac = drain_frac
        self.revive_frac = revive_frac
        self.rates = None          # bound by the engine (RateProfile)
        self._drained: str | None = None

    def _default_factor(self, rnd: int, horizon: int) -> float:
        # no rate series (service not in it, or none bound): the plain
        # shared diurnal sinusoid
        phase = (rnd - 1) / max(horizon, 1)
        return float(self.amplitude ** math.sin(2.0 * math.pi * phase))

    def events(self, rng, rnd, horizon, view):
        out: list = []
        # ONE factors build per round — RateProfile.factors interpolates
        # all S services at once, and re-deriving it per service would
        # make a churn round O(S^2) host-side
        factors = (
            self.rates.factors(rnd, horizon) if self.rates is not None else {}
        )
        fallback = self._default_factor(rnd, horizon)
        for svc in view.services:
            base = int(view.base_replicas.get(svc, 1))
            factor = float(factors.get(svc, fallback))
            target = max(1, int(round(base * factor)))
            if target != int(view.replicas.get(svc, base)):
                out.append(ReplicaScale(service=svc, replicas=target))
        drain_rnd = max(1, int(math.ceil(horizon * self.drain_frac)))
        revive_rnd = max(drain_rnd + 1, int(math.ceil(horizon * self.revive_frac)))
        if rnd == drain_rnd and self._drained is None and len(view.alive_nodes) > 1:
            self._drained = str(view.alive_nodes[-1])
            out.append(NodeDrain(node=self._drained))
        if rnd == revive_rnd and self._drained is not None:
            out.append(NodeAdd(node=self._drained))
            self._drained = None
        return out


class DeployWavesProfile(ChurnProfileBase):
    """Deploy/teardown waves: every ``every`` rounds a wave of ``wave``
    new services lands, each calling up to two seeded-random live
    services; once more than ``max_waves`` waves are live the oldest
    tears down. The service set — and the comm graph — genuinely grows
    and shrinks."""

    name = "deploy-waves"

    def __init__(self, every: int = 5, wave: int = 2, max_waves: int = 2):
        self.every = max(1, every)
        self.wave = max(1, wave)
        self.max_waves = max(1, max_waves)
        self._waves: list[list[str]] = []
        self._counter = 0

    def events(self, rng, rnd, horizon, view):
        if (rnd - 1) % self.every != 0:
            return []
        out: list = []
        names: list[str] = []
        live = list(view.services)
        for _ in range(self.wave):
            self._counter += 1
            name = f"churn{self._counter}"
            callees = []
            if live:
                k = min(2, len(live))
                idx = rng.choice(len(live), size=k, replace=False)
                callees = [str(live[int(i)]) for i in idx]
            names.append(name)
            out.append(
                ServiceDeploy(
                    spec=ServiceSpec(
                        name=name,
                        callees=tuple(callees),
                        cpu_request_millicores=100,
                        replicas=1,
                    )
                )
            )
        self._waves.append(names)
        if len(self._waves) > self.max_waves:
            for gone in self._waves.pop(0):
                if gone in view.services:
                    out.append(ServiceTeardown(service=gone))
        return out


class NodeFlapProfile(ChurnProfileBase):
    """Node-pool churn: every ``period`` rounds the next node in
    rotation drains for ``down_for`` rounds, and at mid-horizon a
    spot-preemption burst takes two nodes at once (back the round
    after). At least two nodes always stay alive."""

    name = "node-flap"

    def __init__(self, period: int = 4, down_for: int = 2):
        self.period = max(1, period)
        self.down_for = max(1, down_for)
        self._down: dict[str, int] = {}   # node -> revive round
        self._rotation = 0
        self._preempted: tuple[str, ...] = ()

    def events(self, rng, rnd, horizon, view):
        out: list = []
        for node, back in sorted(self._down.items()):
            if rnd >= back:
                out.append(NodeAdd(node=node))
        self._down = {n: b for n, b in self._down.items() if rnd < b}
        if self._preempted:
            for node in self._preempted:
                out.append(NodeAdd(node=node))
            self._preempted = ()
        alive = [n for n in view.alive_nodes if n not in self._down]
        if (rnd - 1) % self.period == 0 and len(alive) > 2:
            node = alive[self._rotation % len(alive)]
            self._rotation += 1
            self._down[str(node)] = rnd + self.down_for
            out.append(NodeDrain(node=str(node)))
        alive = [n for n in view.alive_nodes if n not in self._down]
        if rnd == max(1, horizon // 2) and len(alive) > 3:
            burst = tuple(str(n) for n in alive[-2:])
            self._preempted = burst
            out.append(SpotPreemption(nodes=burst))
        return out


def make_profile(name: str) -> ChurnProfileBase:
    """Profile factory — the churn twin of ``backends.chaos.PROFILES``."""
    table = {
        "steady": SteadyProfile,
        "diurnal-autoscale": DiurnalAutoscaleProfile,
        "deploy-waves": DeployWavesProfile,
        "node-flap": NodeFlapProfile,
    }
    if name not in table:
        raise ValueError(
            f"unknown churn profile {name!r}; expected one of {sorted(table)}"
        )
    return table[name]()


# the config module mirrors this registry so TOML validation stays light;
# the two must never drift
assert tuple(sorted(ELASTIC_PROFILES)) == tuple(
    sorted(("steady", "diurnal-autoscale", "deploy-waves", "node-flap"))
)
