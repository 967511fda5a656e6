"""The churn engine — the port of ``kubernetes_rescheduling_tpu.elastic.engine``:
applies a seeded churn profile to a backend between controller rounds,
padding live shapes into quantized buckets.

Per round (:meth:`ChurnEngine.step`):

1. build a :class:`~elastic.events.WorkloadView` of the live cluster;
2. ask the profile for this round's events (seeded: the stream is a pure
   function of ``(profile, seed, horizon, workload)``);
3. fit the shape buckets to the POST-event live counts and push the
   (possibly promoted) capacities into the backend first — snapshots are
   built padded, so capacity leads the mutation; a promotion clears the
   backend's solver caches (a cached sparse or pod graph of the old shape
   must not reach the next solve);
4. apply the events through the backend's elastic mutators;
5. count: ``churn_events_total{kind}``, the ``live_services`` /
   ``live_nodes`` and ``bucket_capacity{axis}`` gauges, and
   ``bucket_promotions_total``.

The engine mutates host state and counts; the controller decides what to
re-monitor. Host code only. In fleet mode :func:`make_fleet_churn` builds
one engine per churned tenant over ONE shared set of buckets, pushed into
every tenant's backend, so the fleet stays stackable.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from kubernetes_rescheduling_tpu_torch.elastic.buckets import ShapeBuckets
from kubernetes_rescheduling_tpu_torch.elastic.events import (
    GRAPH_EVENTS,
    WorkloadView,
    make_profile,
)
from kubernetes_rescheduling_tpu_torch.telemetry.registry import get_registry

# the elastic mutator surface a backend must expose (the simulator's; the
# boundary passes these through)
REQUIRED_MUTATORS = (
    "live_counts",
    "set_capacities",
    "deploy_service",
    "teardown_service",
    "scale_replicas",
    "add_node",
    "drain_node",
    "alive_node_names",
)


class ChurnEngine:
    """One profile's churn stream against one backend.

    ``buckets`` may be shared across engines (fleet mode: one promotion
    promotes the whole fleet), and ``capacity_sinks`` lists every backend
    whose capacities follow them (default: the bound backend alone)."""

    def __init__(self, profile: str, seed: int = 0, *, bucket_floor: int = 8,
                 buckets: ShapeBuckets | None = None, capacity_sinks: list | None = None,
                 registry=None) -> None:
        self.profile_name = profile
        self.profile = make_profile(profile)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.buckets = buckets if buckets is not None else ShapeBuckets(floor=bucket_floor)
        self.capacity_sinks = list(capacity_sinks) if capacity_sinks is not None else []
        self.registry = registry
        self.horizon = 0
        self.backend = None
        self._base_replicas: dict[str, int] = {}
        self.events_log: list[dict] = []
        self.events_applied = 0
        # per-step outcome flags the controller reads after step()
        self.graph_changed = False
        self.promoted = False

    def _reg(self):
        return self.registry if self.registry is not None else get_registry()

    def bind(self, backend, max_rounds: int, *, registry=None) -> None:
        """Attach to a backend: check its mutators, size the initial buckets
        from the live counts (a capture, not a promotion) and push the
        capacities, so even round 1's snapshot is bucket-padded."""
        missing = [m for m in REQUIRED_MUTATORS if not hasattr(backend, m)]
        if missing:
            raise TypeError(
                f"backend {type(getattr(backend, 'raw_backend', backend)).__name__} "
                f"cannot absorb churn: missing elastic mutators {missing} "
                "(churn injection requires the hermetic simulator)"
            )
        if registry is not None:
            self.registry = registry
        self.backend = backend
        self.horizon = max(int(max_rounds), 1)
        live = backend.live_counts()
        self.buckets.fit(**live)
        self._push_capacities()
        wm = backend.workmodel
        self._base_replicas = {s.name: max(1, s.replicas) for s in wm.services}
        # the autoscale profile follows the request-rate series built over
        # the bind-time workmodel from the backend's own load model, so
        # offered load and autoscaling agree on which services are hot
        if getattr(self.profile, "rates", "absent") is None:
            from kubernetes_rescheduling_tpu_torch.elastic.rates import service_rate_series

            load = getattr(backend, "load", None)
            self.profile.rates = service_rate_series(
                wm,
                entry_rps=getattr(load, "entry_rps", 100.0),
                fanout_frac=getattr(load, "fanout_frac", 1.0),
                entry_service=getattr(load, "entry_service", "s0"),
                amplitude=getattr(self.profile, "amplitude", 2.0),
                seed=self.seed,
            )
        self._publish_gauges(live)

    def _push_capacities(self) -> None:
        for sink in self.capacity_sinks or [self.backend]:
            sink.set_capacities(node=self.buckets.nodes, pod=self.buckets.pods,
                                service=self.buckets.services)

    def _view(self) -> WorkloadView:
        backend = self.backend
        wm = backend.workmodel
        alive = set(backend.alive_node_names())
        nodes = tuple(backend.node_names)
        return WorkloadView(
            services=tuple(wm.names),
            replicas={s.name: max(1, s.replicas) for s in wm.services},
            base_replicas=dict(self._base_replicas),
            nodes=nodes,
            alive=tuple(n in alive for n in nodes),
        )

    @staticmethod
    def _count_delta(events, view: WorkloadView) -> dict:
        """Post-event live counts, computed before the mutation so the
        promotion (and the capacity push) precedes the first oversized
        snapshot."""
        services = dict(view.replicas)
        nodes = set(view.nodes)
        for ev in events:
            k = ev.kind
            if k == "service_deploy":
                services[ev.spec.name] = max(1, ev.spec.replicas)
            elif k == "service_teardown":
                services.pop(ev.service, None)
            elif k == "replica_scale":
                if ev.service in services:
                    services[ev.service] = max(1, ev.replicas)
            elif k == "node_add":
                nodes.add(ev.node)
        return {"services": len(services), "nodes": len(nodes),
                "pods": sum(services.values())}

    def _apply(self, ev) -> None:
        backend = self.backend
        k = ev.kind
        if k == "service_deploy":
            backend.deploy_service(ev.spec)
        elif k == "service_teardown":
            backend.teardown_service(ev.service)
        elif k == "replica_scale":
            backend.scale_replicas(ev.service, ev.replicas)
        elif k == "node_drain":
            backend.drain_node(ev.node)
        elif k == "node_add":
            backend.add_node(ev.node)
        elif k == "spot_preemption":
            for node in ev.nodes:
                backend.drain_node(node)
        else:  # pragma: no cover - the event union is closed
            raise ValueError(f"unknown churn event kind {k!r}")

    def step(self, rnd: int) -> list[dict]:
        """Generate and apply this round's events; returns their dicts (also
        appended to ``events_log`` and counted). Sets ``graph_changed`` and
        ``promoted`` for the controller."""
        if self.backend is None:
            raise RuntimeError("ChurnEngine.step before bind()")
        view = self._view()
        events = self.profile.events(self._rng, rnd, self.horizon, view)
        self.graph_changed = any(ev.kind in GRAPH_EVENTS for ev in events)
        self.promoted = False
        if not events:
            return []
        reg = self._reg()
        if self.buckets.fit(**self._count_delta(events, view)):
            self.promoted = True
            reg.counter(
                "bucket_promotions_total",
                "shape-bucket promotions (live counts outgrew a capacity bucket — "
                "the only legal new capture under churn)",
            ).inc()
            caches = getattr(self.backend, "_solver_caches", None)
            if isinstance(caches, dict):
                caches.clear()
        self._push_capacities()
        dicts = []
        for ev in events:
            self._apply(ev)
            d = ev.as_dict()
            d["round"] = rnd
            dicts.append(d)
            reg.counter(
                "churn_events_total", "churn events applied to the cluster, by kind",
                labelnames=("kind",),
            ).labels(kind=ev.kind).inc()
        self.events_applied += len(dicts)
        self.events_log.extend(dicts)
        # the whole wave reconciles as ONE clock advance (kubelets work in
        # parallel), as apply_pod_moves charges a wave
        advance = getattr(self.backend, "advance", None)
        if advance is not None:
            advance(float(getattr(self.backend, "reconcile_delay_s", 0.0)))
        self._publish_gauges(self.backend.live_counts())
        return dicts

    def _publish_gauges(self, live: Mapping[str, int]) -> None:
        reg = self._reg()
        reg.gauge("live_services", "live (non-padding) services in the cluster").set(
            live["services"])
        reg.gauge("live_nodes", "alive schedulable nodes in the cluster").set(
            len(self.backend.alive_node_names()))
        cap = reg.gauge("bucket_capacity", "current shape-bucket capacity per padded axis",
                        labelnames=("axis",))
        for axis, value in (("services", self.buckets.services), ("nodes", self.buckets.nodes),
                            ("pods", self.buckets.pods)):
            cap.labels(axis=axis).set(value)

    def round_info(self, events: list[dict]) -> dict:
        """The ``RoundRecord.churn`` payload for one executed round."""
        live = self.backend.live_counts()
        return {
            "events": events,
            "live_services": live["services"],
            "live_nodes": len(self.backend.alive_node_names()),
            "live_pods": live["pods"],
            "bucket": self.buckets.as_dict(),
            "promotions": self.buckets.promotions,
        }


def make_fleet_churn(fleet, config, *, registry=None) -> dict[int, ChurnEngine]:
    """Per-tenant churn engines over ONE shared :class:`ShapeBuckets`, from
    the config's ``elastic`` profile: fleet tenants must keep one shape, so
    every engine pushes the shared capacities into EVERY tenant backend (a
    promotion re-pads the whole fleet) while the untouched tenants' records
    stay as without churn. ``config.elastic_tenants`` selects the tenant
    indices that churn (empty = all), each seeded ``elastic_seed + index``."""
    if config.elastic == "none":
        return {}
    hit = set(config.elastic_tenants) or set(range(fleet.num_tenants))
    for t in hit:
        if t >= fleet.num_tenants:
            raise ValueError(f"elastic tenant {t} out of range for {fleet.num_tenants} tenants")
    shared = ShapeBuckets(floor=config.bucket_floor)
    sinks = list(fleet.backends)
    return {
        t: ChurnEngine(config.elastic, seed=config.elastic_seed + t, buckets=shared,
                       capacity_sinks=sinks, registry=registry)
        for t in sorted(hit)
    }
