"""Hermetic cluster simulator — the port of
``kubernetes_rescheduling_tpu.backends.sim`` as far as the control loop
calls it: the load model, the seeded initial placement, ``comm_graph``,
``monitor``, Deployment moves under each pinning mechanism
(``apply_move``, with the simulated scheduler behind ``affinityOnly``),
the simulated clock (``advance``), the event list, the cordon-style
imbalance, per-pod move waves (``apply_pod_moves``), a checkpoint's
placement (``restore_placement``) and another actor's moves
(``external_move``). Node faults and churn wait for a later slice, so
every node is alive and every pod placed.

All bookkeeping is host-side Python and numpy; ``monitor`` hands out a
fresh padded :class:`ClusterState` on the backend's device. Pods are
indexed by service once at construction, so a move touches only the
moved service's pods — in pod-table order, as a full scan would.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel, propagate_entry_rate
from kubernetes_rescheduling_tpu_torch.telemetry.accounting import count_reconcile, timed_call


@dataclass
class LoadModel:
    """Deterministic µBench-like load propagation."""

    entry_service: str = "s0"
    entry_rps: float = 100.0
    cost_per_req_m: float = 2.0
    idle_m: float = 20.0
    noise_frac: float = 0.0
    fanout_frac: float = 1.0

    def service_rps(self, wm: Workmodel) -> dict[str, float]:
        """Entry rps propagated through the directed call graph."""
        return propagate_entry_rate(
            wm,
            entry_service=self.entry_service,
            entry_rps=self.entry_rps,
            fanout_frac=self.fanout_frac,
        )


@dataclass
class SimBackend:
    """In-memory cluster. ``monitor`` snapshots it as a padded
    ``ClusterState`` on ``device``; ``apply_move`` re-creates a Deployment
    and charges the simulated clock ``reconcile_delay_s``."""

    workmodel: Workmodel
    node_names: list[str]
    node_cpu_cap_m: float = 20_000.0
    node_mem_cap_b: float = 32 * 1024**3
    load: LoadModel = field(default_factory=LoadModel)
    seed: int = 0
    device: str | torch.device | None = DEFAULT_DEVICE
    reconcile_delay_s: float = 3.0     # simulated teardown+recreate latency
    pacing_s: float = 15.0             # reference main.py:27

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        self.clock_s = 0.0
        self.events: list[dict] = []
        n = len(self.node_names)
        self._node_index = {name: i for i, name in enumerate(self.node_names)}
        # pod table: (service_idx, node_idx, name); deployment = service
        self._pods: list[list] = []
        for idx, svc in enumerate(self.workmodel.services):
            for r in range(svc.replicas):
                node = int(self._rng.integers(0, n))
                self._pods.append([idx, node, f"{svc.name}-{r}"])
        self._svc_index = {name: i for i, name in enumerate(self.workmodel.names)}
        # the same pod entries, grouped by service in pod-table order
        self._service_pods: list[list[list]] = [[] for _ in self.workmodel.services]
        for pod in self._pods:
            self._service_pods[pod[0]].append(pod)
        self._graph: CommGraph | None = None  # built at first use
        self._rps_cache: tuple | None = None

    # ---- Backend protocol ----

    def comm_graph(self) -> CommGraph:
        if self._graph is None:
            self._graph = self.workmodel.comm_graph(device=self.device)
        return self._graph

    def monitor(self) -> ClusterState:
        """Snapshot with load-model CPU usage (reference podmonitor.monitor)."""
        with timed_call("sim", "monitor"):
            return self._monitor()

    def _service_rps(self) -> dict[str, float]:
        """The load model's per-service rates, propagated once per
        (workmodel, load) pair: the propagation is most of a snapshot's host
        time at 10k services, and its result depends on nothing else."""
        load = dataclasses.astuple(self.load)
        cache = self._rps_cache
        if cache is None or cache[0] is not self.workmodel or cache[1] != load:
            cache = self._rps_cache = (self.workmodel, load, self.load.service_rps(self.workmodel))
        return cache[2]

    def _stable_names(self, attr: str, names) -> tuple:
        """The same name tuple object from one snapshot to the next while
        the names are unchanged, so identity-keyed memos downstream (the
        admission guard's duplicate scan and name maps) keep hitting."""
        t = tuple(names)
        cached = getattr(self, attr, None)
        if cached is not None and cached == t:
            return cached
        setattr(self, attr, t)
        return t

    def _monitor(self) -> ClusterState:
        rps = self._service_rps()
        replicas = {s.name: max(1, s.replicas) for s in self.workmodel.services}
        services, nodes, cpus, mems, names = [], [], [], [], []
        for svc_idx, node, name in self._pods:
            spec = self.workmodel.services[svc_idx]
            per_pod = (
                self.load.idle_m
                + rps.get(spec.name, 0.0)
                / replicas[spec.name]
                * self.load.cost_per_req_m
                * spec.proc_cost
            )
            if self.load.noise_frac > 0:
                per_pod *= 1.0 + self._rng.normal(0.0, self.load.noise_frac)
            services.append(svc_idx)
            nodes.append(node)
            cpus.append(max(per_pod, 0.0))
            mems.append(float(spec.mem_request_bytes))
            names.append(name)
        return ClusterState.build(
            node_names=self._stable_names("_node_names_memo", self.node_names),
            node_cpu_cap=[self.node_cpu_cap_m] * len(self.node_names),
            node_mem_cap=[self.node_mem_cap_b] * len(self.node_names),
            pod_services=services,
            pod_nodes=nodes,
            pod_cpu=cpus,
            pod_mem=mems,
            pod_names=self._stable_names("_pod_names_memo", names),
            device=self.device,
        )

    def apply_move(self, move: MoveRequest) -> str | None:
        """Foreground delete + re-create of one service's Deployment
        (reference delete_replaced_pod.py:173-177 + rescheduling.py:57-73).

        ``nodeName`` and ``nodeSelector`` pin to the requested target;
        ``affinityOnly`` (the kubescheduling policy, reference
        rescheduling.py:159-171) only excludes ``hazard_nodes`` and lets the
        simulated scheduler choose (:meth:`_scheduler_choice`), so the
        requested target is advisory there, as on a real cluster."""
        with timed_call("sim", "apply_move"):
            return self._apply_move(move)

    def _apply_move(self, move: MoveRequest) -> str | None:
        if move.service not in self._svc_index:
            return None
        if move.mechanism == "affinityOnly":
            target = self._scheduler_choice(exclude=move.hazard_nodes)
            if target is None:
                return None
        else:
            target = self._node_index.get(move.target_node)
            if target is None:
                return None
        moved = 0
        for pod in self._service_pods[self._svc_index[move.service]]:
            if move.pod is None or pod[2] == move.pod:
                pod[1] = target
                moved += 1
                if move.pod is not None:
                    break  # a pod name matches at most one entry
        self.clock_s += self.reconcile_delay_s
        if moved:
            count_reconcile("sim", moved)
        landed = self.node_names[target]
        self.events.append(
            {
                "t": self.clock_s,
                "event": "move",
                "service": move.service,
                "target": landed,  # where pods actually went
                "requested": move.target_node,
                "pods": moved,
                "mechanism": move.mechanism,
            }
        )
        return landed if moved > 0 else None

    def advance(self, seconds: float) -> None:
        self.clock_s += seconds

    def _scheduler_choice(self, exclude: tuple[str, ...] = ()) -> int | None:
        """The stand-in for the default kube-scheduler: least-allocated CPU
        among the nodes not excluded; tie → first in node order."""
        rps = self._service_rps()
        replicas = {s.name: max(1, s.replicas) for s in self.workmodel.services}
        used = np.zeros(len(self.node_names))
        for svc_idx, node, _name in self._pods:
            spec = self.workmodel.services[svc_idx]
            used[node] += (
                self.load.idle_m
                + rps.get(spec.name, 0.0)
                / replicas[spec.name]
                * self.load.cost_per_req_m
                * spec.proc_cost
            )
        best, best_used = None, np.inf
        for i, name in enumerate(self.node_names):
            if name in exclude:
                continue
            if used[i] < best_used:
                best, best_used = i, float(used[i])
        return best

    def apply_pod_moves(self, moves) -> dict[str, str]:
        """A batch of per-pod moves as ONE reconcile wave: one pass over the
        pod table and one clock advance (kubelets reconcile in parallel).
        Returns the moved pods as ``{pod name: landed node name}``."""
        target_of: dict[str, int] = {}
        for mv in moves:
            t = self._node_index.get(mv.target_node)
            if t is not None and mv.pod is not None:
                target_of[mv.pod] = t
        landed: dict[str, str] = {}
        for pod in self._pods:
            t = target_of.get(pod[2])
            if t is not None:
                pod[1] = t
                landed[pod[2]] = self.node_names[t]
        self.clock_s += self.reconcile_delay_s
        if landed:
            count_reconcile("sim", len(landed))
        self.events.append(
            {"t": self.clock_s, "event": "pod_moves", "pods": len(landed),
             "requested": len(moves)}
        )
        return landed

    def external_move(self, pod_name: str, node: str) -> bool:
        """Move one named pod to ``node`` behind the controller's back
        (another scheduler, a human ``kubectl``): no reconcile count and no
        clock charge — the controller sees it only in its next snapshot.
        Returns whether the pod and the node exist."""
        target = self._node_index.get(node)
        if target is None:
            return False
        for pod in self._pods:
            if pod[2] == pod_name:
                pod[1] = target
                self.events.append(
                    {"t": self.clock_s, "event": "external_move", "pod": pod_name,
                     "node": node}
                )
                return True
        return False

    def external_move_random(self, rng) -> dict | None:
        """Drift one random placed pod to a random other node through
        :meth:`external_move`; ``rng`` is the caller's seeded
        ``random.Random``, so drift streams repeat."""
        placed = [p for p in self._pods if p[1] >= 0]
        if not placed:
            return None
        pod = placed[rng.randrange(len(placed))]
        others = [n for i, n in enumerate(self.node_names) if i != pod[1]]
        if not others:
            return None
        src = self.node_names[pod[1]]
        dst = others[rng.randrange(len(others))]
        if not self.external_move(pod[2], dst):
            return None
        return {"pod": pod[2], "from": src, "to": dst}

    def restore_placement(self, state: ClusterState) -> int:
        """Pin pods back to the placement a checkpoint recorded (pods are
        matched by name)."""
        pod_node = state.pod_node.cpu().numpy()
        valid = state.pod_valid.cpu().numpy()
        node_of = {name: int(pod_node[i]) for i, name in enumerate(state.pod_names)
                   if valid[i]}
        restored = 0
        for pod in self._pods:
            if pod[2] in node_of:
                pod[1] = node_of[pod[2]]
                restored += 1
        self.events.append({"t": self.clock_s, "event": "restore", "pods": restored})
        return restored

    # ---- fault injection ----

    def inject_imbalance(self, node: str) -> None:
        """The cordon trick: pile every pod onto one node
        (reference auto_full_pipeline_repeat.sh:48-51)."""
        idx = self.node_names.index(node)
        for pod in self._pods:
            pod[1] = idx
        self.events.append({"t": self.clock_s, "event": "imbalance", "node": node})
