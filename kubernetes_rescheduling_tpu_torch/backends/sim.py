"""Hermetic cluster simulator — the port of
``kubernetes_rescheduling_tpu.backends.sim`` as far as the control loop
calls it: the load model, the seeded initial placement, ``comm_graph``,
``monitor``, Deployment moves under each pinning mechanism
(``apply_move``, with the simulated scheduler behind ``affinityOnly``),
the simulated clock (``advance``), the event list, the cordon-style
imbalance, per-pod move waves (``apply_pod_moves``), a checkpoint's
placement (``restore_placement``) and another actor's moves
(``external_move``), the elastic mutators the churn engine drives
(``elastic/engine.py``): capacity-padded snapshots (``set_capacities``),
service deploy and teardown (with service-index compaction), replica
scaling, and node drain and add; and the fault mutators the chaos backend
(``backends/chaos.py``) drives: node death and revival (``kill_node``,
``revive_node``), a service's CPU hot spot (``cpu_spike``) and random pod
restarts (``churn``).

All bookkeeping is host-side Python and numpy; ``monitor`` hands out a
fresh padded :class:`ClusterState` on the backend's device, uploaded from
pinned memory without a wait. Pods are indexed by service, so a move
touches only the moved service's pods — in pod-table order, as a full scan
would.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.backends.base import MoveRequest
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState, CommGraph
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


def workload_layout(workmodel: Workmodel, service_capacity: int | None,
                    device: str | torch.device | None = DEFAULT_DEVICE
                    ) -> tuple[CommGraph, dict[str, int]]:
    """The derived workload layout — the comm graph padded to the service
    bucket and the service index — shared by :class:`SimBackend` and the
    device twin (``backends.sim_device.twin_of``), so a twin built after
    churn scores the topology the backend serves (teardown compaction
    renumbers services)."""
    cap = service_capacity
    if cap is not None:
        # a mid-step deploy never outruns a stale bucket
        cap = max(cap, len(workmodel.services))
    graph = workmodel.comm_graph(capacity=cap, device=device)
    return graph, {n: i for i, n in enumerate(workmodel.names)}


def _upload(state: ClusterState, device: torch.device) -> ClusterState:
    """A host-built snapshot on ``device``: each tensor through pinned memory
    without a wait, on the current stream (the pipelined loop's monitor
    stream when it runs there)."""
    if device.type != "cuda":
        return state.to(device)
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).pin_memory().to(device, non_blocking=True)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
    })


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
    # snapshot padding (the churn engine's shape buckets; None = exact)
    node_capacity: int | None = None
    pod_capacity: int | None = None
    service_capacity: int | None = None
    reconcile_delay_s: float = 3.0     # simulated teardown+recreate latency
    pacing_s: float = 15.0             # reference main.py:27

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        self.clock_s = 0.0
        self.events: list[dict] = []
        n = len(self.node_names)
        self._node_index = {name: i for i, name in enumerate(self.node_names)}
        self._node_alive = np.ones(n, dtype=bool)
        # pod table: (service_idx, node_idx, name); deployment = service
        self._pods: list[list] = []
        for idx, svc in enumerate(self.workmodel.services):
            for r in range(svc.replicas):
                node = int(self._rng.integers(0, n))
                self._pods.append([idx, node, f"{svc.name}-{r}"])
        self._rps_cache: tuple | None = None
        self._per_pod_cache: tuple | None = None
        # per-service CPU multipliers of cpu_spike, by service name
        self._cpu_spike: dict[str, float] = {}
        self._refresh_workload()

    def _refresh_workload(self) -> None:
        """The derived-state rebuild after the service set changed: the
        service index, the per-service pod lists, and the comm graph (built
        again at its next use, from :func:`workload_layout`)."""
        self._svc_index = {name: i for i, name in enumerate(self.workmodel.names)}
        self._reindex_pods()
        self._graph: CommGraph | None = None

    def _reindex_pods(self) -> None:
        # the pod entries grouped by service, in pod-table order
        self._service_pods: list[list[list]] = [[] for _ in self.workmodel.services]
        for pod in self._pods:
            self._service_pods[pod[0]].append(pod)

    @property
    def _pods(self) -> list[list]:
        """The pod table; pods a scale-down removed leave it here. A caller
        may change its entries, so reading it drops the column arrays of
        :meth:`_table_arrays`."""
        self._arrays = None
        if self._tombstones:
            gone, self._tombstones = self._tombstones, set()
            self._pod_table = [p for p in self._pod_table if id(p) not in gone]
        return self._pod_table

    @_pods.setter
    def _pods(self, table: list[list]) -> None:
        self._pod_table = table
        self._tombstones: set[int] = set()
        self._arrays: list[np.ndarray] | None = None

    # ---- Backend protocol ----

    def comm_graph(self) -> CommGraph:
        if self._graph is None:
            self._graph = workload_layout(self.workmodel, self.service_capacity,
                                          self.device)[0]
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
        per_svc = self._per_pod_cpu()
        spike = self._cpu_spike
        services, nodes, cpus, mems, names = [], [], [], [], []
        for svc_idx, node, name in self._pods:
            spec = self.workmodel.services[svc_idx]
            per_pod = float(per_svc[svc_idx])
            if spike:
                per_pod *= spike.get(spec.name, 1.0)
            if self.load.noise_frac > 0:
                per_pod *= 1.0 + self._rng.normal(0.0, self.load.noise_frac)
            services.append(svc_idx)
            nodes.append(node if (node >= 0 and self._node_alive[node]) else UNASSIGNED)
            cpus.append(max(per_pod, 0.0))
            mems.append(float(spec.mem_request_bytes))
            names.append(name)
        state = ClusterState.build(
            node_names=self._stable_names("_node_names_memo", self.node_names),
            node_cpu_cap=[self.node_cpu_cap_m if a else 0.0 for a in self._node_alive],
            node_mem_cap=[self.node_mem_cap_b] * len(self.node_names),
            node_alive=self._node_alive.tolist(),
            pod_services=services,
            pod_nodes=nodes,
            pod_cpu=cpus,
            pod_mem=mems,
            pod_names=self._stable_names("_pod_names_memo", names),
            node_capacity=self.node_capacity,
            pod_capacity=self.pod_capacity,
            device="cpu",
        )
        return _upload(state, self.device)

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
        if not self._node_alive[target]:
            return None
        self._arrays = None
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

    def _per_pod_cpu(self) -> np.ndarray:
        """f64[S] — each service's per-pod CPU under the load model (before
        noise); kept per (workmodel, load) and patched in place when a
        service scales."""
        load = dataclasses.astuple(self.load)
        cache = self._per_pod_cache
        if cache is None or cache[0] is not self.workmodel or cache[1] != load:
            rps = self._service_rps()
            per = np.array([self._service_pod_cpu(s, rps) for s in self.workmodel.services],
                           dtype=np.float64)
            cache = self._per_pod_cache = (self.workmodel, load, per)
        return cache[2]

    def _service_pod_cpu(self, spec, rps: dict[str, float]) -> float:
        """One pod's CPU of service ``spec``: idle plus its share of the
        service's request rate times the per-request cost."""
        return (self.load.idle_m + rps.get(spec.name, 0.0) / max(1, spec.replicas)
                * self.load.cost_per_req_m * spec.proc_cost)

    def _table_arrays(self) -> list[np.ndarray]:
        """The pod table's service and node columns as i64 arrays, kept
        while only the churn mutators run (they append to them); any other
        read of the table (:attr:`_pods`), a move or a scale-down drops
        them."""
        if self._arrays is None or self._tombstones:
            table = self._pods
            n = len(table)
            self._arrays = [np.fromiter((p[0] for p in table), dtype=np.int64, count=n),
                            np.fromiter((p[1] for p in table), dtype=np.int64, count=n)]
        return self._arrays

    def _append_pod(self, pod: list) -> None:
        """A new pod at the end of the table (and of its service's list)."""
        self._pod_table.append(pod)
        self._service_pods[pod[0]].append(pod)
        if self._arrays is not None:
            svc, node = self._arrays
            self._arrays = [np.append(svc, pod[0]), np.append(node, pod[1])]

    def _scheduler_choice(self, exclude: tuple[str, ...] = ()) -> int | None:
        """The stand-in for the default kube-scheduler: least-allocated CPU
        among the alive nodes not excluded; tie → first in node order.

        Each node's allocation adds its pods' CPU in pod-table order in f64
        (``np.bincount`` accumulates in input order), as a Python loop over
        the table would, and ``argmin`` takes the first minimum, as a loop's
        strict ``<`` would."""
        svc, node = self._table_arrays()
        placed = node >= 0
        per = self._per_pod_cpu()
        if self._cpu_spike:
            # each pod's CPU times its service's spike, in f64, before the sum
            per = per * np.array([self._cpu_spike.get(s.name, 1.0)
                                  for s in self.workmodel.services])
        used = np.bincount(node[placed], weights=per[svc[placed]],
                           minlength=len(self.node_names))
        cand = self._node_alive.copy()
        if exclude:
            cand &= np.array([name not in exclude for name in self.node_names], dtype=bool)
        if not cand.any():
            return None
        return int(np.argmin(np.where(cand, used, np.inf)))

    def apply_pod_moves(self, moves) -> dict[str, str]:
        """A batch of per-pod moves as ONE reconcile wave: one pass over the
        pod table and one clock advance (kubelets reconcile in parallel).
        Returns the moved pods as ``{pod name: landed node name}``."""
        target_of: dict[str, int] = {}
        for mv in moves:
            t = self._node_index.get(mv.target_node)
            if t is not None and self._node_alive[t] and mv.pod is not None:
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
        Returns whether the pod exists and the node is alive."""
        target = self._node_index.get(node)
        if target is None or not self._node_alive[target]:
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
        placed = [p for p in self._pods if p[1] >= 0 and self._node_alive[p[1]]]
        if not placed:
            return None
        pod = placed[rng.randrange(len(placed))]
        others = [n for i, n in enumerate(self.node_names)
                  if self._node_alive[i] and i != pod[1]]
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

    # ---- elastic topology mutators (elastic/engine.py drives these) ----

    def live_counts(self) -> dict[str, int]:
        """Live (unpadded) sizes the shape buckets quantize: services, node
        SLOTS (a drained node keeps its slot, like a Node object) and pods."""
        return {"services": len(self.workmodel.services), "nodes": len(self.node_names),
                "pods": len(self._pods)}

    def alive_node_names(self) -> list[str]:
        return [n for n, a in zip(self.node_names, self._node_alive) if bool(a)]

    def set_capacities(self, *, node: int | None = None, pod: int | None = None,
                       service: int | None = None) -> None:
        """Pin the snapshot padding: every ``monitor`` builds at these shapes
        until the churn engine promotes them."""
        if node is not None:
            self.node_capacity = node
        if pod is not None:
            self.pod_capacity = pod
        if service is not None and service != self.service_capacity:
            self.service_capacity = service
            self._graph = None

    def deploy_service(self, spec) -> None:
        """A new Deployment lands: the workmodel grows and the simulated
        scheduler places its replicas (least-allocated CPU, as for an
        ``affinityOnly`` move). No clock charge: the churn engine advances
        the clock once per round's wave."""
        if spec.name in self._svc_index:
            raise ValueError(f"service {spec.name!r} already deployed")
        self.workmodel = Workmodel(services=self.workmodel.services + (spec,),
                                   source=self.workmodel.source)
        self._refresh_workload()
        idx = self._svc_index[spec.name]
        for r in range(max(1, spec.replicas)):
            target = self._scheduler_choice()
            self._append_pod([idx, target if target is not None else UNASSIGNED,
                              f"{spec.name}-{r}"])
        self.events.append({"t": self.clock_s, "event": "deploy", "service": spec.name,
                            "replicas": max(1, spec.replicas)})

    def teardown_service(self, name: str) -> None:
        """A Deployment leaves: its pods disappear and every later service
        index compacts down by one."""
        if name not in self._svc_index:
            raise ValueError(f"service {name!r} not deployed")
        idx = self._svc_index[name]
        self.workmodel = Workmodel(
            services=tuple(s for s in self.workmodel.services if s.name != name),
            source=self.workmodel.source,
        )
        self._pods = [[s - 1 if s > idx else s, node, pname]
                      for s, node, pname in self._pods if s != idx]
        self._cpu_spike.pop(name, None)
        self._refresh_workload()
        self.events.append({"t": self.clock_s, "event": "teardown", "service": name})

    def scale_replicas(self, name: str, replicas: int) -> None:
        """Autoscale one service: scale-up places new pods through the
        simulated scheduler, scale-down removes the most recently created
        pods first. Neither the call graph nor the service index changes,
        so nothing derived is rebuilt."""
        if name not in self._svc_index:
            raise ValueError(f"service {name!r} not deployed")
        target = max(1, int(replicas))
        idx = self._svc_index[name]
        mine = self._service_pods[idx]
        cur = len(mine)
        if target == cur:
            return
        if target > cur:
            for suffix in range(cur, target):
                node = self._scheduler_choice()
                self._append_pod([idx, node if node is not None else UNASSIGNED,
                                  f"{name}-{suffix}"])
        else:
            # the table drops them at its next read (one pass for a wave)
            self._tombstones.update(id(p) for p in mine[target:])
            del mine[target:]
        old = self.workmodel
        services = list(old.services)
        services[idx] = dataclasses.replace(services[idx], replicas=target)
        self.workmodel = Workmodel(services=tuple(services), source=old.source)
        # the rates do not depend on replicas: carry them over, and patch
        # the scaled service's per-pod CPU in place
        if self._rps_cache is not None and self._rps_cache[0] is old:
            self._rps_cache = (self.workmodel, *self._rps_cache[1:])
        if self._per_pod_cache is not None and self._per_pod_cache[0] is old:
            _, load, per = self._per_pod_cache
            per[idx] = self._service_pod_cpu(services[idx], self._service_rps())
            self._per_pod_cache = (self.workmodel, load, per)
        self.events.append({"t": self.clock_s, "event": "scale", "service": name,
                            "from": cur, "to": target})

    def add_node(self, name: str) -> None:
        """A node joins the pool: a drained slot of this name revives; a new
        name grows the cluster (same uniform capacity)."""
        if name in self._node_index:
            self.revive_node(name)
            return
        self._node_index[name] = len(self.node_names)
        self.node_names.append(name)
        self._node_alive = np.append(self._node_alive, True)
        self.events.append({"t": self.clock_s, "event": "node_add", "node": name})

    def drain_node(self, name: str) -> None:
        """Cordon and drain: the node leaves the pool and its pods are
        placed again on the alive nodes (:meth:`schedule_pending`); a
        crash (:meth:`kill_node`) leaves them pending instead."""
        self.kill_node(name)
        self.schedule_pending()
        self.events.append({"t": self.clock_s, "event": "node_drain", "node": name})

    def schedule_pending(self) -> int:
        """Place every unassigned pod on the alive node with the fewest pods
        (what the kube-scheduler does for evicted pods)."""
        counts = np.zeros(len(self.node_names))
        for pod in self._pods:
            if pod[1] >= 0:
                counts[pod[1]] += 1
        counts[~self._node_alive] = np.inf
        placed = 0
        for pod in self._pods:
            if pod[1] == UNASSIGNED:
                pod[1] = int(np.argmin(counts))
                counts[pod[1]] += 1
                placed += 1
        return placed

    # ---- fault injection ----

    def inject_imbalance(self, node: str) -> None:
        """The cordon trick: pile every pod onto one node
        (reference auto_full_pipeline_repeat.sh:48-51)."""
        idx = self.node_names.index(node)
        for pod in self._pods:
            pod[1] = idx
        self.events.append({"t": self.clock_s, "event": "imbalance", "node": node})

    def kill_node(self, node: str) -> None:
        """Node failure: its capacity is gone and its pods go pending."""
        idx = self.node_names.index(node)
        self._node_alive[idx] = False
        for pod in self._pods:
            if pod[1] == idx:
                pod[1] = UNASSIGNED
        self.events.append({"t": self.clock_s, "event": "node_kill", "node": node})

    def revive_node(self, node: str) -> None:
        self._node_alive[self.node_names.index(node)] = True
        self.events.append({"t": self.clock_s, "event": "node_revive", "node": node})

    def cpu_spike(self, service: str, factor: float) -> None:
        """Multiply one service's per-pod CPU by ``factor`` (a hot spot), in
        the snapshots and in the simulated scheduler's sums."""
        self._cpu_spike[service] = factor
        self.events.append({"t": self.clock_s, "event": "cpu_spike", "service": service,
                            "factor": factor})

    def churn(self, n_restarts: int) -> None:
        """Random pod restarts onto random alive nodes (background churn),
        drawn from the simulator's seeded generator."""
        alive = np.flatnonzero(self._node_alive)
        table = self._pods
        for _ in range(n_restarts):
            pod = table[int(self._rng.integers(len(table)))]
            pod[1] = int(self._rng.choice(alive))
        self.events.append({"t": self.clock_s, "event": "churn", "n": n_restarts})
