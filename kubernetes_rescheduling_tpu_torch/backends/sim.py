"""Hermetic cluster simulator — the port of
``kubernetes_rescheduling_tpu.backends.sim``: the load model, the
backend's construction (its seeded initial placement), ``comm_graph`` and
``monitor``. Moves, faults, dead nodes and churn wait for a later slice,
so every node is alive and every pod placed.

All bookkeeping is host-side Python and numpy; ``monitor`` hands out a
fresh padded :class:`ClusterState` on the backend's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel, propagate_entry_rate


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
    ``ClusterState`` on ``device``."""

    workmodel: Workmodel
    node_names: list[str]
    node_cpu_cap_m: float = 20_000.0
    node_mem_cap_b: float = 32 * 1024**3
    load: LoadModel = field(default_factory=LoadModel)
    seed: int = 0
    device: str | torch.device | None = DEFAULT_DEVICE

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._rng = np.random.default_rng(self.seed)
        n = len(self.node_names)
        # pod table: (service_idx, node_idx, name); deployment = service
        self._pods: list[list] = []
        for idx, svc in enumerate(self.workmodel.services):
            for r in range(svc.replicas):
                node = int(self._rng.integers(0, n))
                self._pods.append([idx, node, f"{svc.name}-{r}"])
        self._graph = self.workmodel.comm_graph(device=self.device)

    def comm_graph(self) -> CommGraph:
        return self._graph

    def monitor(self) -> ClusterState:
        """Snapshot with load-model CPU usage."""
        rps = self.load.service_rps(self.workmodel)
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
            node_names=list(self.node_names),
            node_cpu_cap=[self.node_cpu_cap_m] * len(self.node_names),
            node_mem_cap=[self.node_mem_cap_b] * len(self.node_names),
            pod_services=services,
            pod_nodes=nodes,
            pod_cpu=cpus,
            pod_mem=mems,
            pod_names=names,
            device=self.device,
        )
