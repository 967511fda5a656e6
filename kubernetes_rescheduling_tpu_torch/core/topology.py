"""Scenarios and initial cluster states — the port of
``kubernetes_rescheduling_tpu.core.topology``: the reference's own µBench
setup (:func:`mubench_scenario`), the dense, power-law and north-star
(10k × 1k) synthetic meshes, and the cordon-style imbalance.

Generation is host-side numpy with the same ``default_rng(seed)`` call
sequence as the JAX package, so one seed gives the identical instance in
both packages; only the finished arrays become tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.core.workmodel import (
    ServiceSpec,
    Workmodel,
    mubench_workmodel_c,
)


@dataclass(frozen=True)
class Scenario:
    """A ready-to-run benchmark scenario: state + communication graph."""

    name: str
    state: ClusterState
    graph: CommGraph


def state_from_workmodel(
    wm: Workmodel,
    *,
    node_names: list[str] | None = None,
    node_cpu_cap_m: float = 20_000.0,
    node_mem_cap_b: float = 32 * 1024**3,
    pod_cpu_m: float | None = None,
    all_on_node: int | None = None,
    seed: int = 0,
    node_capacity: int | None = None,
    pod_capacity: int | None = None,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> ClusterState:
    """Instantiate a cluster state from a workmodel: each service
    contributes ``replicas`` pods, placed uniformly at random, or all on one
    node when ``all_on_node`` is given."""
    node_names = node_names or ["worker1", "worker2", "worker3"]
    rng = np.random.default_rng(seed)
    services: list[int] = []
    cpus: list[float] = []
    mems: list[float] = []
    pnames: list[str] = []
    for idx, svc in enumerate(wm.services):
        for r in range(svc.replicas):
            services.append(idx)
            cpus.append(float(pod_cpu_m if pod_cpu_m is not None else svc.cpu_request_millicores))
            mems.append(float(svc.mem_request_bytes))
            pnames.append(f"{svc.name}-{r}")
    n_pods = len(services)
    if all_on_node is not None:
        nodes = [all_on_node] * n_pods
    else:
        nodes = rng.integers(0, len(node_names), size=n_pods).tolist()
    return ClusterState.build(
        node_names=node_names,
        node_cpu_cap=[node_cpu_cap_m] * len(node_names),
        node_mem_cap=[node_mem_cap_b] * len(node_names),
        pod_services=services,
        pod_nodes=nodes,
        pod_cpu=cpus,
        pod_mem=mems,
        pod_names=pnames,
        node_capacity=node_capacity,
        pod_capacity=pod_capacity,
        device=device,
    )


def inject_imbalance(state: ClusterState, node_index: int = 0) -> ClusterState:
    """Move every valid pod onto one node — the reference's cordon-induced
    'Before' state (reference auto_full_pipeline_repeat.sh:48-51)."""
    return state.replace(
        pod_node=torch.where(state.pod_valid, node_index, state.pod_node).to(state.pod_node.dtype)
    )


def mubench_scenario(
    *, imbalanced: bool = True, seed: int = 0,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> Scenario:
    """The reference's own setup: 20 µBench services on 3 workers of
    20 cores and 32 GB (reference README.md:44-46), everything initially on
    worker1 unless ``imbalanced`` is off."""
    dev = resolve_device(device)
    wm = mubench_workmodel_c()
    state = state_from_workmodel(
        wm,
        all_on_node=0 if imbalanced else None,
        seed=seed,
        node_cpu_cap_m=20_000.0,
        node_mem_cap_b=32 * 1024**3,
        device=dev,
    )
    return Scenario(name="mubench-workmodelC", state=state, graph=wm.comm_graph(device=dev))


def _random_workmodel(
    n_services: int,
    rng: np.random.Generator,
    *,
    powerlaw: bool,
    mean_degree: float = 4.0,
    replicas: int = 1,
    cpu_m: int = 100,
) -> Workmodel:
    # Call direction is earlier→later service (each new service i is called
    # by k existing services j < i), so s0 is the call-graph root.
    if powerlaw:
        # Barabási–Albert-style preferential attachment: sampling uniformly
        # from the endpoint list is degree-proportional sampling.
        m = max(1, int(round(mean_degree / 2)))
        targets: list[list[str]] = [[] for _ in range(n_services)]
        endpoints: list[int] = [0]
        for i in range(1, n_services):
            k = min(i, m)
            picks: set[int] = set()
            draws = rng.integers(0, len(endpoints), size=4 * k + 8)
            for d in draws:
                picks.add(endpoints[d])
                if len(picks) >= k:
                    break
            while len(picks) < k:  # rare fallback: fill uniformly
                picks.add(int(rng.integers(0, i)))
            for j in picks:
                targets[j].append(f"s{i}")
                endpoints.append(j)
                endpoints.append(i)
    else:
        # Dense Erdős–Rényi mesh, plus one guaranteed caller per service so
        # the whole mesh stays reachable from the s0 entry.
        p = min(1.0, mean_degree / max(1, n_services - 1))
        targets = [[] for _ in range(n_services)]
        for i in range(1, n_services):
            called = False
            for j in range(i):
                if rng.random() < p:
                    targets[j].append(f"s{i}")
                    called = True
            if not called:
                targets[int(rng.integers(0, i))].append(f"s{i}")
    services = tuple(
        ServiceSpec(
            name=f"s{i}",
            callees=tuple(targets[i]),
            cpu_request_millicores=cpu_m,
            replicas=replicas,
        )
        for i in range(n_services)
    )
    return Workmodel(services=services, source="synthetic")


def synthetic_scenario(
    *,
    n_pods: int,
    n_nodes: int,
    powerlaw: bool = False,
    replicas: int = 1,
    mean_degree: float = 6.0,
    seed: int = 0,
    imbalance_frac: float = 0.25,
    node_cpu_cap_m: float = 20_000.0,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> Scenario:
    """Synthetic service meshes at increasing scale. ``n_pods = n_services
    * replicas``; the initial placement is random with a fraction of pods
    piled on the first node."""
    dev = resolve_device(device)
    if n_pods % replicas:
        raise ValueError("n_pods must be divisible by replicas")
    n_services = n_pods // replicas
    rng = np.random.default_rng(seed)
    wm = _random_workmodel(
        n_services, rng, powerlaw=powerlaw, mean_degree=mean_degree, replicas=replicas
    )
    node_names = [f"worker{i:04d}" for i in range(n_nodes)]
    state = state_from_workmodel(
        wm,
        node_names=node_names,
        node_cpu_cap_m=node_cpu_cap_m,
        seed=seed,
        device=dev,
    )
    if imbalance_frac > 0:
        k = int(n_pods * imbalance_frac)
        mask = torch.zeros(state.num_pods, dtype=torch.bool, device=dev)
        mask[:k] = True
        state = state.replace(
            pod_node=torch.where(mask, 0, state.pod_node).to(state.pod_node.dtype)
        )
    kind = "powerlaw" if powerlaw else "dense"
    return Scenario(
        name=f"synthetic-{kind}-{n_pods}x{n_nodes}",
        state=state,
        graph=wm.comm_graph(device=dev),
    )


def dense_200x20(seed: int = 0, device: str | torch.device | None = DEFAULT_DEVICE) -> Scenario:
    return synthetic_scenario(
        n_pods=200, n_nodes=20, powerlaw=False, mean_degree=8.0, seed=seed, device=device
    )


def powerlaw_2000x200(seed: int = 0, device: str | torch.device | None = DEFAULT_DEVICE) -> Scenario:
    return synthetic_scenario(
        n_pods=2000, n_nodes=200, powerlaw=True, mean_degree=4.0, seed=seed, device=device
    )


def large_10000x1000(seed: int = 0, device: str | torch.device | None = DEFAULT_DEVICE) -> Scenario:
    """The north-star scale — 10k pods / 1k nodes with CPU headroom tight
    enough that capacity constraints bind."""
    return synthetic_scenario(
        n_pods=10_000,
        n_nodes=1_000,
        powerlaw=True,
        mean_degree=4.0,
        seed=seed,
        # ~10 pods/node avg at 100m each; 2000m caps keep feasibility tight
        node_cpu_cap_m=2_000.0,
        device=device,
    )
