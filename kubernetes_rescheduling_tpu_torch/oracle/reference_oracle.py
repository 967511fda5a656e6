"""Dict-world oracle with the reference's exact decision semantics — the
port's own copy of ``kubernetes_rescheduling_tpu.oracle.reference_oracle``.

A clean-room re-statement of the *behavior* documented in SURVEY.md §2/§3
(with ``file:line`` citations below), written against the snapshot schema
of the reference. It gives every device decision a slow, obviously-correct
host twin to test against, including the tie-break subtleties:

- hazard detection uses the **rounded** cpu_pct the monitor stores
  (reference get_resource_usage.py:37, harzard_detect.py:12) and picks the
  first max in node order (reference harzard_detect.py:24, dict-insertion
  order = node list order);
- spread minimizes (pod count, node name) (reference rescheduling.py:101);
- binpack maximizes (cpu_pct, node name) (reference rescheduling.py:133);
- CAR maximizes related-pod count, tie → max remaining CPU with strict ``>``
  so the first max in node order wins (reference rescheduling.py:199-214);
- victim = first max-CPU pod on the hazard node in pod-list order
  (reference delete_replaced_pod.py:47-57);
- comm cost collapses a deployment to the node of its last-listed pod and
  counts absent peers as cross-node (reference communicationcost.py:22-45).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph


@dataclass
class PodInfo:
    name: str
    service: str
    node: str
    cpu: float
    mem: float
    index: int


@dataclass
class Snapshot:
    """Dict-world cluster snapshot (schema of reference podmonitor.py:17-37)."""

    nodes_name: list[str]
    pods: list[PodInfo]
    cluster: dict[str, dict]  # per-node: cpu/mem cap+usage+pct and pod list


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_snapshot(state: ClusterState, graph: CommGraph) -> Snapshot:
    """Convert a tensor state (on any device) to the dict world the oracle
    reasons in."""
    node_valid = _host(state.node_valid)
    pod_valid = _host(state.pod_valid)
    pod_node = _host(state.pod_node)
    pod_service = _host(state.pod_service)
    pod_cpu = _host(state.pod_cpu)
    pod_mem = _host(state.pod_mem)
    cpu_cap = _host(state.node_cpu_cap)
    mem_cap = _host(state.node_mem_cap)
    cpu_used = _host(state.node_cpu_used())
    mem_used = _host(state.node_mem_used())

    nodes_name = [n for i, n in enumerate(state.node_names) if node_valid[i]]
    pods: list[PodInfo] = []
    for i in range(len(pod_node)):
        if not pod_valid[i] or pod_node[i] < 0:
            continue
        pods.append(
            PodInfo(
                name=state.pod_names[i] if i < len(state.pod_names) else f"pod{i}",
                service=graph.names[pod_service[i]],
                node=state.node_names[pod_node[i]],
                cpu=float(pod_cpu[i]),
                mem=float(pod_mem[i]),
                index=i,
            )
        )

    cluster: dict[str, dict] = {}
    for i, name in enumerate(state.node_names):
        if not node_valid[i]:
            continue
        pct = (
            int(round(cpu_used[i] / cpu_cap[i] * 100)) if cpu_cap[i] else -1
        )  # rounded, as stored by the monitor (reference get_resource_usage.py:37)
        mem_pct = int(round(mem_used[i] / mem_cap[i] * 100)) if mem_cap[i] else -1
        cluster[name] = {
            "node_cpu_capacity": float(cpu_cap[i]),
            "node_cpu_usage": float(cpu_used[i]),
            "cpu_pct": pct,
            "node_mem_capacity": float(mem_cap[i]),
            "node_mem_usage": float(mem_used[i]),
            "mem_pct": mem_pct,
            "pods": [
                {
                    "podname": p.name,
                    "deploymentname": p.service,
                    "pod_cpu_usage": p.cpu,
                    "pod_mem_usage": p.mem,
                }
                for p in pods
                if p.node == name
            ],
        }
    return Snapshot(nodes_name=nodes_name, pods=pods, cluster=cluster)


def detection(
    snapshot: Snapshot, threshold: float = 30.0
) -> tuple[str, list[str]]:
    """Hazard nodes (rounded cpu_pct >= threshold) + first-max pick
    (reference harzard_detect.py:3-27)."""
    hazard = [
        n for n in snapshot.nodes_name if snapshot.cluster[n]["cpu_pct"] >= threshold
    ]
    most = ""
    if hazard:
        best = None
        for n in hazard:  # max() over dict → first max in insertion order
            pct = snapshot.cluster[n]["cpu_pct"]
            if best is None or pct > snapshot.cluster[best]["cpu_pct"]:
                best = n
        most = best
    return most, hazard


def pick_max_pod(snapshot: Snapshot, node: str) -> PodInfo | None:
    """First max-CPU pod on ``node`` in pod-list order
    (reference delete_replaced_pod.py:41-61, strict ``>``)."""
    best: PodInfo | None = None
    best_cpu = -1.0
    for p in snapshot.pods:
        if p.node != node:
            continue
        if p.cpu > best_cpu:
            best = p
            best_cpu = p.cpu
    return best


def _candidates(snapshot: Snapshot, hazard: list[str]) -> list[str]:
    cands = [n for n in snapshot.nodes_name if n not in hazard]
    if not cands:
        raise RuntimeError("No candidate nodes available (all nodes are hazardous).")
    return cands


def choose_spread(snapshot: Snapshot, hazard: list[str]) -> str:
    """Min pod count, tie → lexicographic-min name (reference rescheduling.py:89-103)."""
    cands = _candidates(snapshot, hazard)
    return min(cands, key=lambda n: (len(snapshot.cluster[n]["pods"]), n))


def choose_binpack(snapshot: Snapshot, hazard: list[str]) -> str:
    """Max cpu_pct, tie → lexicographic-max name (reference rescheduling.py:121-135)."""
    cands = _candidates(snapshot, hazard)
    return max(cands, key=lambda n: (snapshot.cluster[n]["cpu_pct"], n))


def choose_random(
    snapshot: Snapshot, hazard: list[str], rng: np.random.Generator
) -> str:
    """Uniform over non-hazard nodes (reference rescheduling.py:149-153).
    Parity with the device decision is distribution-level (SURVEY.md §7)."""
    cands = _candidates(snapshot, hazard)
    return cands[int(rng.integers(len(cands)))]


def choose_kubescheduling(snapshot: Snapshot, hazard: list[str]) -> str:
    """OUR model of the default kube-scheduler (the reference only patches
    anti-affinity and lets kube-scheduler place — reference
    rescheduling.py:159-171): least-allocated scoring — max remaining CPU
    fraction, tie → first in node order. The device kernel implements the
    same model, so this oracle is self-consistency, not reference parity."""
    cands = _candidates(snapshot, hazard)
    best, best_free = None, -np.inf
    for n in cands:
        c = snapshot.cluster[n]
        cap = c["node_cpu_capacity"]
        free = (cap - c["node_cpu_usage"]) / cap if cap else 0.0
        if free > best_free:
            best, best_free = n, free
    return best


def choose_communication(
    snapshot: Snapshot,
    relation: dict[str, list[str]],
    service: str,
    hazard: list[str],
) -> str:
    """CAR: max related-pod count per node; tie → max remaining CPU, strict
    ``>`` so the first max in node order wins (reference rescheduling.py:183-216)."""
    rel = relation.get(service, [])
    score: dict[str, int] = {}
    for n in snapshot.nodes_name:
        if n in hazard:
            continue
        score[n] = sum(
            1 for pod in snapshot.cluster[n]["pods"] if pod["deploymentname"] in rel
        )
    if not score:
        raise RuntimeError("No candidate nodes available (all nodes are hazardous).")
    max_score = max(score.values())
    best_nodes = [n for n, s in score.items() if s == max_score]
    if len(best_nodes) > 1:
        target, best_free = None, -1.0
        for n in best_nodes:
            c = snapshot.cluster[n]
            free = c["node_cpu_capacity"] - c["node_cpu_usage"]
            if free > best_free:
                target, best_free = n, free
        return target
    return best_nodes[0]


def communication_cost(
    snapshot: Snapshot, relation: dict[str, list[str]]
) -> float:
    """Deployment-level cross-node edges / 2, last pod wins, absent peer
    counts as cross-node (reference communicationcost.py:6-49)."""
    dep_node: dict[str, str] = {}
    for p in snapshot.pods:  # later pods overwrite — "last pod wins"
        dep_node[p.service] = p.node
    cost = 0
    for dep, node in dep_node.items():
        for rel in relation.get(dep, []):
            if node != dep_node.get(rel):
                cost += 1
    return cost / 2


def node_std(snapshot: Snapshot) -> float:
    """Population std of unrounded CPU % over nodes with cap > 0
    (reference nodemonitor.py:24-49)."""
    pcts = [
        c["node_cpu_usage"] / c["node_cpu_capacity"] * 100.0
        for c in snapshot.cluster.values()
        if c["node_cpu_capacity"] > 0
    ]
    return float(np.std(pcts)) if pcts else 0.0
