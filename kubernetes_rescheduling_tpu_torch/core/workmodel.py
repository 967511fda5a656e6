"""µBench workmodel: ordered services plus the derived communication graph —
the part of ``kubernetes_rescheduling_tpu.core.workmodel`` that the
scenarios need (pure Python, no tensors until :meth:`Workmodel.comm_graph`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE
from kubernetes_rescheduling_tpu_torch.core.state import CommGraph


@dataclass(frozen=True)
class ServiceSpec:
    """One service from a workmodel: name, callees, resource requests,
    replicas, and the relative per-request processing cost."""

    name: str
    callees: tuple[str, ...] = ()
    cpu_request_millicores: int = 100
    mem_request_bytes: int = 0
    replicas: int = 1
    proc_cost: float = 1.0


@dataclass(frozen=True)
class Workmodel:
    """Parsed workmodel: ordered services + derived communication graph."""

    services: tuple[ServiceSpec, ...]
    source: str = "<memory>"

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.services)

    def directed_relation(self) -> dict[str, list[str]]:
        """The raw (directed) call graph: ``{caller: [callees]}``."""
        return {s.name: list(s.callees) for s in self.services}

    def relation(self) -> dict[str, list[str]]:
        """Undirected closure of the call graph, each neighbor list ordered
        by global service index."""
        rel: dict[str, set[str]] = {s.name: set(s.callees) for s in self.services}
        for s in self.services:
            for callee in s.callees:
                rel.setdefault(callee, set()).add(s.name)
        order = {name: i for i, name in enumerate(self.names)}
        return {
            name: sorted(rel.get(name, ()), key=lambda n: order.get(n, len(order)))
            for name in self.names
        }

    def comm_graph(
        self,
        capacity: int | None = None,
        device: str | torch.device | None = DEFAULT_DEVICE,
    ) -> CommGraph:
        return CommGraph.from_relation(
            self.relation(), capacity=capacity, names=list(self.names), device=device
        )


def kahn_traversal(
    relation: Mapping[str, Sequence[str]], names: Sequence[str]
) -> tuple[list[str], list[tuple[str, str]]]:
    """Cycle-broken topological traversal of a directed call graph.

    Returns ``(order, edges)``: a processing order covering every service,
    and the kept caller→callee edges. Edges that would close a cycle are
    dropped (visit-once on the node at pop time); services left in a cyclic
    remainder are appended in name order with the same edge-keeping rule.
    """
    names = list(names)
    index = set(names)
    indeg = {n: 0 for n in names}
    for src, dsts in relation.items():
        for d in dsts:
            if d in indeg:
                indeg[d] += 1
    ready = [n for n in names if indeg[n] == 0]
    order: list[str] = []
    done: set[str] = set()
    edges: list[tuple[str, str]] = []
    while ready:
        svc = ready.pop()
        if svc in done:
            continue
        done.add(svc)
        order.append(svc)
        for callee in relation.get(svc, []):
            if callee not in index or callee in done:
                continue  # cycle-closing edge: drop
            edges.append((svc, callee))
            indeg[callee] -= 1
            if indeg[callee] == 0:
                ready.append(callee)
    for svc in names:  # cyclic remainder (indeg never hit 0), name order
        if svc in done:
            continue
        done.add(svc)
        order.append(svc)
        for callee in relation.get(svc, []):
            if callee in index and callee not in done:
                edges.append((svc, callee))
    return order, edges


def propagate_entry_rate(
    workmodel: Workmodel,
    *,
    entry_service: str,
    entry_rps: float,
    fanout_frac: float = 1.0,
) -> dict[str, float]:
    """Propagate an entry request rate through the directed call graph:
    each request to a service triggers ``fanout_frac`` requests to each
    callee, accumulated in the cycle-broken order of :func:`kahn_traversal`."""
    rps = {name: 0.0 for name in workmodel.names}
    if entry_service not in rps:
        return rps
    rps[entry_service] = float(entry_rps)
    order, edges = kahn_traversal(workmodel.directed_relation(), workmodel.names)
    out_edges: dict[str, list[str]] = {}
    for s, d in edges:
        out_edges.setdefault(s, []).append(d)
    for svc in order:
        for callee in out_edges.get(svc, ()):
            rps[callee] += rps[svc] * fanout_frac
    return rps
