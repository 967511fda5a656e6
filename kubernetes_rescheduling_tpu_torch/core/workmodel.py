"""µBench workmodel: ordered services plus the derived communication graph —
the port of ``kubernetes_rescheduling_tpu.core.workmodel`` (pure Python, no
tensors until :meth:`Workmodel.comm_graph`): the in-memory model, the
µBench JSON parser (:meth:`Workmodel.from_dict` / :meth:`Workmodel.from_file`)
and the reference's own s0–s19 topology (:func:`mubench_workmodel_c`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Sequence

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE
from kubernetes_rescheduling_tpu_torch.core.quantities import cpu_to_millicores, mem_to_bytes
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

    @classmethod
    def from_dict(cls, data: Mapping[str, Any], source: str = "<memory>") -> "Workmodel":
        """Parse a µBench workmodel dict: service name → stanza, with
        ``external_services`` groups of callee names, ``cpu-requests`` /
        ``memory-requests`` quantities, optional ``replicas``, and the
        ``internal_service.loader.cpu_stress`` parameters behind
        ``proc_cost``. Entries whose value is not a mapping are skipped."""
        services = []
        for name, stanza in data.items():
            if not isinstance(stanza, Mapping):
                continue
            callees: list[str] = []
            for group in stanza.get("external_services", []) or []:
                for callee in group.get("services", []) or []:
                    if callee != name and callee not in callees:
                        callees.append(callee)
            services.append(
                ServiceSpec(
                    name=name,
                    callees=tuple(callees),
                    cpu_request_millicores=cpu_to_millicores(stanza.get("cpu-requests", "100m")),
                    mem_request_bytes=mem_to_bytes(stanza.get("memory-requests", "0")),
                    replicas=int(stanza.get("replicas", 1)),
                    proc_cost=_parse_proc_cost(stanza),
                )
            )
        return cls(services=tuple(services), source=source)

    @classmethod
    def from_file(cls, path: str | Path) -> "Workmodel":
        p = Path(path)
        return cls.from_dict(json.loads(p.read_text()), source=str(p))


# the builtin workmodelC loader: 100 complexity × 10 trials / 1 thread —
# proc_cost is normalized so that stanza scores 1.0
_BASELINE_STRESS = 100.0 * 10.0


def _parse_proc_cost(stanza: Mapping[str, Any]) -> float:
    """Relative per-request CPU cost from a stanza's cpu_stress:
    ``mean(range_complexity) · trials / thread_pool_size`` over the builtin
    loader's. No loader keeps 1.0; a disabled one (``run: false``) gets the
    floor 0.05."""
    stress = _get_path(stanza, "internal_service", "loader", "cpu_stress")
    if not isinstance(stress, Mapping):
        return 1.0
    if not stress.get("run", True):
        return 0.05
    rc = stress.get("range_complexity", [100, 100]) or [100, 100]
    try:
        complexity = (float(rc[0]) + float(rc[-1])) / 2.0
    except (TypeError, ValueError, IndexError):
        complexity = 100.0
    trials = float(stress.get("trials", 10) or 10)
    threads = max(float(stress.get("thread_pool_size", 1) or 1), 1.0)
    return max(complexity * trials / threads / _BASELINE_STRESS, 0.05)


def _get_path(obj: Any, *names: str):
    for name in names:
        if not isinstance(obj, Mapping):
            return None
        obj = obj.get(name)
    return obj


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


def mubench_workmodel_c() -> Workmodel:
    """The reference's s0–s19 topology: the directed call graph whose
    undirected closure is the dict at reference main.py:31-52 (from
    workmodelC.json ``external_services``). Every service requests 100m."""
    edges: dict[str, tuple[str, ...]] = {
        "s0": ("s1", "s3", "s7", "s16"),
        "s1": ("s2", "s4", "s13", "s15"),
        "s3": ("s5", "s6", "s8", "s9", "s12"),
        "s5": ("s14",),
        "s6": ("s10", "s17"),
        "s7": ("s19",),
        "s9": ("s11",),
        "s15": ("s18",),
    }
    services = tuple(
        ServiceSpec(name=f"s{i}", callees=edges.get(f"s{i}", ()), cpu_request_millicores=100)
        for i in range(20)
    )
    return Workmodel(services=services, source="builtin:workmodelC")
