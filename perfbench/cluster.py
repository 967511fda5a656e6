"""A deployment from its configuration and a seed: the call graph, the
initial placement and the call rates.

The benchmark makes these inputs itself and hands the same ones to the
port and to the plain reference. The call graph is the configuration's:
drawn from its own ``call_graph.seed`` by the power-law generator the
port's ``large`` scenario uses (Barabási–Albert-style preferential
attachment, the same ``default_rng`` call sequence, kept here so the
yardstick does not move with the program). A run's seed relabels the
services by a permutation, so every seed brings the same graph, and with
the traffic keyed to the graph's own pairs (``base_index``) the same work,
in another order. NumPy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MASK63 = (1 << 63) - 1


def stream(seed: int, purpose: int) -> np.random.Generator:
    """An independent NumPy stream for one purpose of a run's seed (any
    whole number: taken modulo 2**63)."""
    return np.random.default_rng([int(seed) & MASK63, purpose])


def torch_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & MASK63, purpose])
    return int(ss.generate_state(1, np.uint64)[0]) & MASK63


@dataclass(frozen=True)
class Deployment:
    """Services ``s0 … s{S-1}`` (one Deployment each), ``callees[i]`` the
    services ``s_i`` calls (the graph is acyclic), ``ii``/``jj`` the
    undirected pairs ``(i, j)``, ``i < j``, sorted row-major (``np.nonzero``
    order of the upper triangle), and the cluster's sizes."""

    services: int
    nodes: int
    callees: tuple[tuple[int, ...], ...]
    entry: int      # the service external requests enter at
    ii: np.ndarray  # i64[E]
    jj: np.ndarray  # i64[E]
    node_cpu_m: float
    node_mem_bytes: float
    pod_cpu_m: float
    pod_mem_bytes: float
    label: np.ndarray      # i64[S]: the service the graph's ``i`` became
    base_keys: np.ndarray  # i64[E]: the graph's own pairs ``i·S + j``, sorted


def base_index(dep: Deployment, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """i64[E]: for each pair ``(a[e], b[e])`` of relabeled services, its
    index among the graph's own pairs, the same in every run."""
    inv = np.empty_like(dep.label)
    inv[dep.label] = np.arange(dep.services)
    x, y = inv[np.asarray(a)], inv[np.asarray(b)]
    keys = np.minimum(x, y) * dep.services + np.maximum(x, y)
    idx = np.searchsorted(dep.base_keys, keys)
    if not np.array_equal(dep.base_keys[np.minimum(idx, len(dep.base_keys) - 1)], keys):
        raise ValueError("a pair that the call graph does not have")
    return idx


def powerlaw_callees(n: int, m: int, rng: np.random.Generator):
    """Preferential attachment: service ``i`` is called by ``m`` earlier
    services drawn in proportion to degree."""
    targets: list[list[int]] = [[] for _ in range(n)]
    endpoints: list[int] = [0]
    for i in range(1, n):
        k = min(i, m)
        picks: set[int] = set()
        draws = rng.integers(0, len(endpoints), size=4 * k + 8)
        for d in draws:
            picks.add(endpoints[d])
            if len(picks) >= k:
                break
        while len(picks) < k:
            picks.add(int(rng.integers(0, i)))
        for j in picks:
            targets[j].append(i)
            endpoints.append(j)
            endpoints.append(i)
    return tuple(tuple(t) for t in targets)


def undirected_edges(n: int, callees) -> tuple[np.ndarray, np.ndarray]:
    pairs = {(min(a, b), max(a, b)) for a, cs in enumerate(callees) for b in cs if a != b}
    arr = np.array(sorted(pairs), dtype=np.int64).reshape(-1, 2)
    return arr[:, 0].copy(), arr[:, 1].copy()


def build(config: dict, seed: int) -> Deployment:
    graph = config["call_graph"]
    if graph["kind"] != "powerlaw":
        raise ValueError(f"unknown call graph kind {graph['kind']!r}")
    if config["replicas"] != 1:
        raise ValueError("the benchmark's deployments run one pod a service")
    n = int(config["services"])
    base = powerlaw_callees(n, int(graph["callers_per_service"]),
                            np.random.default_rng(int(graph["seed"])))
    label = stream(seed, 0).permutation(n)
    callees: list[tuple[int, ...]] = [()] * n
    for i, cs in enumerate(base):
        callees[label[i]] = tuple(int(label[c]) for c in cs)
    ii, jj = undirected_edges(n, callees)
    bi, bj = undirected_edges(n, base)
    entry = int(label[int(config["load_model"]["entry_service"])])
    return Deployment(n, int(config["nodes"]), tuple(callees), entry, ii, jj,
                      float(config["node_cpu_m"]),
                      float(config["node_mem_bytes"]), float(config["pod_cpu_m"]),
                      float(config["pod_mem_bytes"]), label, bi * n + bj)


def random_placement(dep: Deployment, seed: int) -> np.ndarray:
    """i64[S]: each service's pod on a node drawn uniformly."""
    return stream(seed, 1).integers(0, dep.nodes, size=dep.services)


def entry_rates(dep: Deployment, entry: int, entry_rps: float, fanout_frac: float) -> np.ndarray:
    """f64[S] request rates: the entry rate propagated down the call graph,
    each request to a service sending ``fanout_frac`` requests to each
    callee, over the edges a cycle-broken traversal keeps (callers before
    callees; the generator's graph is acyclic, so every edge is kept)."""
    n = dep.services
    indeg = np.zeros(n, dtype=np.int64)
    for cs in dep.callees:
        for c in cs:
            indeg[c] += 1
    ready = [i for i in range(n) if indeg[i] == 0]
    done = np.zeros(n, dtype=bool)
    order: list[int] = []
    kept: list[tuple[int, int]] = []
    while ready:
        s = ready.pop()
        if done[s]:
            continue
        done[s] = True
        order.append(s)
        for c in dep.callees[s]:
            if done[c]:
                continue
            kept.append((s, c))
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if not done.all():
        raise ValueError("the call graph has a cycle")
    out: dict[int, list[int]] = {}
    for s, c in kept:
        out.setdefault(s, []).append(c)
    rps = np.zeros(n, dtype=np.float64)
    rps[entry] = float(entry_rps)
    for s in order:
        for c in out.get(s, ()):
            rps[c] += rps[s] * fanout_frac
    return rps


def pair_rates(dep: Deployment, a: np.ndarray, b: np.ndarray, load: dict) -> np.ndarray:
    """f64[E]: the call rate of each undirected pair ``(a[e], b[e])`` (its
    caller's request rate times ``fanout_frac``), scaled to a mean of 1."""
    fanout = float(load["fanout_frac"])
    rps = entry_rates(dep, dep.entry, float(load["entry_rps"]), fanout)
    rate = {}
    for s, cs in enumerate(dep.callees):
        for c in cs:
            key = (min(s, c), max(s, c))
            rate[key] = rate.get(key, 0.0) + rps[s] * fanout
    out = np.array([rate[(min(x, y), max(x, y))] for x, y in zip(a.tolist(), b.tolist())])
    return out / out.mean()
