"""Per-replica placement: the decision unit drops from service to pod — the
port of ``kubernetes_rescheduling_tpu.solver.pod_mode``.

Each pod becomes its own pseudo-service in an expanded sparse graph: the
service edge (s, t, w) fans out to every (pod of s, pod of t) pair at
weight w, the pair-weight semantics the service-level objective already
encodes, and capacity packs per pod. The expansion is vectorized host
numpy over a dense ``CommGraph`` or a ``SparseCommGraph``'s COO list (at
50k services no dense adjacency exists).

A controller sees call rates per service pair, not per pod pair: the
per-pod streaming replay (``bench/trace.py``) takes one weight a call pair
in :func:`call_pairs` order and fans it out to the pod pairs through
:func:`pod_pair_calls`, each pod pair's call pair.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core import sparsegraph
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import SparseCommGraph
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig


def _pods_by_service(state: ClusterState, S: int):
    """Valid pod ids grouped by service: ``(pid, starts, counts)`` where
    service s's pods are ``pid[starts[s] : starts[s] + counts[s]]``."""
    svc = state.pod_service.cpu().numpy()
    valid = state.pod_valid.cpu().numpy()
    pid = np.flatnonzero(valid & (svc >= 0) & (svc < S))
    order = np.argsort(svc[pid], kind="stable")
    pid = pid[order]
    svs = svc[pid]
    starts = np.searchsorted(svs, np.arange(S))
    counts = np.searchsorted(svs, np.arange(S), side="right") - starts
    return pid, starts, counts


def pod_level_graph(
    state: ClusterState, graph: CommGraph | SparseCommGraph
) -> SparseCommGraph:
    """Expand a service-level graph to a pod-level ``SparseCommGraph`` on
    the state's device: one pseudo-service per pod index (padding pods are
    isolated invalid services); every service edge fans out to the pods'
    cross product."""
    P = state.num_pods
    if isinstance(graph, SparseCommGraph):
        S = graph.num_services
        src_s = graph.edges_src.cpu().numpy()
        dst_s = graph.edges_dst.cpu().numpy()
        wts = graph.edges_w.cpu().numpy()
        perm = graph.perm.cpu().numpy()
        # canonical undirected edges (each edge is stored twice)
        und = src_s < dst_s
        iu = perm[src_s[und]]
        ju = perm[dst_s[und]]
        w = wts[und].astype(np.float64)
    else:
        S = graph.num_services
        adj = graph.adj.cpu().numpy()
        iu, ju = np.nonzero(np.triu(adj[:S, :S], k=1))
        w = adj[iu, ju].astype(np.float64)

    pid, starts, counts = _pods_by_service(state, S)
    ca = counts[iu]
    cb = counts[ju]
    m = ca * cb
    keep = m > 0
    iu, ju, w, ca, cb, m = (x[keep] for x in (iu, ju, w, ca, cb, m))
    off = np.concatenate([[0], np.cumsum(m)])
    total = int(off[-1])
    # pair r of edge e is (pod r // cb of s, pod r % cb of t)
    eidx = np.repeat(np.arange(len(m)), m)
    r = np.arange(total) - off[eidx]
    src = pid[starts[iu][eidx] + r // cb[eidx]]
    dst = pid[starts[ju][eidx] + r % cb[eidx]]
    return sparsegraph.from_edges(
        src, dst, w[eidx], P,
        names=tuple(state.pod_names) if state.pod_names else (),
        device=state.device,
    )


def call_pairs(graph: CommGraph | SparseCommGraph) -> tuple[np.ndarray, np.ndarray]:
    """The graph's undirected call pairs ``(i, j)``, ``i < j`` in service
    ids, sorted row-major: i64 ``(ii, jj)``, the order of the per-call-pair
    weights a pod replay takes."""
    S = graph.num_services
    if isinstance(graph, SparseCommGraph):
        perm = graph.perm.cpu().numpy().astype(np.int64)
        a = perm[graph.edges_src.cpu().numpy()]
        b = perm[graph.edges_dst.cpu().numpy()]
        keys = np.unique(a[a < b] * S + b[a < b])
        return keys // S, keys % S
    ii, jj = np.nonzero(np.triu(graph.adj.cpu().numpy()[:S, :S], k=1))
    return ii.astype(np.int64), jj.astype(np.int64)


def pod_pair_calls(state: ClusterState, pod_graph: SparseCommGraph, ii, jj,
                   num_services: int) -> np.ndarray:
    """i64[E2]: for each entry of a pod-level graph's COO list (in its
    order; :func:`pod_level_graph` built on ``state``'s pods), the index
    of its call pair among ``(ii, jj)`` (:func:`call_pairs`)."""
    S = int(num_services)
    svc = state.pod_service.cpu().numpy().astype(np.int64)
    perm = pod_graph.perm.cpu().numpy().astype(np.int64)
    a = svc[perm[pod_graph.edges_src.cpu().numpy()]]
    b = svc[perm[pod_graph.edges_dst.cpu().numpy()]]
    keys = np.minimum(a, b) * S + np.maximum(a, b)
    call_keys = np.asarray(ii, dtype=np.int64) * S + np.asarray(jj, dtype=np.int64)
    idx = np.searchsorted(call_keys, keys)
    if not np.array_equal(call_keys[np.minimum(idx, len(call_keys) - 1)], keys):
        raise ValueError("a pod pair whose services are not a call pair of the graph")
    return idx


def global_assign_pods(
    state: ClusterState,
    graph: CommGraph | SparseCommGraph | None,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    pod_graph: SparseCommGraph | None = None,
    n_restarts: int = 1,
    tp: int = 1,
    mesh=None,
    plan: list | None = None,
    plans: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """Re-place every POD independently; never worse than the input (the
    gate compares pod-level comm + balance). Pass a prebuilt ``pod_graph``
    (:func:`pod_level_graph`) to amortize the host-side expansion across
    rounds with an unchanged pod set.

    ``n_restarts`` / ``tp`` / ``mesh`` route through the same production
    entry as the service-level solves
    (``parallel.solve_with_restarts(sparse_graph=...)``): best-of-N
    restarts, node-axis sharding over ``tp`` ranks and their composition
    all run on the pod graph. ``plan`` is the single solve's plan list,
    ``plans`` one plan list per restart."""
    from kubernetes_rescheduling_tpu_torch.parallel.sharded import solve_with_restarts

    if pod_graph is None:
        pod_graph = pod_level_graph(state, graph)
    # each pod is its own pseudo-service: the solver's aggregates then see
    # rv = 1, the pod's own cpu/mem, and its current node
    view = state.replace(
        pod_service=torch.arange(state.num_pods, dtype=torch.int32, device=state.device)
    )
    new_view, info = solve_with_restarts(
        view, None, generator, n_restarts=n_restarts, config=config, mesh=mesh, tp=tp,
        sparse_graph=pod_graph, plans=[plan] if plan is not None else plans,
    )
    return state.replace(pod_node=new_view.pod_node), info
