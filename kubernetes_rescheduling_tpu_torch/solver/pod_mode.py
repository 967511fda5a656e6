"""Per-replica placement: the decision unit drops from service to pod — the
port of ``kubernetes_rescheduling_tpu.solver.pod_mode``.

Each pod becomes its own pseudo-service in an expanded sparse graph: the
service edge (s, t, w) fans out to every (pod of s, pod of t) pair at
weight w, the pair-weight semantics the service-level objective already
encodes, and capacity packs per pod. The expansion is vectorized host
numpy over a dense ``CommGraph`` or a ``SparseCommGraph``'s COO list (at
50k services no dense adjacency exists).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core import sparsegraph
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import SparseCommGraph
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.solver.global_solver import GlobalSolverConfig
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import global_assign_sparse


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


def global_assign_pods(
    state: ClusterState,
    graph: CommGraph | SparseCommGraph | None,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    pod_graph: SparseCommGraph | None = None,
    n_restarts: int = 1,
    tp: int = 1,
    plan: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """Re-place every POD independently; never worse than the input (the
    gate compares pod-level comm + balance). Pass a prebuilt ``pod_graph``
    (:func:`pod_level_graph`) to amortize the host-side expansion across
    rounds with an unchanged pod set.

    One solve on one device: ``n_restarts`` and ``tp`` above 1 (restarts
    across devices, node-axis sharding) belong to the multi-device port
    (ROADMAP Queue 1 item 5) and raise here."""
    if n_restarts > 1 or tp > 1:
        raise ValueError(
            f"n_restarts={n_restarts}, tp={tp}: restarts and tp sharding are not ported "
            "yet (ROADMAP Queue 1 item 5, multi-device); use n_restarts=1, tp=1"
        )
    if pod_graph is None:
        pod_graph = pod_level_graph(state, graph)
    # each pod is its own pseudo-service: the solver's aggregates then see
    # rv = 1, the pod's own cpu/mem, and its current node
    view = state.replace(
        pod_service=torch.arange(state.num_pods, dtype=torch.int32, device=state.device)
    )
    new_view, info = global_assign_sparse(view, pod_graph, generator, config, plan=plan)
    info = dict(info, restarts=torch.tensor(1))
    return state.replace(pod_node=new_view.pod_node), info
