"""Objective metrics as tensor reductions — the port of
``kubernetes_rescheduling_tpu.objectives.metrics`` used by the global round
and the control loop: the communication cost (dense quadratic form, and the
edge-list form the round end reads), the load spread, and the rounded CPU
percent that hazard detection compares.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph

# rows of the [S, S] quadratic form contracted at a time: bounds the
# temporaries to ROW_BLOCK × S floats instead of several S² matrices
ROW_BLOCK = 2048


def communication_cost(state: ClusterState, graph: CommGraph) -> torch.Tensor:
    """Cross-node communicating pod pairs, weighted by the comm graph:

        cost = 1/2 · Σ_{i,j} adj[i,j] · (#cross-node pod pairs of services i,j)

    as the masked quadratic form over the service×node occupancy matrix,
    contracted in row blocks. The summation order differs from the JAX
    package's single contraction; the value is exact for integer weights
    and counts below 2^24."""
    num_s = graph.num_services
    occ = state.service_node_counts(num_s)          # f32[S, N]
    tot = occ.sum(dim=1)                            # f32[S]
    valid = graph.service_valid.float()
    total = torch.zeros((), dtype=torch.float32, device=occ.device)
    for r0 in range(0, num_s, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, num_s)
        same = occ[r0:r1] @ occ.T                   # same-node pod pairs
        cross = tot[r0:r1, None] * tot[None, :] - same
        adj = graph.adj[r0:r1] * valid[r0:r1, None] * valid[None, :]
        total = total + torch.sum(adj * cross)
    return 0.5 * total


def comm_edge_list(graph: CommGraph):
    """Host-side: the masked adjacency's upper-triangle nonzero edges as
    ``(src i64[E], dst i64[E], w f32[E])`` tensors on the graph's device —
    the static structure :func:`communication_cost_edges` contracts.

    E is padded up to the next power of two (floor 8) with zero-weight
    self-edges, as in the JAX package (a padding row adds ``0·cross``).
    Build once per graph and reuse."""
    adj = graph.adj.cpu().numpy()
    valid = graph.service_valid.cpu().numpy()
    masked = adj * valid[:, None] * valid[None, :]
    src, dst = np.nonzero(np.triu(masked, k=1))
    w = masked[src, dst].astype(np.float32)
    cap = 8
    while cap < src.size:
        cap *= 2
    pad = cap - src.size
    src = np.concatenate([src, np.zeros(pad, np.int64)])
    dst = np.concatenate([dst, np.zeros(pad, np.int64)])
    w = np.concatenate([w, np.zeros(pad, np.float32)])
    dev = graph.device
    return (
        torch.as_tensor(src, device=dev),
        torch.as_tensor(dst, device=dev),
        torch.as_tensor(w, device=dev),
    )


def communication_cost_edges(state: ClusterState, num_services: int, edges) -> torch.Tensor:
    """:func:`communication_cost` contracted over a precomputed edge list
    (:func:`comm_edge_list`): Σ_{i<j} w_ij·(tot_i·tot_j − occ_i·occ_j), in
    O(E·N) instead of O(S²·N). Equal to the dense form for integer weights
    and counts below 2^24; in general the two sum in different orders."""
    src, dst, w = edges
    occ = state.service_node_counts(num_services)        # f32[S, N]
    tot = occ.sum(dim=1)                                 # f32[S]
    cross = tot[src] * tot[dst] - torch.sum(occ[src] * occ[dst], dim=1)
    return torch.sum(w * cross)


def node_cpu_pct_rounded(state: ClusterState) -> torch.Tensor:
    """i32[N] — ``int(round(pct))`` per node, -1 for invalid or zero-capacity
    nodes (reference get_resource_usage.py:37). ``torch.round`` rounds half
    to even, like Python's ``round`` and ``jnp.round``."""
    rounded = torch.round(state.node_cpu_pct()).to(torch.int32)
    return torch.where(state.node_valid & (state.node_cpu_cap > 0), rounded, -1)


def load_std(state: ClusterState) -> torch.Tensor:
    """Population std-dev of CPU-usage % over valid nodes with cap > 0."""
    pct = state.node_cpu_pct()
    mask = state.node_valid & (state.node_cpu_cap > 0)
    n = torch.clamp_min(mask.sum(), 1)
    mean = torch.sum(torch.where(mask, pct, 0.0)) / n
    var = torch.sum(torch.where(mask, (pct - mean) ** 2, 0.0)) / n
    return torch.sqrt(var)


def capacity_violation(state: ClusterState) -> torch.Tensor:
    """Total millicores of CPU over-subscription (0 when feasible)."""
    over = torch.clamp_min(state.node_cpu_used() - state.node_cpu_cap, 0.0)
    return torch.sum(torch.where(state.node_valid, over, 0.0))
