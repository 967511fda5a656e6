"""Objective metrics as tensor reductions — the port of
``kubernetes_rescheduling_tpu.objectives.metrics`` used by the global round.
"""

from __future__ import annotations

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
