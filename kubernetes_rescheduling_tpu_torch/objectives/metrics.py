"""Objective metrics as tensor reductions — the port of
``kubernetes_rescheduling_tpu.objectives.metrics``: the communication cost
(dense quadratic form, and the edge-list form the round end reads with
attribution off), the reference's deployment-level cost, the load spread,
the rounded CPU percent that hazard detection compares, and the cost
attribution bundle (:func:`communication_cost_attribution`) the round end
carries with attribution on.

The S×S products are plain ``torch.matmul`` in f32 (TF32 stays off, as the
package sets at import), contracted in row blocks of ``ROW_BLOCK``
services so the working set stays a few ``ROW_BLOCK × S`` temporaries
instead of several S² matrices. The attribution's top-k reads nothing back
to the host, so it runs inside a captured scan block.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph

# rows of the [S, S] quadratic form contracted at a time: bounds the
# temporaries to ROW_BLOCK × S floats instead of several S² matrices
ROW_BLOCK = 2048


def _masked_adj_rows(graph: CommGraph, valid: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    return graph.adj[r0:r1] * valid[r0:r1, None] * valid[None, :]


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
        adj = _masked_adj_rows(graph, valid, r0, r1)
        total = total + torch.sum(adj * cross)
    return 0.5 * total


def comm_edge_list(graph: CommGraph):
    """Host-side: the masked adjacency's upper-triangle nonzero edges as
    ``(src i64[E], dst i64[E], w f32[E])`` tensors on the graph's device —
    the static structure :func:`communication_cost_edges` contracts.

    Found on the graph's device (``torch.nonzero``, row-major like
    ``np.nonzero``; one host read of the edge count), so a churned graph of
    16,384² weights is not copied to the host. E is padded up to the next
    power of two (floor 8) with zero-weight self-edges, as in the JAX
    package (a padding row adds ``0·cross``). Build once per graph and
    reuse."""
    valid = graph.service_valid
    masked = graph.adj * valid[:, None] * valid[None, :]
    idx = torch.nonzero(torch.triu(masked, diagonal=1))
    src, dst = idx[:, 0], idx[:, 1]
    w = masked[src, dst].float()
    cap = 8
    while cap < src.numel():
        cap *= 2
    pad = cap - src.numel()
    zeros = torch.zeros(pad, dtype=torch.int64, device=graph.device)
    return (
        torch.cat([src, zeros]),
        torch.cat([dst, zeros]),
        torch.cat([w, torch.zeros(pad, dtype=torch.float32, device=graph.device)]),
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


def communication_cost_deployment(state: ClusterState, graph: CommGraph) -> torch.Tensor:
    """Deployment-level cost, exactly the reference's accounting: each
    Deployment collapses to ONE node — the node of whichever of its pods was
    listed last (communicationcost.py:22-37), here its highest-indexed
    valid pod — then cross-node relation edges / 2, an edge to an absent
    peer counting as cross-node (communicationcost.py:42-43)."""
    num_s = graph.num_services
    p = state.num_pods
    dev = state.pod_node.device
    svc = torch.where(state.pod_valid, state.pod_service.long(), num_s)
    svc = torch.where((svc >= 0) & (svc <= num_s), svc, num_s)
    idx = torch.where(state.pod_valid, torch.arange(p, device=dev), -1)
    last = torch.full((num_s + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, svc, idx, reduce="amax")[:num_s]
    has_pod = last >= 0
    svc_node = torch.where(has_pod, state.pod_node.long()[torch.clamp(last, 0, p - 1)], -1)
    diff = svc_node[:, None] != svc_node[None, :]
    present = has_pod[:, None] & has_pod[None, :]
    valid = graph.service_valid.float()
    adj = graph.adj * valid[:, None] * valid[None, :]
    absent_peer = has_pod[:, None] & ~has_pod[None, :]
    return 0.5 * torch.sum(adj * ((diff & present) | absent_peer))


def max_cpu_pct(state: ClusterState) -> torch.Tensor:
    """The hottest valid node's CPU-usage percent."""
    return torch.max(torch.where(state.node_valid, state.node_cpu_pct(), -torch.inf))


def objective_summary(state: ClusterState, graph: CommGraph) -> dict[str, torch.Tensor]:
    """All objectives at once (for telemetry)."""
    return {
        "communication_cost": communication_cost(state, graph),
        "load_std": load_std(state),
        "capacity_violation": capacity_violation(state),
        "max_cpu_pct": max_cpu_pct(state),
    }


def node_pair_cost_matrix(state: ClusterState, graph: CommGraph) -> torch.Tensor:
    """f32[N, N] — the communication cost decomposed over node pairs:
    ``M[a, b] = Σ_{i,j} adj[i,j]·occ[i,a]·occ[j,b]`` with the diagonal
    zeroed (same-node pairs carry no cost), so ``0.5·ΣM ==
    communication_cost``. Contracted in row blocks: ``Σ_blocks
    occ[blk]ᵀ·(adj[blk]·occ)``."""
    num_s = graph.num_services
    occ = state.service_node_counts(num_s)
    valid = graph.service_valid.float()
    n = state.num_nodes
    m = torch.zeros((n, n), dtype=torch.float32, device=occ.device)
    for r0 in range(0, num_s, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, num_s)
        m = m + occ[r0:r1].T @ (_masked_adj_rows(graph, valid, r0, r1) @ occ)
    return m * (1.0 - torch.eye(n, dtype=m.dtype, device=m.device))


# the order key of the attribution top-k: an f32 value's bits above the
# complement of its flat index, so one int64 top-k ranks values descending
# and equal values by ascending index (lax.top_k's order) with no ties
_IDX_BITS = 2 ** 32
_IDX_MASK = _IDX_BITS - 1


def _order_keys(vals: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is ``vals`` descending, ties by
    ascending ``flat_idx``: exact for every non-negative finite value
    (``-inf`` and negatives rank below them all)."""
    bits = vals.contiguous().view(torch.int32).long()
    return bits * _IDX_BITS + (_IDX_MASK - flat_idx)


def _key_values(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert :func:`_order_keys`: ``(f32 values, i64 flat indices)``."""
    vals = (keys >> 32).to(torch.int32).view(torch.float32)
    return vals, _IDX_MASK - (keys & _IDX_MASK)


def attribution_parts(state: ClusterState, graph: CommGraph, *, top_k: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(communication_cost, attribution bundle)`` in one pass over the row
    blocks: the scalar is :func:`communication_cost`'s, by the same
    operations in the same order (bit for bit), and the bundle is
    :func:`communication_cost_attribution`'s."""
    num_s = graph.num_services
    n = state.num_nodes
    occ = state.service_node_counts(num_s)               # f32[S, N]
    tot = occ.sum(dim=1)                                 # f32[S]
    valid = graph.service_valid.float()
    dev = occ.device
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    m = torch.zeros((n, n), dtype=torch.float32, device=dev)
    k = max(1, min(int(top_k), num_s * num_s))
    col = torch.arange(num_s, device=dev)
    cand = []
    for r0 in range(0, num_s, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, num_s)
        same = occ[r0:r1] @ occ.T
        cross = tot[r0:r1, None] * tot[None, :] - same
        adj = _masked_adj_rows(graph, valid, r0, r1)
        contrib = adj * cross                            # f32[R, S]
        cost = cost + torch.sum(contrib)
        m = m + occ[r0:r1].T @ (adj @ occ)
        rows = torch.arange(r0, r1, device=dev)
        # unordered pairs once: the strict upper triangle
        vals = torch.where(col[None, :] > rows[:, None], contrib, -torch.inf)
        keys = _order_keys(vals, rows[:, None] * num_s + col[None, :]).reshape(-1)
        cand.append(torch.topk(keys, min(k, keys.numel())).values)
    cost = 0.5 * cost
    m = m * (1.0 - torch.eye(n, dtype=m.dtype, device=dev))
    total = 0.5 * torch.sum(m)
    top_v, top_i = _key_values(torch.topk(torch.cat(cand), k).values)
    src = top_i // num_s
    dst = top_i % num_s
    ok = torch.isfinite(top_v) & (top_v > 0)
    # the dominant cross-node placement of each edge: the first (a != b)
    # node pair holding the most communicating replica pairs
    pair = occ[src][:, :, None] * occ[dst][:, None, :]   # f32[k, N, N]
    pair = (pair * (1.0 - torch.eye(n, dtype=pair.dtype, device=dev))).reshape(k, n * n)
    flat = torch.argmax(pair, dim=1)
    has = torch.amax(pair, dim=1) > 0
    a = torch.where(has, flat // n, -1)
    b = torch.where(has, flat % n, -1)
    neg = torch.full_like(src, -1)
    rows_out = torch.stack([
        torch.where(ok, src, neg).float(),
        torch.where(ok, dst, neg).float(),
        torch.where(ok, a, neg).float(),
        torch.where(ok, b, neg).float(),
        torch.where(ok, top_v, 0.0),
    ], dim=1)                                            # f32[k, 5]
    tail = total - torch.sum(torch.where(ok, top_v, 0.0))
    bundle = torch.cat([torch.stack([total, tail]), rows_out.reshape(-1), m.reshape(-1)])
    return cost, bundle


def communication_cost_attribution(state: ClusterState, graph: CommGraph, *, top_k: int = 8
                                   ) -> torch.Tensor:
    """The on-device cost decomposition: everything the host needs to
    attribute ``communication_cost`` to service edges and node pairs, as ONE
    flat f32 tensor (it rides the round's single ``round_end`` transfer).

    Layout (k = min(top_k, S·S), N = num_nodes)::

        [0]                total      — 0.5·ΣM == communication_cost
        [1]                tail       — total − Σ(top-k edge costs)
        [2 : 2+5k]         edge rows  — k×(src_service, dst_service,
                                       src_node, dst_node, cost); index
                                       slots are −1 on empty rows
        [2+5k : 2+5k+N·N]  M          — the node-pair matrix, row-major

    Edges are unordered service pairs ranked by their contribution
    ``adj[i,j]·cross_pairs(i,j)``, equal contributions by ascending flat
    index ``i·S + j`` (``lax.top_k``'s order: each row block keeps its k
    best keys and one more top-k merges the blocks by the same rule).
    ``src_node`` / ``dst_node`` are the edge's dominant cross-node pair, the
    first maximum as ``torch.argmax`` documents it. The row blocks sum in
    another order than the JAX package's single contraction: the floats are
    exact for integer weights and counts below 2^24."""
    return attribution_parts(state, graph, top_k=top_k)[1]
