"""The unified placement-scoring kernel — the port of
``kubernetes_rescheduling_tpu.policies.scoring``.

All five reference strategies (reference rescheduling.py:77-218) pick a node
by masked **lexicographic argmax** over policy-specific keys:

| policy          | keys (maximize, in order)            | reference         |
|-----------------|--------------------------------------|-------------------|
| spread          | -pod_count, -lex_rank                | rescheduling.py:101 |
| binpack         | rounded cpu_pct, +lex_rank           | rescheduling.py:133 |
| random          | Gumbel noise (uniform over cands)    | rescheduling.py:153 |
| kubescheduling  | free-CPU fraction (least-allocated)  | rescheduling.py:159-171 (a model of kube-scheduler's default) |
| communication   | related-pod count, remaining CPU     | rescheduling.py:188-214 |

Every policy first excludes hazard nodes (reference rescheduling.py:42-55,
86-87, 92-93, 189-190). The ``random`` policy's noise row is an argument
(drawn by the caller from its round's generator), where the JAX package
passes a key.
"""

from __future__ import annotations

from typing import Sequence

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.objectives.metrics import node_cpu_pct_rounded
from kubernetes_rescheduling_tpu_torch.policies._index import first_true

POLICY_NAMES: tuple[str, ...] = (
    "spread",
    "binpack",
    "random",
    "kubescheduling",
    "communication",
)
POLICY_IDS: dict[str, int] = {name: i for i, name in enumerate(POLICY_NAMES)}


def lex_argmax(keys: Sequence[torch.Tensor], mask: torch.Tensor) -> torch.Tensor:
    """i64 scalar — index of the masked lexicographic maximum of ``keys``.
    Ties after the last key resolve to the lowest index (the reference's
    first-max-wins loops); -1 when the mask is empty."""
    winners = mask
    for k in keys:
        kf = k.float()
        best = torch.where(winners, kf, float("-inf")).max()
        winners = winners & (kf == best)
    return torch.where(mask.any(), first_true(winners), -1)


def node_features(
    state: ClusterState, graph: CommGraph, service_idx: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Every per-node feature a policy needs. ``affinity`` is CAR's score:
    the pods on each node whose service talks to ``service_idx`` (reference
    rescheduling.py:188-195), a row of the graph times the occupancy matrix
    — an f32 product outside any kernel (TF32 is off in the port)."""
    occ = state.service_node_counts(graph.num_services)                        # f32[S, N]
    rel_row = (graph.adj.index_select(0, service_idx.reshape(1).long()) > 0).float()
    cap = state.node_cpu_cap
    free = state.node_cpu_free()
    return {
        "pod_count": state.node_pod_count(),
        "cpu_pct_rounded": node_cpu_pct_rounded(state).float(),
        "cpu_free": free,
        "free_frac": torch.where(cap > 0, free / torch.where(cap > 0, cap, 1.0), 0.0),
        "affinity": (rel_row @ occ)[0],
        "lex_rank": state.node_lex_rank.float(),
    }


def policy_key_table(
    f: dict[str, torch.Tensor], state: ClusterState, gumbel: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-policy key rows ``(k1, k2)``, each f32[len(POLICY_NAMES), N]:
    policy ``p`` picks the masked lexicographic argmax of ``(k1[p], k2[p])``.
    ``gumbel`` is the ``random`` policy's noise row (zeros when None)."""
    g = gumbel if gumbel is not None else torch.zeros_like(f["cpu_free"])
    zero = torch.zeros_like(g)
    k1 = torch.stack([-f["pod_count"], f["cpu_pct_rounded"], g, f["free_frac"], f["affinity"]])
    k2 = torch.stack([-f["lex_rank"], f["lex_rank"], zero, zero, f["cpu_free"]])
    return k1, k2


def policy_scores(
    policy_id: int,
    state: ClusterState,
    graph: CommGraph,
    service_idx: torch.Tensor,
    hazard_mask: torch.Tensor,
    gumbel: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The active policy's scoring rows ``(k1, k2, cand)``: primary key,
    tie-break key and the candidate mask (valid and not hazardous)."""
    f = node_features(state, graph, service_idx)
    cand = state.node_valid & ~hazard_mask
    k1, k2 = policy_key_table(f, state, gumbel)
    pid = min(max(int(policy_id), 0), len(POLICY_NAMES) - 1)
    return k1[pid], k2[pid], cand


def choose_node(
    policy_id: int,
    state: ClusterState,
    graph: CommGraph,
    service_idx: torch.Tensor,
    hazard_mask: torch.Tensor,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """i64 scalar — the target node for ``service_idx``'s Deployment; -1
    when every valid node is hazardous (the reference raises there,
    rescheduling.py:98-99; the caller skips)."""
    k1, k2, cand = policy_scores(policy_id, state, graph, service_idx, hazard_mask, gumbel)
    return lex_argmax([k1, k2], cand)
