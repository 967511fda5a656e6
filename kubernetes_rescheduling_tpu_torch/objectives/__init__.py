"""Objective metrics as tensor reductions."""

from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    capacity_violation,
    comm_edge_list,
    communication_cost,
    communication_cost_attribution,
    communication_cost_deployment,
    communication_cost_edges,
    load_std,
    node_cpu_pct_rounded,
    node_pair_cost_matrix,
    objective_summary,
)

__all__ = [
    "capacity_violation",
    "comm_edge_list",
    "communication_cost",
    "communication_cost_attribution",
    "communication_cost_deployment",
    "communication_cost_edges",
    "load_std",
    "node_cpu_pct_rounded",
    "node_pair_cost_matrix",
    "objective_summary",
]
