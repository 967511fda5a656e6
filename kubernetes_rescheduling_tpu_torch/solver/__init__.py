"""The batched global assignment solvers: dense, sparse and per-pod."""

from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    GlobalSolverConfig,
    SweepPlan,
    global_assign,
    prepare_weights,
)
from kubernetes_rescheduling_tpu_torch.solver.pod_mode import (
    global_assign_pods,
    pod_level_graph,
)
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import (
    SparseSweepPlan,
    global_assign_sparse,
    sparse_layout,
    sparse_pod_comm_cost,
)

__all__ = [
    "GlobalSolverConfig",
    "SparseSweepPlan",
    "SweepPlan",
    "global_assign",
    "global_assign_pods",
    "global_assign_sparse",
    "pod_level_graph",
    "prepare_weights",
    "sparse_layout",
    "sparse_pod_comm_cost",
]
