"""The batched global assignment solvers (dense, sparse and per-pod) and
the greedy round loop."""

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
from kubernetes_rescheduling_tpu_torch.solver.fleet import fleet_metrics, fleet_solve, stack_tenants
from kubernetes_rescheduling_tpu_torch.solver.round_loop import RoundTelemetry, round_step, run_rounds
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import (
    SparseSweepPlan,
    global_assign_sparse,
    sparse_layout,
    sparse_pod_comm_cost,
)

__all__ = [
    "GlobalSolverConfig",
    "RoundTelemetry",
    "SparseSweepPlan",
    "SweepPlan",
    "fleet_metrics",
    "fleet_solve",
    "global_assign",
    "global_assign_pods",
    "global_assign_sparse",
    "pod_level_graph",
    "prepare_weights",
    "round_step",
    "run_rounds",
    "sparse_layout",
    "sparse_pod_comm_cost",
    "stack_tenants",
]
