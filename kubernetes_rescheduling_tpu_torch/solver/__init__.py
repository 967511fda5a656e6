"""The batched global assignment solver."""

from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    GlobalSolverConfig,
    SweepPlan,
    global_assign,
    prepare_weights,
)

__all__ = ["GlobalSolverConfig", "SweepPlan", "global_assign", "prepare_weights"]
