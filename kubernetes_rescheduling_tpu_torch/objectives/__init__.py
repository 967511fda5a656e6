"""Objective metrics as tensor reductions."""

from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    capacity_violation,
    communication_cost,
    load_std,
)

__all__ = ["communication_cost", "load_std", "capacity_violation"]
