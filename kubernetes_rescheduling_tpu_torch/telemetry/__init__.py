"""Metrics registry and transfer accounting of the control loop."""

from kubernetes_rescheduling_tpu_torch.telemetry.accounting import (
    count_reconcile,
    pull,
    timed_call,
)
from kubernetes_rescheduling_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

__all__ = [
    "MetricsRegistry",
    "count_reconcile",
    "get_registry",
    "pull",
    "timed_call",
]
