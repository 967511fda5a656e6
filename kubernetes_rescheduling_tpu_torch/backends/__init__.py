"""Cluster backends: the protocol and the hermetic simulator."""

from kubernetes_rescheduling_tpu_torch.backends.base import (
    Backend,
    MoveRequest,
    PlacementMechanism,
    device_kind,
)
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend

__all__ = [
    "Backend",
    "LoadModel",
    "MoveRequest",
    "PlacementMechanism",
    "SimBackend",
    "device_kind",
]
