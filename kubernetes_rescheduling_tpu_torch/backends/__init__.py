"""Cluster backends: the protocol, the hermetic simulator, and the
fault-injecting chaos wrapper over any backend."""

from kubernetes_rescheduling_tpu_torch.backends.base import (
    Backend,
    MoveRequest,
    PlacementMechanism,
    device_kind,
)
from kubernetes_rescheduling_tpu_torch.backends.chaos import (
    PROFILES as CHAOS_PROFILES,
)
from kubernetes_rescheduling_tpu_torch.backends.chaos import (
    ChaosBackend,
    ChaosError,
    ChaosProfile,
    ChaosTimeoutError,
    with_chaos,
)
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend

__all__ = [
    "Backend",
    "CHAOS_PROFILES",
    "ChaosBackend",
    "ChaosError",
    "ChaosProfile",
    "ChaosTimeoutError",
    "LoadModel",
    "MoveRequest",
    "PlacementMechanism",
    "SimBackend",
    "device_kind",
    "with_chaos",
]
