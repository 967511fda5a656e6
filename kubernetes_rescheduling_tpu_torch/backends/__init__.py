"""Cluster backends: the protocol, the hermetic simulator, the
fault-injecting chaos wrapper over any backend, the replay backend that
serves a recorded trace (shadow mode) and the live-Kubernetes adapter."""

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
from kubernetes_rescheduling_tpu_torch.backends.fleet import FleetBackend, make_fleet
from kubernetes_rescheduling_tpu_torch.backends.k8s import K8sBackend
from kubernetes_rescheduling_tpu_torch.backends.replay import ReplayBackend
from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend

__all__ = [
    "Backend",
    "CHAOS_PROFILES",
    "ChaosBackend",
    "ChaosError",
    "ChaosProfile",
    "ChaosTimeoutError",
    "FleetBackend",
    "K8sBackend",
    "LoadModel",
    "MoveRequest",
    "PlacementMechanism",
    "ReplayBackend",
    "SimBackend",
    "device_kind",
    "make_fleet",
    "with_chaos",
]
