"""Cluster backends: the hermetic simulator's construction and monitor."""

from kubernetes_rescheduling_tpu_torch.backends.sim import LoadModel, SimBackend

__all__ = ["LoadModel", "SimBackend"]
