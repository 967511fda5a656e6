"""Tensor cluster state, workload models, topologies."""

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph

__all__ = ["ClusterState", "CommGraph"]
