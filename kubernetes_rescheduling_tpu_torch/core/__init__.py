"""Tensor cluster state, workload models, topologies."""

from kubernetes_rescheduling_tpu_torch.core.quantities import cpu_to_millicores, mem_to_bytes
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import SparseCommGraph
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph

__all__ = ["ClusterState", "CommGraph", "SparseCommGraph", "cpu_to_millicores", "mem_to_bytes"]
