"""Victim selection: which pod (and hence which Deployment) gets moved —
the port of ``kubernetes_rescheduling_tpu.policies.victim``.

Reference semantics (delete_replaced_pod.py:41-61, 144-185): pick the
max-CPU pod on the hazard node (strict ``>`` → first max in pod order),
then delete its whole Deployment — every replica moves together.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.policies._index import first_true, take


def pick_victim(state: ClusterState, node_idx: torch.Tensor) -> torch.Tensor:
    """i64 scalar — index of the first max-CPU valid pod on ``node_idx``;
    -1 when the node has no pods (the reference skips the round,
    main.py:103-107)."""
    on_node = state.pod_valid & (state.pod_node == node_idx)
    masked = torch.where(on_node, state.pod_cpu, float("-inf"))
    victim = first_true(masked == masked.max())
    return torch.where(on_node.any(), victim, -1)


def deployment_group(state: ClusterState, pod_idx: torch.Tensor) -> torch.Tensor:
    """bool[P] — all valid pods of the same service as ``pod_idx`` (the
    unit of movement: deleting a pod's Deployment tears down every replica,
    reference delete_replaced_pod.py:173-174). Empty for ``pod_idx`` -1."""
    svc = take(state.pod_service, torch.clamp(pod_idx, 0, state.num_pods - 1))
    group = state.pod_valid & (state.pod_service == svc)
    return group & (pod_idx >= 0)
