"""Hazard (overload) detection — the port of
``kubernetes_rescheduling_tpu.policies.hazard``.

Reference semantics (harzard_detect.py:3-27): a node is hazardous when the
monitor's **rounded** CPU percent (reference get_resource_usage.py:37) is
>= threshold (default 30); the "most hazardous" node is the first max in
node order (Python ``max`` over a dict keeps insertion order on ties).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.objectives.metrics import node_cpu_pct_rounded
from kubernetes_rescheduling_tpu_torch.policies._index import first_true

_INT32_MIN = -(2**31)


def detect_hazard(
    state: ClusterState, threshold: float = 30.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(most_hazard, hazard_mask)``: the first most-loaded
    hazardous node (i64 scalar, -1 when none) and bool[N], True for every
    node at or over the threshold."""
    pct = node_cpu_pct_rounded(state)  # i32[N], -1 for invalid/zero-cap
    # compared in float32, so a fractional threshold (30.9) is not truncated
    hazard_mask = state.node_valid & (pct.float() >= float(np.float32(threshold)))
    masked = torch.where(hazard_mask, pct, _INT32_MIN)
    most = first_true(masked == masked.max())
    return torch.where(hazard_mask.any(), most, -1), hazard_mask
