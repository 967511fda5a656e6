"""Placement policies: hazard detection, victim selection and the unified
scoring kernel of the five reference strategies."""

from kubernetes_rescheduling_tpu_torch.policies.hazard import detect_hazard
from kubernetes_rescheduling_tpu_torch.policies.scoring import (
    POLICY_IDS,
    POLICY_NAMES,
    choose_node,
    lex_argmax,
    node_features,
)
from kubernetes_rescheduling_tpu_torch.policies.victim import deployment_group, pick_victim

__all__ = [
    "POLICY_IDS",
    "POLICY_NAMES",
    "choose_node",
    "deployment_group",
    "detect_hazard",
    "lex_argmax",
    "node_features",
    "pick_victim",
]
