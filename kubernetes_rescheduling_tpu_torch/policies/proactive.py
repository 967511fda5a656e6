"""The ``proactive`` algorithm: reactive CAR's decision, one window ahead —
the port of ``kubernetes_rescheduling_tpu.policies.proactive``.

``proactive`` keeps the greedy machinery (hazard detection → victim →
``policy_scores`` → masked lex argmax) but runs it against the PREDICTED
next-window state: the online forecaster (``forecast/``) supplies a
per-node load delta, and ``solver.round_loop.decide_with_forecast`` /
``decide_explain_with_forecast`` fold it into ``node_base_cpu`` before
scoring. The policy it scores with is its base policy (reactive CAR's
``communication`` by default): the forecast moves the state the policy
sees, not the policy.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS

PROACTIVE = "proactive"


def scoring_policy(algorithm: str, forecast_cfg=None) -> str:
    """The greedy policy whose key rows a round scores with: ``proactive``
    delegates to ``forecast_cfg.base_policy`` (reactive CAR when no config
    is given); every other algorithm scores as itself."""
    if algorithm == PROACTIVE:
        return forecast_cfg.base_policy if forecast_cfg is not None else "communication"
    return algorithm


def scoring_policy_id(algorithm: str, forecast_cfg=None) -> int:
    return POLICY_IDS[scoring_policy(algorithm, forecast_cfg)]


def predicted_state(state: ClusterState, delta: torch.Tensor) -> ClusterState:
    """The next-window state the proactive decision is taken on: the observed
    state with the per-node load ``delta`` folded into ``node_base_cpu``,
    so hazard detection and every load-derived score see predicted loads.
    A zero delta (cold start, the skill gate, invalid slots) changes no
    value: adding 0.0 reproduces the reactive state bit for bit."""
    delta = torch.as_tensor(delta, dtype=torch.float32, device=state.node_base_cpu.device)
    return state.replace(node_base_cpu=state.node_base_cpu + delta)
