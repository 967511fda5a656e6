"""The scoring policy a greedy round uses — the part of
``kubernetes_rescheduling_tpu.policies.proactive`` that every reactive
round calls. ``proactive`` itself (CAR against the forecast-predicted
state, ``predicted_state``) waits for the forecast plane and is refused by
``RescheduleConfig.validate``."""

from __future__ import annotations

from kubernetes_rescheduling_tpu_torch.policies.scoring import POLICY_IDS

PROACTIVE = "proactive"


def scoring_policy(algorithm: str, base_policy: str = "communication") -> str:
    """The greedy policy whose key rows a round scores with: ``proactive``
    delegates to its base policy (the JAX package's
    ``ForecastConfig.base_policy``, reactive CAR by default); every other
    algorithm scores as itself."""
    return base_policy if algorithm == PROACTIVE else algorithm


def scoring_policy_id(algorithm: str, base_policy: str = "communication") -> int:
    return POLICY_IDS[scoring_policy(algorithm, base_policy)]
