"""The multi-round rescheduling control loop — the port of
``kubernetes_rescheduling_tpu.solver.round_loop``.

Reference semantics (main.py:56-112), per round: monitor → hazard detection
→ pick the max-CPU pod on the most-hazardous node → delete its Deployment
(all replicas) → choose a target node with the active policy → re-create
the Deployment there. Rounds with no hazard, no movable pod, or no
candidate node are no-ops. The JAX package's deliberate fixes hold here
too: the deleted Deployment's pods leave the snapshot before scoring, a
skipped round never crashes the loop, and when every node is hazardous the
Deployment is kept.

The JAX package runs the rounds as one ``lax.scan``; here
:func:`run_rounds` is a plain loop over rounds whose tensors stay on the
device — no round reads a value back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch._random import gumbel as draw_gumbel
from kubernetes_rescheduling_tpu_torch._random import round_generator
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    communication_cost,
    load_std,
    node_cpu_pct_rounded,
)
from kubernetes_rescheduling_tpu_torch.policies._index import take
from kubernetes_rescheduling_tpu_torch.policies.hazard import detect_hazard
from kubernetes_rescheduling_tpu_torch.policies.scoring import (
    POLICY_IDS,
    lex_argmax,
    policy_scores,
)
from kubernetes_rescheduling_tpu_torch.policies.victim import deployment_group, pick_victim


@dataclass(frozen=True)
class RoundTelemetry:
    """Per-round record (a leading rounds axis after :func:`run_rounds`)."""

    moved: torch.Tensor            # bool — did a deployment move this round
    most_hazard: torch.Tensor      # node index, -1 = cluster stable
    victim: torch.Tensor           # pod index, -1 = none
    service: torch.Tensor          # service index of the moved deployment
    target: torch.Tensor           # target node index, -1 = none
    communication_cost: torch.Tensor  # f32, after the round
    load_std: torch.Tensor            # f32, after the round


def finite_guard(state: ClusterState) -> ClusterState:
    """A non-finite or negative pod load collapses to 0 and a non-finite
    base load to 0 before any score reads them (NaN compares false
    everywhere and would freeze a round); clean inputs pass unchanged."""
    def nn(x):
        return torch.where(torch.isfinite(x) & (x >= 0.0), x, 0.0)

    def fin(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    return state.replace(
        pod_cpu=nn(state.pod_cpu),
        pod_mem=nn(state.pod_mem),
        node_base_cpu=fin(state.node_base_cpu),
        node_base_mem=fin(state.node_base_mem),
    )


def _decide_scored(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    threshold: float,
    gumbel: torch.Tensor | None,
) -> tuple[ClusterState, tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """The decision shared by :func:`decide` and :func:`decide_explain`:
    the guarded state, ``(most_hazard, hazard_mask, victim, service,
    target)`` and the policy's ``(k1, k2, cand)`` rows it was taken from."""
    state = finite_guard(state)
    most, hazard_mask = detect_hazard(state, threshold)
    victim = torch.where(most >= 0, pick_victim(state, most), -1)
    group = deployment_group(state, victim)
    svc = take(state.pod_service, torch.clamp(victim, 0, state.num_pods - 1))
    removed = state.replace(
        pod_node=torch.where(group, UNASSIGNED, state.pod_node).to(state.pod_node.dtype)
    )
    k1, k2, cand = policy_scores(policy_id, removed, graph, svc, hazard_mask, gumbel)
    target = torch.where(victim >= 0, lex_argmax([k1, k2], cand), -1)
    return state, (most, hazard_mask, victim, svc, target), (k1, k2, cand)


def decide(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    threshold: float,
    gumbel: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-round decision, shared by :func:`run_rounds` and the
    controller: hazard detection → victim → policy choice.

    Returns ``(most_hazard, hazard_mask, victim, service, target)`` as
    device tensors, the scalars -1 on the no-op paths. Scoring runs on the
    snapshot with the victim Deployment's pods removed (the foreground
    cascade delete completes first, reference delete_replaced_pod.py:173-177).
    ``gumbel`` is the ``random`` policy's noise row."""
    return _decide_scored(state, graph, policy_id, threshold, gumbel)[1]


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of ``x`` and their indices, descending,
    ties to the lower index (``lax.top_k``'s order; ``torch.topk`` promises
    none among ties, so this is a stable sort)."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def decide_explain(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    threshold: float,
    gumbel: torch.Tensor | None = None,
    *,
    top_k: int = 3,
) -> tuple[torch.Tensor, ...]:
    """:func:`decide` plus a compact explanation bundle, from the same
    ``policy_scores`` rows the decision was taken from. The extra output is
    one f32[6, k] tensor (k = min(top_k, N)) that rides the round's single
    host read:

    - rows 0-1: top-k hazard — node index, CPU percent (-inf where fewer
      valid nodes exist);
    - rows 2-4: top-k candidate targets by primary score — node index,
      primary score ``k1``, tie-break ``k2``;
    - row 5: 1.0 where the slot is a real candidate.

    The chosen node is always among the recorded candidates (the last slot
    is overwritten when top-k by ``k1`` alone misses a tie-break winner),
    so the argmax over the recorded rows reproduces the decision."""
    state, decision, (k1, k2, cand) = _decide_scored(state, graph, policy_id, threshold, gumbel)
    return (*decision, explain_bundle(state, k1, k2, cand, decision[-1], top_k))


def explain_bundle(state: ClusterState, k1: torch.Tensor, k2: torch.Tensor, cand: torch.Tensor,
                   target: torch.Tensor, top_k: int) -> torch.Tensor:
    """f32[6, k] (k = min(top_k, N)): the top-k hazard nodes and the top-k
    candidates by ``k1`` of a decision taken from ``(k1, k2, cand)`` on
    ``state`` (:func:`decide_explain`'s layout), ``target`` always among the
    recorded candidates."""
    k = min(int(top_k), state.num_nodes)
    neg_inf = float("-inf")
    pct = node_cpu_pct_rounded(state).float()
    hz_v, hz_i = _top_k(torch.where(state.node_valid, pct, neg_inf), k)
    _, c_i = _top_k(torch.where(cand, k1, neg_inf), k)
    # top-k by k1 alone can miss the lexicographic winner when more than k
    # nodes tie on the primary key: the chosen node takes the last slot
    missing = (target >= 0) & ~(c_i == target).any()
    c_i = torch.cat([c_i[:-1], torch.where(missing, target, c_i[-1]).reshape(1)])
    return torch.stack([hz_i.float(), hz_v, c_i.float(), k1[c_i].float(), k2[c_i].float(),
                        cand[c_i].float()])


def decide_with_forecast(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    threshold: float,
    gumbel: torch.Tensor | None,
    delta: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``proactive`` decision: :func:`decide` against the PREDICTED
    next-window state, the snapshot with the forecaster's per-node load
    ``delta`` folded into ``node_base_cpu`` (``policies.proactive.
    predicted_state``). Hazard detection and the scores see next-window
    loads; the pod and topology arrays stay observed. A zero ``delta``
    makes this :func:`decide` on the raw state, bit for bit."""
    from kubernetes_rescheduling_tpu_torch.policies.proactive import predicted_state

    return decide(predicted_state(state, delta), graph, policy_id, threshold, gumbel)


def decide_explain_with_forecast(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    threshold: float,
    gumbel: torch.Tensor | None,
    delta: torch.Tensor,
    *,
    top_k: int = 3,
) -> tuple[torch.Tensor, ...]:
    """:func:`decide_explain` against the predicted state: the bundle
    carries the predicted scores the decision was taken from, so the
    explanation re-derives the decision as on a reactive round."""
    from kubernetes_rescheduling_tpu_torch.policies.proactive import predicted_state

    return decide_explain(predicted_state(state, delta), graph, policy_id, threshold, gumbel,
                          top_k=top_k)


def round_step(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    threshold: float,
    gumbel: torch.Tensor | None = None,
) -> tuple[ClusterState, RoundTelemetry]:
    """One rescheduling round; every no-op path is a mask."""
    most, hazard_mask, victim, svc, target = decide(state, graph, policy_id, threshold, gumbel)
    group = deployment_group(state, victim)
    do = (most >= 0) & (victim >= 0) & (target >= 0)
    new_state = state.replace(
        pod_node=torch.where(do & group, target, state.pod_node).to(state.pod_node.dtype)
    )
    telemetry = RoundTelemetry(
        moved=do,
        most_hazard=most,
        victim=torch.where(do, victim, torch.where(most >= 0, victim, -1)),
        service=torch.where(victim >= 0, svc.long(), -1),
        target=torch.where(do, target, -1),
        communication_cost=communication_cost(new_state, graph),
        load_std=load_std(new_state),
    )
    return new_state, telemetry


def run_rounds(
    state: ClusterState,
    graph: CommGraph,
    policy_id: int,
    seed: int = 0,
    *,
    rounds: int = 10,
    threshold: float = 30.0,
    gumbel: torch.Tensor | None = None,
    device: str | torch.device | None = DEFAULT_DEVICE,
) -> tuple[ClusterState, RoundTelemetry]:
    """Run ``rounds`` rescheduling rounds (reference MAX_ROUNDS = 10,
    main.py:28) on ``device``; returns the final state and the stacked
    per-round telemetry.

    The ``random`` policy's noise row of round ``r`` comes from the
    generator of ``(seed, r)``; ``gumbel`` (f32[rounds, N]) supplies the
    rows instead."""
    dev = resolve_device(device)
    state, graph = state.to(dev), graph.to(dev)
    tels = []
    for r in range(rounds):
        g = None
        if gumbel is not None:
            g = gumbel[r].to(dev)
        elif policy_id == POLICY_IDS["random"]:
            g = draw_gumbel((state.num_nodes,), round_generator(seed, r), "cpu").to(dev)
        state, tel = round_step(state, graph, policy_id, threshold, g)
        tels.append(tel)
    stacked = RoundTelemetry(**{
        name: torch.stack([getattr(t, name) for t in tels]) if tels else torch.empty(0)
        for name in RoundTelemetry.__dataclass_fields__
    })
    return state, stacked
