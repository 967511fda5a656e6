"""The simulator's device twin: its steady-state round update as tensor math
— the port of ``kubernetes_rescheduling_tpu.backends.sim_device``.

``SimBackend`` is host-side Python by design (its pod table mutates, its
clock advances, its event list grows). The steady-state round — no churn,
no faults, no load noise — touches none of that: a monitor snapshot is a
function of the placement only (a pod's CPU depends on its service, never
on its node), and a round's one mutation is "move the victim Deployment's
pods to the landing node". This module is that update, so the scanned
schedule (``bench/scan.py``) can run K rounds — decide → apply → monitor →
round-end metrics — on the device without a host read.

Seeded trajectories through :func:`sim_step` and through ``SimBackend``
give equal placements and loads, including moves onto over-capacity nodes
(neither rejects on capacity) and the ``affinityOnly`` landing
(:func:`scheduler_choice`, the twin of ``SimBackend._scheduler_choice``).
The simulator stays the oracle: the scanned controller replays every move
into it through the boundary, and whatever the twin cannot express
(churn, faults, noise) drains to the per-round path.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.backends.sim import SimBackend, workload_layout
from kubernetes_rescheduling_tpu_torch.core.state import UNASSIGNED, ClusterState, CommGraph, segment_sum
from kubernetes_rescheduling_tpu_torch.policies._index import first_true
from kubernetes_rescheduling_tpu_torch.policies.victim import deployment_group


def scheduler_choice(state: ClusterState, exclude_mask: torch.Tensor) -> torch.Tensor:
    """The node the simulated default scheduler picks: least-allocated CPU
    among valid (alive), non-excluded nodes, the first minimum in node
    order (the least index of an integer ``where``, as the simulator's
    strict ``<``); -1 when no node is a candidate.

    Allocation sums each node's tracked pod CPU in f32 in pod order
    (:func:`~core.state.segment_sum`), where the simulator sums in f64: a
    disagreement needs two nodes within one f32 ulp (seeded instances are
    held equal in the tests). Runs on the device, reading nothing back."""
    n = state.num_nodes
    slot = torch.where(state.pod_valid & (state.pod_node >= 0), state.pod_node, n)
    used = segment_sum(torch.where(state.pod_valid, state.pod_cpu, 0.0), slot, n)
    cand = state.node_valid & ~exclude_mask
    masked = torch.where(cand, used, torch.inf)
    best = first_true(cand & (masked == masked.min()))
    return torch.where(cand.any(), best, -1)


def apply_decision(state: ClusterState, victim: torch.Tensor, service: torch.Tensor,
                   target: torch.Tensor, hazard_mask: torch.Tensor, *, pinned: bool = True
                   ) -> tuple[ClusterState, torch.Tensor, torch.Tensor]:
    """Apply one round's decision to the twin — the device half of
    ``SimBackend.apply_move`` and of the steady-state monitor after it.

    ``pinned=True`` models ``nodeName`` / ``nodeSelector`` (the move lands
    on ``target``); ``pinned=False`` models ``affinityOnly`` (the landing
    is :func:`scheduler_choice` excluding the hazard nodes). A dead or
    invalid landing, or a no-op decision (``victim`` / ``target`` -1),
    moves nothing.

    Returns ``(new_state, landed, moved)``: the post-move twin (equal to
    what the next ``monitor()`` builds), the landing node (-1 when nothing
    moved) and the moved flag. ``service`` is implied by the victim's
    Deployment; it stays in the signature so a decision tuple threads
    through unchanged."""
    del service
    landing = target if pinned else scheduler_choice(state, hazard_mask)
    safe = torch.clamp(landing, 0, state.num_nodes - 1)
    alive = state.node_valid.index_select(0, safe.reshape(1).long())[0] & (landing >= 0)
    do = (victim >= 0) & (target >= 0) & alive
    group = deployment_group(state, victim)
    new_pod_node = torch.where(do & group, safe, state.pod_node).to(state.pod_node.dtype)
    return state.replace(pod_node=new_pod_node), torch.where(do, landing, -1), do


def sim_step(state: ClusterState, decision, *, pinned: bool = True
             ) -> tuple[ClusterState, ClusterState]:
    """One steady-state simulator round: apply ``decision`` — ``(victim,
    service, target, hazard_mask)`` — and return ``(new_state, snapshot)``.
    In the steady state the monitor is the identity on the post-move state,
    so the two are the same; the pair keeps the monitor's role explicit."""
    victim, service, target, hazard_mask = decision
    new_state, _landed, _moved = apply_decision(state, victim, service, target, hazard_mask,
                                                pinned=pinned)
    return new_state, new_state


def twin_of(backend: SimBackend) -> tuple[ClusterState, CommGraph]:
    """The device twin of a ``SimBackend``: its monitor snapshot and the
    comm graph of the shared :func:`~backends.sim.workload_layout` — the
    padding and service-index compaction the backend itself serves."""
    graph, _svc_index = workload_layout(backend.workmodel, backend.service_capacity,
                                        backend.device)
    return backend.monitor(), graph


def scan_compatible(backend) -> bool:
    """Whether the scanned schedule's steady-state assumptions hold: a raw
    simulator (a wrapper may inject what only the per-round path honors)
    with a noise-free load model (the monitor a function of placement)."""
    return type(backend) is SimBackend and float(backend.load.noise_frac) == 0.0


__all__ = ["apply_decision", "scan_compatible", "scheduler_choice", "sim_step", "twin_of",
           "UNASSIGNED"]
