"""The serving plane's decisions: score ONE requested service — the port of
``kubernetes_rescheduling_tpu.serving.kernel``.

:func:`place_one` is the request-grain sibling of
``solver.round_loop.decide_explain``: the same finite guard, hazard
detection, ``policy_scores`` rows, masked lexicographic argmax and f32[6, k]
explain bundle — but the service comes from the request, not from victim
selection, and nothing is removed from the snapshot (serving places new
work; the round loop moves existing work). Its target is
``policies.scoring.choose_node`` on the guarded state.

:func:`place_batch` scores B coalesced requests against ONE snapshot: the
snapshot's part (guard, hazard detection, the service-independent features
and the S × N occupancy matrix) once, then the solo core once per row, one
after another, so each row equals :func:`place_one` on that row's inputs
bit for bit (the fleet bodies' rule). On the card the body is one replay
of a CUDA graph captured per batch shape (``solver/compiled.py``,
``cuda_graph_captures_total{fn="serving_place"}`` == 1 in steady state:
the engine pads every batch to its static ``max_batch``).

The ``random`` policy's noise is an input row per request (drawn by the
caller; the engine draws request ``seq``'s row from ``_random.
round_generator(seed, seq)``), where the JAX package passes a key.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.policies.hazard import detect_hazard
from kubernetes_rescheduling_tpu_torch.policies.scoring import (
    lex_argmax,
    policy_scores,
    state_features,
)
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE
from kubernetes_rescheduling_tpu_torch.solver.global_solver import state_from_inputs, state_inputs
from kubernetes_rescheduling_tpu_torch.solver.round_loop import explain_bundle, finite_guard


def _snapshot_part(state: ClusterState, graph: CommGraph, threshold: float):
    """What every request against one snapshot shares: the guarded state,
    its hazard detection and its service-independent features."""
    state = finite_guard(state)
    most, hazard_mask = detect_hazard(state, threshold)
    return state, most, hazard_mask, state_features(state, graph)


def _place_core(snap, graph: CommGraph, policy_id: int, svc: torch.Tensor,
                gumbel: torch.Tensor | None, top_k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One request against ``snap`` (:func:`_snapshot_part`), the body both
    entry points share: ``(most_hazard, target, bundle)``, target -1 when
    every valid node is hazardous."""
    state, most, hazard_mask, shared = snap
    k1, k2, cand = policy_scores(policy_id, state, graph, svc, hazard_mask, gumbel, shared)
    target = lex_argmax([k1, k2], cand)
    return most, target, explain_bundle(state, k1, k2, cand, target, top_k)


def place_one(state: ClusterState, graph: CommGraph, policy_id: int, threshold: float,
              svc: torch.Tensor, gumbel: torch.Tensor | None = None, *, top_k: int = 3
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place one requested service (0-d ``svc``) against ``state``:
    ``(most_hazard, target, bundle)``; ``gumbel`` is the ``random``
    policy's noise row."""
    svc = torch.as_tensor(svc, device=state.device)
    return _place_core(_snapshot_part(state, graph, float(threshold)), graph, int(policy_id),
                       svc, gumbel, int(top_k))


def _batch_body(t: dict, adj: torch.Tensor, *, policy_id: int, threshold: float, top_k: int,
                batch: int) -> dict:
    graph = CommGraph(adj=adj, service_valid=t["service_valid"])
    snap = _snapshot_part(state_from_inputs(t), graph, threshold)
    svcs, gumbel = t["svcs"], t.get("gumbel")
    rows = [_place_core(snap, graph, policy_id, svcs[b],
                        gumbel[b] if gumbel is not None else None, top_k)
            for b in range(batch)]
    return {"most": torch.stack([r[0] for r in rows]),
            "target": torch.stack([r[1] for r in rows]),
            "bundle": torch.stack([r[2] for r in rows])}


def place_batch(state: ClusterState, graph: CommGraph, policy_id: int, threshold: float,
                svcs: torch.Tensor, gumbel: torch.Tensor | None = None, *, top_k: int = 3
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B requests against one snapshot: ``svcs`` i64[B], ``gumbel`` the
    ``random`` policy's rows [B, N]. Returns ``(most_hazard[B], target[B],
    bundle[B, 6, k])``, row ``b`` equal to :func:`place_one` on ``svcs[b]``
    and ``gumbel[b]``; one replay on the card (``fn="serving_place"``)."""
    dev = state.device
    B = int(svcs.shape[0])
    inputs = {**state_inputs(state), "service_valid": graph.service_valid,
              "svcs": svcs.to(dev, torch.int64)}
    if gumbel is not None:
        if tuple(gumbel.shape) != (B, state.num_nodes):
            raise ValueError(f"gumbel rows {tuple(gumbel.shape)} != {(B, state.num_nodes)}")
        inputs["gumbel"] = gumbel.to(dev, torch.float32)
    static = dict(policy_id=int(policy_id), threshold=float(threshold), top_k=int(top_k),
                  batch=B)
    adj = graph.adj

    def make_body():
        return lambda t: _batch_body(t, adj, **static)

    out = CACHE.run("serving_place", tuple(sorted(static.items())), inputs, make_body,
                    operands=(adj,))
    return out["most"], out["target"], out["bundle"]
