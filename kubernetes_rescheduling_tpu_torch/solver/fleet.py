"""Fleet mode, device half: the greedy decision over a leading tenant axis —
the port of ``kubernetes_rescheduling_tpu.solver.fleet``.

- :func:`stack_tenants`: N same-shaped tenant states (or graphs) stacked
  along a new leading tenant axis. Tenants must already be padded to a
  common capacity; a mismatched shape raises naming the tenant, never a
  silent broadcast.
- :func:`fleet_solve`: the port's ``decide`` (``solver/round_loop.py``) for
  every tenant, packed as ``i32[T, 4]`` rows (``ROW_*``) and ``bool[T, N]``
  hazard masks, with padded slots (``tenant_mask`` False) masked to the
  no-op: they never emit a move. The tenants run one after another in one
  body, each through the solo ``decide`` on its own copy of its rows, so a
  tenant's decision is the solo decision bit for bit (ties to the first
  index, as there). On the card the body is one replay of a CUDA graph
  captured per key (``solver/compiled.py``: the tenant count, the shapes,
  the policy and the threshold; ``cuda_graph_captures_total{fn=
  "fleet_solve"}``), the counterpart of the JAX package's one ``vmap``
  program.
- :func:`fleet_metrics`: the per-tenant round-end pair ``f32[T, 2]``
  (communication cost over each tenant's edge list, load std), the closing
  numbers of the solo loop's round for every tenant at once.

A fleet's graphs are a sequence of per-tenant ``CommGraph``s, not a
stacked one: their adjacencies are large read-only operands the bodies
read in place (stacking them would copy T × S² floats a stack and change
the capture key's identity each time).

- :func:`fleet_solve_proactive`: the proactive plane — the solo
  ``decide_with_forecast`` for every tenant against its own forecast delta
  row, packed the same way (``fn="fleet_solve_proactive"``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from kubernetes_rescheduling_tpu_torch.bench.round_end import round_end_metrics
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE
from kubernetes_rescheduling_tpu_torch.solver.global_solver import state_from_inputs, state_inputs
from kubernetes_rescheduling_tpu_torch.solver.round_loop import decide, decide_with_forecast

# columns of the per-tenant decision rows (axis 1 of the i32[T, 4])
ROW_MOST, ROW_VICTIM, ROW_SERVICE, ROW_TARGET = range(4)
# a masked slot's row: the no-op of every column
_MASKED_ROW = (-1, -1, 0, -1)


def _tensor_fields(tree) -> list[str]:
    return [f.name for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)]


def stack_tenants(trees):
    """Stack N same-shaped tenant ``ClusterState``s (or ``CommGraph``s) along
    a new leading tenant axis. The name tuples are tenant 0's: host
    bookkeeping no body reads. A shape mismatch raises naming the tenant
    (pad every tenant to a common capacity first)."""
    if not trees:
        raise ValueError("stack_tenants needs at least one tenant")
    first = trees[0]
    names = _tensor_fields(first)
    for t, tree in enumerate(trees[1:], start=1):
        if type(tree) is not type(first) or _tensor_fields(tree) != names:
            raise ValueError(f"tenant {t} has a different structure than tenant 0")
        for name in names:
            a, b = getattr(first, name), getattr(tree, name)
            if a.shape != b.shape:
                raise ValueError(
                    f"tenant {t} {name} shape {tuple(b.shape)} != tenant 0 shape "
                    f"{tuple(a.shape)}: fleet tenants must be padded to a common capacity "
                    "(node_capacity/pod_capacity) before stacking"
                )
    return dataclasses.replace(first, **{
        name: torch.stack([getattr(tree, name) for tree in trees]) for name in names
    })


def tenant_view(stacked, t: int):
    """Tenant ``t`` of a stacked tree, each tensor a fresh copy of its row
    (own allocation, so a reduction over it runs exactly as over the solo
    tenant's tensor)."""
    return dataclasses.replace(stacked, **{
        name: getattr(stacked, name)[t].clone() for name in _tensor_fields(stacked)
    })


def tenant_states(states, tenants: int) -> list[ClusterState]:
    """Per-tenant states from a stacked state or a sequence of them."""
    if isinstance(states, ClusterState):
        return [tenant_view(states, t) for t in range(tenants)]
    return list(states)


def prefixed(i: int, inputs: dict) -> dict:
    """Tenant ``i``'s inputs of a fleet body, keyed ``"<i>:<name>"``."""
    return {f"{i}:{k}": v for k, v in inputs.items()}


def tenant_inputs(t: dict, i: int) -> dict:
    """Tenant ``i``'s inputs out of a fleet body's ``t`` (:func:`prefixed`)."""
    pre = f"{i}:"
    return {k[len(pre):]: v for k, v in t.items() if k.startswith(pre)}


def check_graphs(graphs: Sequence[CommGraph], tenants: int) -> None:
    if len(graphs) != tenants:
        raise ValueError(f"{len(graphs)} graphs for {tenants} tenants")
    s0 = graphs[0].adj.shape
    for t, g in enumerate(graphs):
        if g.adj.shape != s0:
            raise ValueError(
                f"tenant {t} adjacency shape {tuple(g.adj.shape)} != tenant 0 shape "
                f"{tuple(s0)}: fleet tenants must be padded to a common capacity"
            )


def fleet_decide_body(t: dict, adjs, *, policy_id: int, threshold: float, tenants: int
                      ) -> dict[str, torch.Tensor]:
    """The fleet's decision as a function of device tensors that reads
    nothing back: ``t`` holds the stacked state's arrays, ``service_valid``
    [T, S], ``mask`` [T], for the ``random`` policy ``gumbel`` [T, N], and
    on the proactive plane the forecast ``deltas`` [T, N]. Returns
    ``{"decisions": i32[T, 4], "hazard": bool[T, N]}``."""
    st = state_from_inputs(t)
    gumbel = t.get("gumbel")
    deltas = t.get("deltas")
    rows, hazards = [], []
    for i in range(tenants):
        g = CommGraph(adj=adjs[i], service_valid=t["service_valid"][i].clone())
        noise = gumbel[i].clone() if gumbel is not None else None
        if deltas is not None:
            most, hazard, victim, svc, target = decide_with_forecast(
                tenant_view(st, i), g, policy_id, threshold, noise, deltas[i].clone())
        else:
            most, hazard, victim, svc, target = decide(tenant_view(st, i), g, policy_id,
                                                       threshold, noise)
        rows.append(torch.stack([x.to(torch.int32) for x in (most, victim, svc, target)]))
        hazards.append(hazard)
    mask = t["mask"]
    rows = torch.stack(rows)
    decisions = torch.stack([torch.where(mask, rows[:, c], fill)
                             for c, fill in enumerate(_MASKED_ROW)], dim=1).to(torch.int32)
    return {"decisions": decisions, "hazard": torch.stack(hazards) & mask[:, None]}


def fleet_solve(states: ClusterState, graphs: Sequence[CommGraph], policy_id: int,
                threshold: float, tenant_mask: torch.Tensor,
                gumbel: torch.Tensor | None = None, *, deltas: torch.Tensor | None = None,
                fn: str = "fleet_solve") -> tuple[torch.Tensor, torch.Tensor]:
    """Every tenant's decision in one body: ``(decisions i32[T, 4], hazard
    bool[T, N])`` on the states' device, ``decisions[t]`` being ``(most,
    victim, service, target)`` of the solo ``decide`` on tenant ``t``
    (``ROW_*``). ``states`` is stacked (:func:`stack_tenants`), ``graphs``
    one graph a tenant, ``gumbel`` the ``random`` policy's noise rows
    [T, N]. A slot whose ``tenant_mask`` is False comes back as the no-op
    (-1, -1, 0, -1) with an all-False hazard row. ``deltas`` (f32[T, N]) makes
    it the proactive plane (:func:`fleet_solve_proactive`)."""
    T = int(tenant_mask.shape[0])
    check_graphs(graphs, T)
    dev = states.device
    inputs = {**state_inputs(states),
              "service_valid": torch.stack([g.service_valid for g in graphs]),
              "mask": tenant_mask.to(dev, torch.bool)}
    if gumbel is not None:
        n = int(states.node_valid.shape[-1])
        if tuple(gumbel.shape) != (T, n):
            raise ValueError(f"gumbel rows {tuple(gumbel.shape)} != {(T, n)}")
        inputs["gumbel"] = gumbel.to(dev)
    if deltas is not None:
        inputs["deltas"] = deltas.to(dev, torch.float32)
    adjs = tuple(g.adj for g in graphs)
    static = dict(policy_id=int(policy_id), threshold=float(threshold), tenants=T)

    def make_body():
        return lambda t: fleet_decide_body(t, adjs, **static)

    out = CACHE.run(fn, tuple(sorted(static.items())), inputs, make_body, operands=adjs)
    return out["decisions"], out["hazard"]


def fleet_solve_proactive(states: ClusterState, graphs: Sequence[CommGraph], policy_id: int,
                          threshold: float, tenant_mask: torch.Tensor, deltas: torch.Tensor,
                          gumbel: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The proactive fleet decision: tenant ``t`` decides as the solo
    ``decide_with_forecast`` on its state with its forecast delta row
    ``deltas[t]`` (f32[T, N], from ``forecast.fleet``), packed as
    :func:`fleet_solve` packs; one replay on the card (``fn=
    "fleet_solve_proactive"``). A zero delta row decides as the reactive
    plane; masked slots never emit a move."""
    return fleet_solve(states, graphs, policy_id, threshold, tenant_mask, gumbel,
                       deltas=deltas, fn="fleet_solve_proactive")


def fleet_metrics(states, graphs: Sequence[CommGraph], edges=None) -> torch.Tensor:
    """f32[T, 2]: ``(communication_cost, load_std)`` per tenant, the cost
    over tenant ``t``'s edge list ``edges[t]`` (``objectives.metrics.
    comm_edge_list``) when given, as the solo loop's round end computes it."""
    sts = tenant_states(states, len(graphs))
    return torch.stack([
        round_end_metrics(s, g, edges=edges[i] if edges is not None else None)
        for i, (s, g) in enumerate(zip(sts, graphs))
    ])
