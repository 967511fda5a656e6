"""Fleet mode, global-solver plane: the dense global solve over the tenants —
the port of ``kubernetes_rescheduling_tpu.solver.fleet_global``.

A fleet global round re-places every service in every tenant as ONE device
program. As in the JAX package (``lax.map`` over the tenants, deliberately
not ``vmap``), the program is the solo solve body once per tenant, in
tenant order, at the solo shapes: each tenant's body is
``global_solver.dense_solve`` on that tenant's own inputs and plans,
through the same kernels (mass, score, admission), so a tenant's result is
the solo solve's bit for bit and the working set is one tenant's, reused by
the next. On the card the T bodies are one CUDA graph captured per key —
the tenant count, the solo shapes, the config and the lowering (and the
adjacencies' identities, the operands) — and a fleet round is one replay
(``cuda_graph_captures_total{fn="fleet_global_solve"}``).

After each solve the body collapses the pod-level move set to the service
level (:func:`collapse_moves`, the device twin of the solo round's host
loop): the target per service, the first moved pod per service (the solo
loop discovers moves in pod order) and the objective row. The whole fleet
comes home as ONE flat f32 bundle, ``[svc_target (T·S), first_pod (T·S),
obj rows (T·OBJ_ROWS)]`` (:func:`decode_fleet_global`); padded tenant slots
(``tenant_mask`` False) never emit a move.

Best-of-R fleet restarts (``n_restarts > 1``) fan the tenants' restarts
out over the fleet's device mesh in the JAX package and are refused here
(ROADMAP Queue 1 item 5); a solo loop's ``solver_restarts`` runs
(``parallel.solve_with_restarts``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE
from kubernetes_rescheduling_tpu_torch.solver.fleet import (
    check_graphs,
    prefixed,
    tenant_inputs,
    tenant_states,
)
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    GlobalSolverConfig,
    dense_solve,
    dense_solve_inputs,
    state_from_inputs,
)

# objective row layout per tenant, after the two [T, S] planes; NaN in
# OBJ_BEFORE / OBJ_IMPROVED decodes to None (the JAX package's restart
# fan-out reports only after and penalty)
OBJ_BEFORE, OBJ_AFTER, OBJ_IMPROVED, OBJ_PENALTY, OBJ_ROWS = range(5)


def collapse_moves(state: ClusterState, new_pod_node: torch.Tensor, num_services: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(svc_target i64[S], first_pod i64[S])``: per service the node its
    moved pods go to (-1: unmoved; all moved pods of a service share the
    solver's service-level target, the max is taken) and its first moved pod
    (P: unmoved), with min/max scatters — exact in any order."""
    S, P = num_services, state.num_pods
    dev = state.device
    moved = state.pod_valid & (new_pod_node != state.pod_node)
    svc = torch.where(moved, torch.clamp(state.pod_service.long(), 0, S - 1), S)
    pods = torch.arange(P, device=dev)
    first_pod = torch.full((S + 1,), P, dtype=torch.int64, device=dev).scatter_reduce(
        0, svc, torch.where(moved, pods, P), "amin")[:S]
    svc_target = torch.full((S + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, svc, torch.where(moved, new_pod_node.long(), -1), "amax")[:S]
    return svc_target, first_pod


def fleet_global_body(t: dict, adjs, *, config: GlobalSolverConfig, lay, tenants: int
                      ) -> dict[str, torch.Tensor]:
    """The T solo solve bodies in tenant order and the bundle, as a function
    of device tensors that reads nothing back: ``t`` holds every tenant's
    solve inputs under ``"<t>:"`` and the tenant ``mask``."""
    S = lay.services
    targets, firsts, objs = [], [], []
    for i in range(tenants):
        ti = tenant_inputs(t, i)
        st = state_from_inputs(ti)
        out = dense_solve(st, CommGraph(adj=adjs[i], service_valid=ti["service_valid"]),
                          config, lay, ti)
        svc_target, first_pod = collapse_moves(st, out["pod_node"], S)
        targets.append(svc_target)
        firsts.append(first_pod)
        objs.append(torch.stack([out["objective_before"].float(),
                                 out["objective_after"].float(),
                                 out["improved"].float(), out["move_penalty"].float()]))
        P = st.num_pods
    m = t["mask"]
    svc_target = torch.where(m[:, None], torch.stack(targets), -1)
    first_pod = torch.where(m[:, None], torch.stack(firsts), P)
    obj = torch.where(m[:, None], torch.stack(objs), 0.0)
    return {"flat": torch.cat([svc_target.reshape(-1).float(), first_pod.reshape(-1).float(),
                               obj.reshape(-1)])}


def fleet_global_solve(states, graphs: Sequence[CommGraph], tenant_mask: torch.Tensor, *,
                       config: GlobalSolverConfig = GlobalSolverConfig(),
                       generators: Sequence[torch.Generator | None] | None = None,
                       plans: Sequence[list | None] | None = None,
                       n_restarts: int = 1) -> torch.Tensor:
    """The fleet global round's flat f32 bundle on the states' device.
    ``states`` is stacked (``solver.fleet.stack_tenants``) or one state a
    tenant, ``graphs`` one graph a tenant; tenant ``t``'s per-sweep plans
    are ``plans[t]``, else drawn from ``generators[t]`` exactly as
    ``global_assign`` draws them — so each tenant's result equals
    ``global_assign(states[t], graphs[t], generators[t], config,
    plan=plans[t])``. Decode with :func:`decode_fleet_global`."""
    if n_restarts > 1:
        raise ValueError(
            "fleet_global_solve(n_restarts > 1) fans the restarts out across devices, "
            "which the port does not do yet (ROADMAP Queue 1 item 5)"
        )
    T = int(tenant_mask.shape[0])
    check_graphs(graphs, T)
    sts = tenant_states(states, T)
    generators = list(generators) if generators is not None else [None] * T
    plans = list(plans) if plans is not None else [None] * T
    inputs, lay = {}, None
    for i in range(T):
        lay_i, inp = dense_solve_inputs(sts[i], graphs[i], generators[i], config, plans[i])
        if lay is not None and lay_i != lay:
            raise ValueError(f"tenant {i} solve layout {lay_i} != tenant 0 layout {lay}")
        lay = lay_i
        inputs.update(prefixed(i, inp))
    inputs["mask"] = tenant_mask.to(sts[0].device, torch.bool)
    adjs = tuple(g.adj for g in graphs)

    def make_body():
        return lambda t: fleet_global_body(t, adjs, config=config, lay=lay, tenants=T)

    out = CACHE.run("fleet_global_solve", (config, lay, T), inputs, make_body, operands=adjs)
    return out["flat"]


def decode_fleet_global(flat, *, tenants: int, num_services: int):
    """Per-tenant move lists and objectives from the bundle: ``moves[t]`` is
    ``[(service, target), ...]`` in the solo loop's first-moved-pod order,
    ``objs[t]`` is ``(objective_before, objective_after, improved,
    move_penalty)`` (None where the bundle holds NaN)."""
    flat = np.asarray(flat)
    ts = tenants * num_services
    svc_target = flat[:ts].reshape(tenants, num_services).astype(np.int64)
    first_pod = flat[ts: 2 * ts].reshape(tenants, num_services)
    obj = flat[2 * ts:].reshape(tenants, OBJ_ROWS)
    moves: list[list[tuple[int, int]]] = []
    objs: list[tuple] = []
    for t in range(tenants):
        changed = np.flatnonzero(svc_target[t] >= 0)
        order = changed[np.argsort(first_pod[t][changed], kind="stable")]
        moves.append([(int(s), int(svc_target[t, s])) for s in order])
        before, after, improved, pen = obj[t]
        objs.append((None if np.isnan(before) else float(before), float(after),
                     None if np.isnan(improved) else bool(improved), float(pen)))
    return moves, objs
