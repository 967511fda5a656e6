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

Best-of-R fleet restarts (``n_restarts > 1``) run on the one device, as in
the JAX package (a ``lax.scan`` over ``split(key, R)`` a tenant): tenant
``t``'s body runs R solo solve bodies in turn, restart ``i`` on the plans of
``parallel.sharded.restart_generators(generators[t], R)[i]``, and adopts the
first ``argmin`` of ``objective_after + move_penalty`` on the device — the
rule of ``parallel.sharded.parallel_restarts`` — so each tenant equals the
solo ``solve_with_restarts(n_restarts=R)`` bit for bit. The body keeps the
R placements and one solve's working set at a time; only ``objective_after``
and ``move_penalty`` are reported (``objective_before`` and ``improved``
ride as NaN and decode to None, as in the JAX package). The capture key
holds R, so a fleet round at R restarts is one replay.
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
    state_inputs,
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


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index, without reading it back."""
    return x.index_select(0, i.reshape(1))[0]


def _best_of(st: ClusterState, graph: CommGraph, config: GlobalSolverConfig, lay, ti: dict,
             n_restarts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One tenant's best-of-R: the R solo solve bodies on the restarts' plans
    (``ti["<r>:..."]``), each placement written into one buffer as it
    finishes, and the first ``argmin`` of ``objective_after +
    move_penalty`` (``parallel_restarts``' rule). Returns ``(pod_node,
    obj row f32[4])`` with NaN for before and improved."""
    pods = torch.empty((n_restarts, st.num_pods), dtype=st.pod_node.dtype, device=st.device)
    objs, pens = [], []
    for r in range(n_restarts):
        out = dense_solve(st, graph, config, lay, tenant_inputs(ti, r))
        pods[r] = out["pod_node"]
        objs.append(out["objective_after"])
        pens.append(out["move_penalty"])
        del out
    objs, pens = torch.stack(objs), torch.stack(pens)
    best = torch.argmin(objs + pens)
    nan = torch.full((), float("nan"), device=st.device)
    obj = torch.stack([nan, _pick(objs, best).float(), nan, _pick(pens, best).float()])
    return _pick(pods, best), obj


def fleet_global_body(t: dict, adjs, *, config: GlobalSolverConfig, lay, tenants: int,
                      n_restarts: int = 1) -> dict[str, torch.Tensor]:
    """The T solo solve bodies in tenant order (R of them a tenant with
    ``n_restarts > 1``) and the bundle, as a function of device tensors that
    reads nothing back: ``t`` holds every tenant's solve inputs under
    ``"<t>:"`` (a restart's plans under ``"<t>:<r>:"``) and the tenant
    ``mask``."""
    S = lay.services
    targets, firsts, objs = [], [], []
    for i in range(tenants):
        ti = tenant_inputs(t, i)
        st = state_from_inputs(ti)
        g = CommGraph(adj=adjs[i], service_valid=ti["service_valid"])
        if n_restarts > 1:
            pod_node, obj = _best_of(st, g, config, lay, ti, n_restarts)
        else:
            out = dense_solve(st, g, config, lay, ti)
            pod_node = out["pod_node"]
            obj = torch.stack([out["objective_before"].float(), out["objective_after"].float(),
                               out["improved"].float(), out["move_penalty"].float()])
        svc_target, first_pod = collapse_moves(st, pod_node, S)
        targets.append(svc_target)
        firsts.append(first_pod)
        objs.append(obj)
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
    plan=plans[t])``. With ``n_restarts`` R > 1, ``plans[t]`` is one plan
    list a restart, else restart ``i`` draws from
    ``parallel.sharded.restart_generators(generators[t], R)[i]``, and tenant
    ``t`` equals ``solve_with_restarts(states[t], graphs[t], generators[t],
    n_restarts=R, config=config)``. Decode with :func:`decode_fleet_global`."""
    from kubernetes_rescheduling_tpu_torch.parallel.sharded import restart_generators

    T = int(tenant_mask.shape[0])
    R = max(int(n_restarts), 1)
    check_graphs(graphs, T)
    sts = tenant_states(states, T)
    generators = list(generators) if generators is not None else [None] * T
    plans = list(plans) if plans is not None else [None] * T
    inputs, lay = {}, None
    for i in range(T):
        if R > 1:
            if plans[i] is not None and len(plans[i]) != R:
                raise ValueError(f"tenant {i}: {len(plans[i])} restart plans for {R} restarts")
            gens = restart_generators(generators[i], R) if plans[i] is None else [None] * R
            inp = {}
            for r in range(R):
                lay_i, inp_r = dense_solve_inputs(sts[i], graphs[i], gens[r], config,
                                                  plans[i][r] if plans[i] is not None else None)
                base = {k: inp_r.pop(k) for k in ("service_valid", *state_inputs(sts[i]))}
                inp.update(base)
                inp.update(prefixed(r, inp_r))
        else:
            lay_i, inp = dense_solve_inputs(sts[i], graphs[i], generators[i], config, plans[i])
        if lay is not None and lay_i != lay:
            raise ValueError(f"tenant {i} solve layout {lay_i} != tenant 0 layout {lay}")
        lay = lay_i
        inputs.update(prefixed(i, inp))
    inputs["mask"] = tenant_mask.to(sts[0].device, torch.bool)
    adjs = tuple(g.adj for g in graphs)

    def make_body():
        return lambda t: fleet_global_body(t, adjs, config=config, lay=lay, tenants=T,
                                           n_restarts=R)

    out = CACHE.run("fleet_global_solve", (config, lay, T, R), inputs, make_body,
                    operands=adjs)
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
