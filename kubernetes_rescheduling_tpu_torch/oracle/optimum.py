"""True-optimum oracles for measuring the solver's optimality gap — the
port's own copy of ``kubernetes_rescheduling_tpu.oracle.optimum``.

BASELINE.md promises "globally-optimal placement"; the solver's quality
gates so far were "never worse than the input" and "beats greedy CAR" —
neither says how far from *optimal* the chunked best-response lands. These
oracles provide ground truth at two scales:

- :func:`brute_force_optimum` — exhaustive N^S enumeration (vectorized,
  batched). Exact for the FULL solver objective (comm + balance + overload
  + hard capacity), feasible up to ~N^S ≈ 10^7 (S≤10, N≤4 comfortably).
- :func:`milp_optimum` — exact integer-program optimum of the COMM
  objective (cut weight) under capacity constraints, via scipy's HiGHS
  branch-and-bound. The cut linearization: binary x[s,n], continuous
  z[e] ∈ [0,1] with z_e ≥ x[s,n] − x[t,n] for every node — for any
  assignment, the node where s sits and t doesn't forces z_e = 1 iff the
  edge is cut. Scales to S ≈ 100-200 services — a regime the brute force
  cannot touch. Balance terms are nonlinear (std of loads), so MILP gap
  measurements run the solver with balance_weight=0.

Gap results and the re-justification of the sweeps/noise defaults live in
RESULTS.md (§ optimality gap); the regression test pins the measured
small-instance gap so a solver change that silently loses quality fails CI.

Reference objective being bounded: communicationcost.py:40-45.
"""

from __future__ import annotations

import numpy as np

import torch

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _problem_arrays(state: ClusterState, graph: CommGraph):
    """Collapse to service-level arrays (the solver's decision space):
    pair weights W = adj·rv·rv over services with pods, per-service CPU,
    node budgets."""
    S = graph.num_services
    svc = _host(state.pod_service)
    valid = _host(state.pod_valid)
    pod_cpu = _host(state.pod_cpu)
    rv = np.zeros(S)
    cpu = np.zeros(S)
    for i in np.flatnonzero(valid):
        s = int(svc[i])
        if 0 <= s < S:
            rv[s] += 1.0
            cpu[s] += float(pod_cpu[i])
    adj = _host(graph.adj)[:S, :S]
    W = adj * rv[:, None] * rv[None, :]
    placed = rv > 0
    node_valid = _host(state.node_valid)
    cap = _host(state.node_cpu_cap).astype(float)
    base = _host(state.node_base_cpu).astype(float)
    return W, cpu, placed, node_valid, cap, base


def brute_force_optimum(
    state: ClusterState,
    graph: CommGraph,
    *,
    balance_weight: float = 0.0,
    overload_weight: float = 10.0,
    capacity_frac: float = 1.0,
    enforce_capacity: bool = True,
    batch: int = 65536,
) -> tuple[np.ndarray, float]:
    """Exhaustive optimum of the solver's exact objective.

    Returns ``(assign[S], objective)`` where infeasible assignments (any
    service on a node whose budget it busts, when enforcing capacity) are
    excluded — matching the solver's hard feasibility veto. Services
    without pods keep assignment 0 and contribute nothing.
    """
    W, cpu, placed, node_valid, cap, base = _problem_arrays(state, graph)
    # mirror the solver's accounting: over-budget repulsion only exists
    # alongside budget enforcement (global_solver.global_assign zeroes
    # overload_weight when enforce_capacity=False) — without this gate the
    # oracle would measure a different objective than the solver optimizes
    if not enforce_capacity:
        overload_weight = 0.0
    S = len(cpu)
    nodes = np.flatnonzero(node_valid)
    N = len(nodes)
    if N ** int(placed.sum()) > 50_000_000:
        raise ValueError(
            f"N^S = {N}^{int(placed.sum())} too large for brute force"
        )
    budget = np.where(cap > 0, cap, 1.0) * capacity_frac
    movers = np.flatnonzero(placed)
    M = len(movers)
    total = N**M
    best_obj = np.inf
    best = None
    Wm = W[np.ix_(movers, movers)]
    cm = cpu[movers]
    for start in range(0, total, batch):
        idx = np.arange(start, min(start + batch, total))
        # mixed-radix decode: column m = node choice of movers[m]
        a = (idx[:, None] // N ** np.arange(M)[None, :]) % N  # [B, M]
        an = nodes[a]
        # cut weight: sum over pairs with different nodes
        diff = (an[:, :, None] != an[:, None, :]).astype(float)
        comm = 0.5 * np.einsum("st,bst->b", Wm, diff)
        loads = base[None, nodes] + np.zeros((len(idx), N))
        np.add.at(
            loads.reshape(-1),
            (np.arange(len(idx))[:, None] * N + a).reshape(-1),
            np.broadcast_to(cm[None, :], a.shape).reshape(-1),
        )
        pct = loads / budget[None, nodes] * 100.0
        obj = comm.copy()
        if balance_weight:
            obj += balance_weight * pct.std(axis=1)
        obj += overload_weight * np.maximum(pct - 100.0, 0.0).sum(axis=1)
        if enforce_capacity:
            feasible = (loads <= budget[None, nodes]).all(axis=1)
            obj = np.where(feasible, obj, np.inf)
        i = int(np.argmin(obj))
        if obj[i] < best_obj:
            best_obj = float(obj[i])
            full = np.zeros(S, dtype=np.int64)
            full[movers] = an[i]
            best = full
    return best, best_obj


def milp_optimum(
    state: ClusterState,
    graph: CommGraph,
    *,
    capacity_frac: float = 1.0,
    enforce_capacity: bool = True,
    time_limit_s: float = 120.0,
) -> tuple[float, bool]:
    """Exact MILP optimum of the COMM objective under capacity constraints
    (HiGHS branch-and-bound via scipy). Returns ``(optimal_cut, proven)``
    — ``proven`` is False if the time limit stopped the search first (the
    value is then the incumbent, still a valid upper bound on the optimum).
    """
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    W, cpu, placed, node_valid, cap, base = _problem_arrays(state, graph)
    nodes = np.flatnonzero(node_valid)
    N = len(nodes)
    movers = np.flatnonzero(placed)
    M = len(movers)
    iu, ju = np.nonzero(np.triu(W[np.ix_(movers, movers)], k=1))
    E = len(iu)
    wts = W[np.ix_(movers, movers)][iu, ju]
    nx = M * N  # x[s, n] flattened s-major
    nv = nx + E

    c = np.zeros(nv)
    c[nx:] = wts
    integrality = np.concatenate([np.ones(nx), np.zeros(E)])
    bounds = Bounds(np.zeros(nv), np.ones(nv))

    constraints = []
    # assignment: each mover on exactly one node
    A = lil_matrix((M, nv))
    for m in range(M):
        A[m, m * N : (m + 1) * N] = 1.0
    constraints.append(LinearConstraint(A.tocsr(), 1.0, 1.0))
    # cut linearization: z_e − x[s,n] + x[t,n] ≥ 0 for every node
    A = lil_matrix((E * N, nv))
    for e in range(E):
        for n in range(N):
            row = e * N + n
            A[row, nx + e] = 1.0
            A[row, iu[e] * N + n] = -1.0
            A[row, ju[e] * N + n] = 1.0
    constraints.append(LinearConstraint(A.tocsr(), 0.0, np.inf))
    if enforce_capacity:
        budget = np.where(cap > 0, cap, 1.0) * capacity_frac
        A = lil_matrix((N, nv))
        for n in range(N):
            for m in range(M):
                A[n, m * N + n] = cpu[movers[m]]
        constraints.append(
            LinearConstraint(
                A.tocsr(), -np.inf, budget[nodes] - base[nodes]
            )
        )

    res = milp(
        c,
        constraints=constraints,
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit_s},
    )
    if res.x is None:
        raise RuntimeError(f"MILP failed: {res.message}")
    proven = res.status == 0
    return float(res.fun), proven
