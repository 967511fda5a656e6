"""Node-axis-sharded global solver — the port of
``kubernetes_rescheduling_tpu.parallel.sharded_solver``.

``global_assign`` holds the whole problem on one device. To spread a solve
over several, the node axis shards over the mesh's ``tp`` ranks:

- sharded: the occupancy columns ``X [SP, N/tp]``, the per-node loads and
  capacities; each rank scores its own node columns;
- replicated: the pair weights, the service vectors and the assignment
  (global node ids), so every rank agrees on every decision;
- collectives per chunk step, all O(C) values: a gather of each shard's
  top-1 (score, global index), and the current-node score and landing
  slack summed over the ``tp`` ranks (only the owning rank's term is
  nonzero). The pairwise admission race then runs replicated on the
  gathered vectors, through the port's plain ``pairwise_admission``.

Every sum over ranks is a gather followed by a sum in rank order
(``parallel.mesh.psum``), so a run repeats bit for bit. The decision math
mirrors the JAX package's term for term, so with annealing noise off the
sharded solve makes the single-device solve's moves (objective sums
associate differently across shards, so best-seen selection can differ on
exact ulp ties).

Plain torch on purpose, as the JAX package's is plain XLA: the single
device's kernels optimize launch count, while this structure exists to
spread memory and work over devices. The body runs op by op; it is not
captured, since its collectives synchronize the ranks at every step.

Randomness: the sweep plans (:class:`~kubernetes_rescheduling_tpu_torch.
solver.global_solver.SweepPlan`, full-permutation composition) are
replicated. The annealing noise is per shard, as the JAX package's
``fold_in(chunk_key, shard)``: a plan's ``gumbel`` [n_chunks, C, N] gives
every shard its own columns (the seam the tests feed), and without it each
shard draws its columns from the chunk's seed and its shard index.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch._random import derive_seed
from kubernetes_rescheduling_tpu_torch._random import gumbel as _gumbel
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph
from kubernetes_rescheduling_tpu_torch.objectives.metrics import (
    ROW_BLOCK,
    communication_cost,
)
from kubernetes_rescheduling_tpu_torch.ops.fused_admission import pairwise_admission
from kubernetes_rescheduling_tpu_torch.parallel.mesh import Mesh, gather, pmax, psum
from kubernetes_rescheduling_tpu_torch.parallel.sharded import (
    _pick,
    restart_generators,
)
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    _DTYPES,
    GlobalSolverConfig,
    _pad_to,
    _service_aggregates,
    adopt,
    auto_chunk,
    build_pair_weights,
    check_weight_budget,
    draw_plans,
    exact_comm_cost,
    input_objective,
    node_caps,
    restart_bill_from_arrays,
    solve_result,
    sweep_temps,
    total_pair_weight,
)
from kubernetes_rescheduling_tpu_torch.solver.swap import (
    BIG_CAP,
    swap_decisions,
    swap_desire,
    swap_flags,
    swap_subset,
)

_NEG_INF = float("-inf")


def _row_sum_where(mask, v) -> torch.Tensor:
    """``Σ_j where(mask[i, j], v[i, j], 0)`` per row: with one owning
    column per row across all shards, the rank-ordered sum of the shards'
    rows is that column's value exactly."""
    return torch.where(mask, v, 0.0).sum(dim=1)


def cols_at_local(M, cur, col0: int) -> torch.Tensor:
    """This shard's part of ``M_cur[i, j] = M[i, cur_j]``: the column where
    ``cur_j`` lies in the shard, 0 elsewhere (summed over the shards it is
    the single-device column gather, exactly)."""
    nl = M.shape[1]
    local = cur.long() - col0
    inside = (local >= 0) & (local < nl)
    return torch.where(inside[None, :], M[:, torch.clamp(local, 0, nl - 1)], 0.0)


def _load_delta(is_new, is_cur, amount) -> torch.Tensor:
    """Per-node load change of moving ``amount[i]`` from each row's
    current node to its new one, over this shard's columns."""
    a = amount[:, None]
    return (torch.where(is_new, a, 0.0) - torch.where(is_cur, a, 0.0)).sum(dim=0)


def sharded_swap(
    M, Wc, cur, eligible, c_cpu, c_mem, cpu_l, mem_l, cap_l, mem_cap_l,
    valid_l, gcol, config, ow, col0, mesh: Mesh, home=None, move_pen=None,
):
    """The swap phase with the node axis sharded: shard-local reductions
    summed over ``tp`` feed the same replicated core (``solver/swap.py``)
    the single device's ``chunk_swap`` runs, the desire-ranked top-k
    subset included, so the decisions cannot fork. Shared by the dense and
    sparse node-sharded solvers (``Wc`` is the only input whose
    computation differs). Returns ``(new_node, swapped, n_swaps, d_cpu_l,
    d_mem_l)``."""
    C = cur.shape[0]
    is_cur = gcol == cur[:, None]                       # (C, Nl)
    m_cur = psum(_row_sum_where(is_cur, M), mesh, "tp")

    def at_cur_of(is_at, v):
        return psum(_row_sum_where(is_at, v[None, :]), mesh, "tp")

    mem_cap_s = torch.where(torch.isinf(mem_cap_l), BIG_CAP, mem_cap_l)
    eligible = eligible & (at_cur_of(is_cur, valid_l.to(torch.float32)) > 0)
    pen_home = move_pen * (cur == home).to(torch.float32) if move_pen is not None else 0.0
    k = min(config.swap_k, C)
    if k < C:
        # replicated desire (local max, maxed over shards) → the shared
        # subset step: every shard selects the single device's candidates
        desire = swap_desire(pmax(M.max(dim=1).values, mesh, "tp"), m_cur, pen_home)
        sel, M_k, Wc_k, sub = swap_subset(desire, eligible, M, Wc, k)
    else:
        sel = torch.arange(C, device=M.device)
        M_k, Wc_k = M, Wc
        sub = lambda v: v  # noqa: E731
    cur_k = sub(cur)
    is_cur_k = gcol == cur_k[:, None]
    M_cur_k = psum(cols_at_local(M_k, cur_k, col0), mesh, "tp")  # (k, k)
    new_k, swapped_k, n_sw = swap_decisions(
        M_cur_k, sub(m_cur), Wc_k, cur_k, sub(eligible), sub(c_cpu), sub(c_mem),
        at_cur_of(is_cur_k, cpu_l), at_cur_of(is_cur_k, mem_l),
        at_cur_of(is_cur_k, cap_l), at_cur_of(is_cur_k, mem_cap_s),
        config.balance_weight, ow,
        pen=sub(move_pen) if move_pen is not None else None,
        home=sub(home) if home is not None else None,
        enforce_capacity=config.enforce_capacity,
    )
    new_node = cur.clone()
    new_node[sel] = new_k.to(cur.dtype)
    swapped = torch.zeros((C,), dtype=torch.bool, device=M.device)
    swapped[sel] = swapped_k
    is_new_k = gcol == new_k[:, None]
    d_cpu = _load_delta(is_new_k, is_cur_k, torch.where(swapped_k, sub(c_cpu), 0.0))
    d_mem = _load_delta(is_new_k, is_cur_k, torch.where(swapped_k, sub(c_mem), 0.0))
    return new_node, swapped, n_sw, d_cpu, d_mem


def sharded_place(
    M, cur, valid_c, c_cpu, c_mem, cpu_l, mem_l, cap_l, mem_cap_l, valid_l, gcol, N,
    config, ow, noise, mesh: Mesh, home=None, move_pen=None,
):
    """Shard-local score → global first-max → admission → per-node load
    deltas for one chunk, with the node axis sharded over ``tp``.

    ``M`` is the chunk's neighbor mass over THIS shard's node columns — the
    only input whose computation differs between the dense and the sparse
    node-sharded solvers; everything after it is this one function, so
    their decision math cannot fork. ``noise`` is this shard's [C, N/tp]
    annealing noise (temperature applied), or None. Returns ``(new_node,
    admitted, is_new, d_cpu, d_mem)``."""
    is_cur = gcol == cur[:, None]                       # (C, Nl)
    proj_cpu = cpu_l[None, :] + torch.where(is_cur, 0.0, c_cpu[:, None])
    proj_pct = proj_cpu / cap_l[None, :] * 100.0
    score = (
        M
        - config.balance_weight * proj_pct
        - ow * torch.clamp_min(proj_pct - 100.0, 0.0)
    )
    if move_pen is not None:
        # residency anywhere but the round-start node costs the restart
        # bill (global node ids: the shard owning `home` exempts it)
        score = score - torch.where(gcol == home[:, None], 0.0, move_pen[:, None])
    if noise is not None:
        score = score + noise
    if config.enforce_capacity:
        proj_mem = mem_l[None, :] + torch.where(is_cur, 0.0, c_mem[:, None])
        fits = (proj_cpu <= cap_l[None, :]) & (proj_mem <= mem_cap_l[None, :])
        feasible = (fits | is_cur) & valid_l[None, :]
    else:
        feasible = valid_l[None, :].expand(score.shape)

    masked = torch.where(feasible, score, _NEG_INF)
    loc_val = masked.max(dim=1).values                  # (C,)
    loc_idx = torch.where(masked == loc_val[:, None], gcol, N).min(dim=1).values
    cur_score = psum(_row_sum_where(is_cur, score), mesh, "tp")

    # global first-max: each shard's top-1, then among the shards at the
    # max score the lowest global index
    all_val = gather(loc_val, mesh, "tp")               # (tp, C)
    all_idx = gather(loc_idx, mesh, "tp")               # (tp, C)
    best_val = all_val.max(dim=0).values
    prop = torch.where(all_val == best_val[None, :], all_idx, N).min(dim=0).values
    prop = torch.clamp_max(prop, N - 1).to(cur.dtype)
    gain = best_val - cur_score
    wants = valid_c & (gain > 0) & (prop != cur)

    # the landing slack lives on the owning shard
    is_prop = gcol == prop[:, None]                     # (C, Nl)
    slack_cpu = psum(_row_sum_where(is_prop, (cap_l - cpu_l)[None, :]), mesh, "tp") - c_cpu
    mem_room = torch.where(torch.isinf(mem_cap_l), BIG_CAP, mem_cap_l) - mem_l
    slack_mem = psum(_row_sum_where(is_prop, mem_room[None, :]), mesh, "tp") - c_mem

    if config.enforce_capacity:
        # replicated vectors → the shared race, equal on every shard
        admitted = pairwise_admission(gain, prop, wants, c_cpu, c_mem, slack_cpu, slack_mem)
    else:
        admitted = wants

    new_node = torch.where(admitted, prop, cur)
    is_new = gcol == new_node[:, None]
    d_cpu = _load_delta(is_new, is_cur, torch.where(admitted, c_cpu, 0.0))
    d_mem = _load_delta(is_new, is_cur, torch.where(admitted, c_mem, 0.0))
    return new_node, admitted, is_new, d_cpu, d_mem


def shard_noise(plan_gumbel, seed, c: int, C: int, col0: int, nl: int, shard: int, dev):
    """This shard's unit gumbel columns of chunk ``c``: the plan's columns
    ``[col0, col0 + nl)`` when the plan carries noise, else drawn from
    the chunk's seed and the shard index."""
    if plan_gumbel is not None:
        return plan_gumbel[c][:, col0:col0 + nl].to(dev)
    gen = torch.Generator().manual_seed(derive_seed(int(seed), shard))
    return _gumbel((C, nl), gen, "cpu").to(dev)


class _Balance:
    """The objective's balance and over-budget terms over the sharded node
    vectors: the per-shard sums of pct and pct² added over ``tp``
    (one-pass variance, as the JAX package's sharded form)."""

    def __init__(self, cap_l, valid_l, config, ow, mesh):
        self.cap_l, self.valid_l, self.config, self.ow, self.mesh = cap_l, valid_l, config, ow, mesh
        self.nvalid = torch.clamp_min(psum(valid_l.sum(), mesh, "tp"), 1)

    def __call__(self, cpu_l):
        pct = torch.where(self.valid_l, cpu_l / self.cap_l * 100.0, 0.0)
        s1 = psum(pct.sum(), self.mesh, "tp")
        s2 = psum((pct * pct).sum(), self.mesh, "tp")
        mean = s1 / self.nvalid
        var = torch.clamp_min(s2 / self.nvalid - mean * mean, 0.0)
        over = psum(torch.clamp_min(pct - 100.0, 0.0).sum(), self.mesh, "tp")
        return self.config.balance_weight * torch.sqrt(var) + self.ow * over


def _dims(config: GlobalSolverConfig, S: int, N: int, tp: int):
    C = min(auto_chunk(S, config.chunk_size), S)
    n_chunks = -(-S // C)
    return C, n_chunks, n_chunks * C, N // tp


def _solve_one(args, plan, config: GlobalSolverConfig, S: int, N: int, mesh: Mesh):
    """One node-sharded dense solve on this rank: ``args`` from
    :func:`_prep` (the node vectors already this shard's), ``plan`` the
    per-sweep plans. Returns ``(best_assign [SP], exact objective)``."""
    (assign_init, adj, rv, W_mm, svc_valid, svc_cpu, svc_mem,
     cap_l, mem_cap_l, base_cpu_l, base_mem_l, valid_l) = args
    tp = mesh.shape["tp"]
    C, n_chunks, SP, Nl = _dims(config, S, N, tp)
    dev = assign_init.device
    f32 = torch.float32
    ow = config.overload_weight if config.enforce_capacity else 0.0
    shard = mesh.coords["tp"]
    col0 = shard * Nl
    gcol = col0 + torch.arange(Nl, dtype=torch.int64, device=dev)[None, :]  # (1, Nl)
    mm_dtype = W_mm.dtype
    temps = sweep_temps(config).tolist()
    swf = swap_flags(config.sweeps, config.swap_every)
    use_swaps = config.swap_every > 0 and C >= 2
    use_noise = config.noise_temp > 0
    balance = _Balance(cap_l, valid_l, config, ow, mesh)

    def local_loads(assign):
        of = ((assign[:, None] == gcol) & svc_valid[:, None]).to(f32)   # (SP, Nl)
        return base_cpu_l + svc_cpu @ of, base_mem_l + svc_mem @ of

    w_total = total_pair_weight(adj, rv)
    mc_on = config.move_cost > 0
    rv_sp = _pad_to(rv, SP)
    pen_vec = config.move_cost * rv_sp if mc_on else None

    def move_penalty(assign):
        return config.move_cost * torch.sum(
            torch.where(svc_valid & (assign != assign_init), rv_sp, 0.0))

    def objective_fast(assign, cpu_l):
        """Per-sweep ranking on the mm-dtype kept-mass form (the single
        device's ``objective_fast``)."""
        kept = torch.zeros((), dtype=f32, device=dev)
        for r0 in range(0, SP, ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, SP)
            same = assign[r0:r1, None] == assign[None, :]
            kept = kept + torch.where(same, W_mm[r0:r1], 0).sum(dtype=f32)
        obj = 0.5 * (w_total - kept) + balance(cpu_l)
        return obj + move_penalty(assign) if mc_on else obj

    def chunk_step(assign, X_l, cpu_l, mem_l, ids, noise, do_swap):
        valid_c = svc_valid[ids]
        c_cpu, c_mem = svc_cpu[ids], svc_mem[ids]
        cur = assign[ids]
        home = assign_init[ids] if mc_on else None
        pen = pen_vec[ids] if mc_on else None
        Wr = W_mm[ids]
        M = Wr.to(f32) @ X_l.to(f32)
        new_node, admitted, is_new, d_cpu, d_mem = sharded_place(
            M, cur, valid_c, c_cpu, c_mem, cpu_l, mem_l, cap_l, mem_cap_l, valid_l, gcol, N,
            config, ow, noise, mesh, home=home, move_pen=pen)
        assign[ids] = new_node
        X_l[ids] = (is_new & valid_c[:, None]).to(mm_dtype)
        cpu_l, mem_l = cpu_l + d_cpu, mem_l + d_mem
        if not (use_swaps and do_swap):
            return cpu_l, mem_l
        cur2 = assign[ids]
        Wc = Wr[:, ids].to(f32)  # the chunk's pair weights, replicated
        new2, _, _, d_c, d_m = sharded_swap(
            M, Wc, cur2, valid_c & ~admitted, c_cpu, c_mem, cpu_l, mem_l, cap_l, mem_cap_l,
            valid_l, gcol, config, ow, col0, mesh, home=home, move_pen=pen)
        assign[ids] = new2
        X_l[ids] = ((gcol == new2[:, None]) & valid_c[:, None]).to(mm_dtype)
        return cpu_l + d_c, mem_l + d_m

    assign = assign_init.clone()
    cpu0, _ = local_loads(assign)
    best_assign, best_obj = assign, objective_fast(assign, cpu0)
    for s, sp in enumerate(plan):
        assign = assign.clone()
        X_l = ((assign[:, None] == gcol) & svc_valid[:, None]).to(mm_dtype)
        cpu_l, mem_l = local_loads(assign)
        chunk_ids = sp.chunk_ids.to(dev).long()
        for c in range(n_chunks):
            noise = None
            if use_noise:
                g = shard_noise(sp.gumbel, sp.seeds[c], c, C, col0, Nl, shard, dev)
                noise = temps[s] * g
            cpu_l, mem_l = chunk_step(assign, X_l, cpu_l, mem_l, chunk_ids[c], noise,
                                      bool(swf[s]))
        # best-seen ranks on loads rebuilt from the assignment, as the
        # single device's objective does
        cpu_fresh, _ = local_loads(assign)
        obj = objective_fast(assign, cpu_fresh)
        better = obj < best_obj
        best_assign = torch.where(better, assign, best_assign)
        best_obj = torch.where(better, obj, best_obj)
    # exact f32 re-evaluation of the adopted placement
    cpu_best, _ = local_loads(best_assign)
    return best_assign, exact_comm_cost(adj, rv, best_assign) + balance(cpu_best)


def _check_and_dims(state, graph, config, mesh):
    if not config.capacity_frac > 0:
        raise ValueError(f"capacity_frac must be > 0, got {config.capacity_frac}")
    tp = mesh.shape["tp"]
    S = graph.num_services
    N = state.num_nodes
    if N % tp:
        raise ValueError(f"num_nodes {N} must be a multiple of tp={tp}")
    _, _, SP, _ = _dims(config, S, N, tp)
    check_weight_budget(SP, config)  # W is replicated under tp
    return tp, S, N, SP


def shard_nodes(mesh: Mesh, *vectors):
    """This rank's columns of per-node vectors."""
    nl = vectors[0].shape[0] // mesh.shape["tp"]
    col0 = mesh.coords["tp"] * nl
    return tuple(v[col0:col0 + nl] for v in vectors)


def _prep(state, graph, config, S, N, SP, mesh):
    """The solve's arrays: replicated problem data, then this shard's
    per-node vectors."""
    replicas, svc_cpu, svc_mem, cur_node, has_pods = _service_aggregates(state, S)
    svc_valid = _pad_to(graph.service_valid & has_pods, SP, False)
    svc_cpu = _pad_to(svc_cpu, SP)
    svc_mem = _pad_to(svc_mem, SP)
    replicas = _pad_to(replicas, SP)
    cur_node = _pad_to(cur_node, SP, -1)
    rv = (replicas * svc_valid)[:S]
    W_mm = build_pair_weights(graph.adj, rv, SP=SP, dtype=_DTYPES[config.matmul_dtype])
    cap, mem_cap = node_caps(state, config)
    assign0 = torch.where(svc_valid, torch.clamp(cur_node, 0, N - 1), 0).to(torch.int32)
    return (
        assign0, graph.adj, rv, W_mm, svc_valid, svc_cpu, svc_mem,
        *shard_nodes(mesh, cap, mem_cap, state.node_base_cpu, state.node_base_mem,
                     state.node_valid),
    ), cap


def _dense_plan(generator, config, S, N, tp):
    C, n_chunks, SP, _ = _dims(config, S, N, tp)
    return draw_plans(generator, config.sweeps, SP, C, n_chunks, 1)


def sharded_global_assign(
    state: ClusterState,
    graph: CommGraph,
    generator: torch.Generator | None,
    mesh: Mesh,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    plan: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """``global_assign`` with the node axis sharded over ``mesh``'s ``tp``
    ranks; every rank returns the same state. Requires ``num_nodes % tp ==
    0``; never worse than the input placement. ``plan`` (one
    ``SweepPlan`` a sweep, full-permutation composition) replaces the
    plans drawn from ``generator``."""
    tp, S, N, SP = _check_and_dims(state, graph, config, mesh)
    if plan is None:
        plan = _dense_plan(generator, config, S, N, tp)
    args, cap = _prep(state, graph, config, S, N, SP, mesh)
    best_assign, best_obj = _solve_one(args, plan, config, S, N, mesh)
    obj_true0 = input_objective(state, communication_cost(state, graph), config, cap)
    pod_slot = torch.clamp(state.pod_service, 0, SP - 1).long()
    new_state, info = solve_result(state, adopt(state, best_assign[pod_slot], best_obj,
                                                obj_true0, config.move_cost),
                                   tp=torch.tensor(tp))
    del info["improved"]  # the JAX package's dense sharded info has no such key
    return new_state, info


def select_restart(state, config, mesh, assigns, objs, pod_slot, obj_true0):
    """Best-of-N over the dp ranks: each restart ranked by its gated,
    penalized value ``min(raw + exact pod restart bill, input objective)``,
    the first minimum in global restart order (dp rank major). Returns
    ``(best assignment, its raw objective, the ranked values, the index)``."""
    pod_mask = state.pod_valid & (state.pod_node >= 0)
    bills = torch.stack([
        restart_bill_from_arrays(pod_mask, state.pod_node, a[pod_slot], config.move_cost)
        for a in assigns
    ])
    gated = torch.minimum(objs + bills, obj_true0)
    all_gated = gather(gated, mesh, "dp").reshape(-1)
    all_objs = gather(objs, mesh, "dp").reshape(-1)
    all_assigns = gather(assigns, mesh, "dp").reshape(all_gated.shape[0], -1)
    best = torch.argmin(all_gated)
    return _pick(all_assigns, best), _pick(all_objs, best), all_gated, best


def restart_plans(generator, plans, n_restarts, mesh, draw):
    """This dp rank's restarts as ``(index, plan)``: ``plans[i]`` when
    given, else restart ``i``'s plan drawn by ``draw`` from the ``i``-th
    restart generator (the same plan whatever the mesh)."""
    dp = mesh.shape.get("dp", 1)
    if n_restarts % dp:
        raise ValueError(f"n_restarts {n_restarts} must be a multiple of dp={dp}")
    if plans is not None and len(plans) != n_restarts:
        raise ValueError(f"{len(plans)} restart plans for {n_restarts} restarts")
    r_local = n_restarts // dp
    d = mesh.coords.get("dp", 0)
    gens = restart_generators(generator, n_restarts) if plans is None else None
    return [(i, plans[i] if plans is not None else draw(gens[i]))
            for i in range(d * r_local, (d + 1) * r_local)]


def sharded_solve_with_restarts(
    state: ClusterState,
    graph: CommGraph,
    generator: torch.Generator | None,
    mesh: Mesh,
    *,
    n_restarts: int = 1,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    plans: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """dp restarts OF tp-sharded solves — the full-mesh solve.

    ``n_restarts`` must be a multiple of the mesh's ``dp``; each dp rank
    runs its share of restarts in sequence while every solve shards the
    node axis over ``tp``. Restart ``i`` draws its plans as
    :func:`~kubernetes_rescheduling_tpu_torch.parallel.sharded.
    parallel_restarts` does (or takes ``plans[i]``), so with annealing
    noise off the composed path makes the single device's per-restart
    decisions and the dp-only path's selection."""
    tp, S, N, SP = _check_and_dims(state, graph, config, mesh)
    mine = restart_plans(generator, plans, n_restarts, mesh,
                         lambda g: _dense_plan(g, config, S, N, tp))
    args, cap = _prep(state, graph, config, S, N, SP, mesh)
    obj_true0 = input_objective(state, communication_cost(state, graph), config, cap)
    pod_slot = torch.clamp(state.pod_service, 0, SP - 1).long()
    solved = [_solve_one(args, plan, config, S, N, mesh) for _, plan in mine]
    best_assign, best_raw, all_gated, best = select_restart(
        state, config, mesh, torch.stack([a for a, _ in solved]),
        torch.stack([o for _, o in solved]), pod_slot, obj_true0)
    new_state, info = solve_result(state, adopt(state, best_assign[pod_slot], best_raw,
                                                obj_true0, config.move_cost),
                                   restart_objectives=all_gated, best_restart=best,
                                   tp=torch.tensor(tp))
    del info["improved"]
    return new_state, info


__all__ = [
    "sharded_global_assign",
    "sharded_place",
    "sharded_solve_with_restarts",
    "sharded_swap",
]
