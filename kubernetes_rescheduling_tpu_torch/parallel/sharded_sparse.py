"""Node-axis-sharded SPARSE solver — the port of
``kubernetes_rescheduling_tpu.parallel.sharded_sparse``.

The single device's sparse solver (``solver/sparse_solver.py``) breaks the
dense SP² weight wall; this module shards its node axis over the mesh's
``tp`` ranks the way ``sharded_solver.py`` shards the dense solve:

- sharded: the per-node loads and capacities; each rank computes the
  chunk's neighbor mass for ITS node columns only (the plain mass twins
  take a ``col_offset``);
- replicated: the block-local weights (small: that is the point of the
  sparse form), the neighbor ids, the service vectors, the assignment and
  the COO edge list;
- per chunk step the shared ``sharded_place`` (and on swap sweeps
  ``sharded_swap``) of ``sharded_solver.py``: the decision math cannot fork
  from the dense sharded solver because it is the same function.

The sweep mirrors the single device's sparse solve (the hub groups first,
then the randomized regular chunks over the same composition), so with
annealing noise off and ``balance_weight`` 0 the sharded solve makes the
same decisions. It runs the plain mass twins (``reference_sparse_mass``,
``reference_hub_mass``), as the JAX package runs plain XLA here: the
kernels serve the single device's solve.
"""

from __future__ import annotations

import torch

from kubernetes_rescheduling_tpu_torch.core.sparsegraph import (
    BLOCK_R,
    SparseCommGraph,
    edge_cut_sum,
    rv_weighted_edge_w,
)
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState
from kubernetes_rescheduling_tpu_torch.ops.sparse_mass import (
    chunk_local_slabs,
    reference_hub_mass,
    reference_sparse_mass,
)
from kubernetes_rescheduling_tpu_torch.parallel.mesh import Mesh
from kubernetes_rescheduling_tpu_torch.parallel.sharded_solver import (
    _Balance,
    restart_plans,
    select_restart,
    shard_noise,
    shard_nodes,
    sharded_place,
    sharded_swap,
)
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    _DTYPES,
    GlobalSolverConfig,
    adopt,
    input_objective,
    node_caps,
    solve_result,
    sweep_temps,
)
from kubernetes_rescheduling_tpu_torch.solver.sparse_solver import (
    SparseLayout,
    draw_sparse_plans,
    hub_rvu,
    sorted_problem_arrays,
    sparse_layout,
    sparse_pod_comm_cost,
    sparse_tables,
)
from kubernetes_rescheduling_tpu_torch.solver.swap import swap_flags


def _solve_one(prep: dict, plan, config: GlobalSolverConfig, lay: SparseLayout,
               sgraph: SparseCommGraph, N: int, mesh: Mesh):
    """One node-sharded sparse solve on this rank; returns ``(best_assign
    [SPX], its raw exact objective)``."""
    assign_init, w_mm, rvu, rv_s = prep["assign0"], prep["w_mm"], prep["rvu"], prep["rv_s"]
    svc_valid, svc_cpu, svc_mem = prep["svc_valid"], prep["svc_cpu"], prep["svc_mem"]
    cap_l, mem_cap_l, base_cpu_l, base_mem_l, valid_l = prep["nodes"]
    tables, e_rvw = prep["tables"], prep["e_rvw"]
    dev = assign_init.device
    f32 = torch.float32
    ow = config.overload_weight if config.enforce_capacity else 0.0
    tp = mesh.shape["tp"]
    Nl = N // tp
    shard = mesh.coords["tp"]
    col0 = shard * Nl
    gcol = col0 + torch.arange(Nl, dtype=torch.int64, device=dev)[None, :]
    bu = sgraph.bu
    n_chunks, SPX, C_eff = lay.n_chunks, lay.spx, lay.width
    temps = sweep_temps(config).tolist()
    swf = swap_flags(config.sweeps, config.swap_every)
    use_swaps = config.swap_every > 0
    use_noise = config.noise_temp > 0
    balance = _Balance(cap_l, valid_l, config, ow, mesh)
    toff_ext, reg_ext = tables.toff_ext, tables.reg_ext
    row_iota = torch.arange(BLOCK_R, device=dev)
    chunk_pos = torch.arange(C_eff, dtype=torch.int32, device=dev)
    hub_groups = [(blocks_g, ids_g, u_gi, hub_rvu(sgraph, u_g, rv_s, SPX))
                  for blocks_g, ids_g, u_gi, u_g, _ in tables.hub_groups]

    def local_loads(assign):
        a = assign.long() - col0
        a = torch.where(svc_valid & (a >= 0) & (a < Nl), a, Nl)
        z = torch.zeros((Nl + 1,), dtype=f32, device=dev)
        return (base_cpu_l + z.index_put((a,), svc_cpu, accumulate=True)[:Nl],
                base_mem_l + z.index_put((a,), svc_mem, accumulate=True)[:Nl])

    def objective(assign, cpu_l):
        """The exact sparse cut (replicated edge list) plus the balance
        terms summed over the shards."""
        return edge_cut_sum(sgraph, e_rvw, assign) + balance(cpu_l)

    mc_on = config.move_cost > 0
    pen_vec = config.move_cost * rv_s if mc_on else None

    def objective_rank(assign, cpu_l):
        obj = objective(assign, cpu_l)
        if not mc_on:
            return obj
        return obj + config.move_cost * torch.sum(
            torch.where(svc_valid & (assign != assign_init), rv_s, 0.0))

    def place(assign, cpu_l, mem_l, ids, M, noise):
        new_node, admitted, _, d_cpu, d_mem = sharded_place(
            M, assign[ids], svc_valid[ids], svc_cpu[ids], svc_mem[ids], cpu_l, mem_l,
            cap_l, mem_cap_l, valid_l, gcol, N, config, ow, noise, mesh,
            home=assign_init[ids] if mc_on else None,
            move_pen=pen_vec[ids] if mc_on else None)
        assign[ids] = new_node
        return cpu_l + d_cpu, mem_l + d_mem, admitted

    def chunk_mass(tgt_c, rvu_c, blocks, ids, nn, off):
        """Mass of the chunk's rows against ``tgt_c`` over ``nn`` columns
        from ``off``: the shard's node columns for M, chunk positions for
        the swap phase's replicated pair weights."""
        raw = reference_sparse_mass(w_mm, tgt_c, rvu_c, blocks, toff_ext, num_nodes=nn,
                                    bu=bu, reg_tiles=sgraph.reg_tiles, col_offset=off)
        return raw * rv_s[ids][:, None]

    def noise_of(gumbel, seed, c, rows, temp):
        if not use_noise:
            return None
        return temp * shard_noise(gumbel, seed, c, rows, col0, Nl, shard, dev)

    assign = assign_init.clone()
    cpu_l, mem_l = local_loads(assign)
    best_assign, best_obj = assign, objective_rank(assign, cpu_l)
    for s, sp in enumerate(plan):
        temp = temps[s]
        assign = assign.clone()
        seeds = sp.seeds.tolist()
        for g, (blocks_g, ids_g, u_gi, rvu_g) in enumerate(hub_groups):
            raw = reference_hub_mass(sgraph, w_mm, assign[u_gi], rvu_g, num_nodes=Nl,
                                     blocks=blocks_g, col_offset=col0)
            noise = noise_of(sp.hub_gumbel, seeds[n_chunks + g], g, ids_g.shape[0], temp)
            cpu_l, mem_l, _ = place(assign, cpu_l, mem_l, ids_g, raw * rv_s[ids_g][:, None],
                                    noise)
        chunk_blocks = reg_ext[sp.block_perm.to(dev).long()].reshape(n_chunks,
                                                                     lay.blocks_per_chunk)
        chunk_ids = (chunk_blocks[:, :, None] * BLOCK_R + row_iota).reshape(n_chunks, C_eff)
        for c in range(n_chunks):
            blocks, ids = chunk_blocks[c], chunk_ids[c]
            u_c, rvu_c = chunk_local_slabs(sgraph.u_ids, rvu, toff_ext[blocks].long() * bu,
                                           sgraph.u_reg)
            u_ci = torch.clamp(u_c.long(), 0, SPX - 1)
            M = chunk_mass(assign[u_ci], rvu_c, blocks, ids, Nl, col0)
            cpu_l, mem_l, admitted = place(assign, cpu_l, mem_l, ids, M,
                                           noise_of(sp.gumbel, seeds[c], c, C_eff, temp))
            if not (use_swaps and swf[s]):
                continue
            pos = torch.full((SPX,), C_eff, dtype=torch.int32, device=dev)
            pos[ids] = chunk_pos
            Wc = chunk_mass(pos[u_ci], rvu_c, blocks, ids, C_eff, 0)
            new2, _, _, d_c, d_m = sharded_swap(
                M, Wc, assign[ids], svc_valid[ids] & ~admitted, svc_cpu[ids], svc_mem[ids],
                cpu_l, mem_l, cap_l, mem_cap_l, valid_l, gcol, config, ow, col0, mesh,
                home=assign_init[ids] if mc_on else None,
                move_pen=pen_vec[ids] if mc_on else None)
            assign[ids] = new2
            cpu_l, mem_l = cpu_l + d_c, mem_l + d_m
        cpu_l, mem_l = local_loads(assign)
        obj = objective_rank(assign, cpu_l)
        better = obj < best_obj
        best_assign = torch.where(better, assign, best_assign)
        best_obj = torch.where(better, obj, best_obj)
    # the sweeps ranked with the penalized objective; the adopt gate takes
    # the raw exact value and re-prices with the exact pod-level bill
    if mc_on:
        best_obj = objective(best_assign, local_loads(best_assign)[0])
    return best_assign, best_obj


def _validate(state, sgraph, config, mesh):
    if not config.capacity_frac > 0:
        raise ValueError(f"capacity_frac must be > 0, got {config.capacity_frac}")
    if sgraph.num_blocks <= 1:
        raise ValueError(
            "single-block sparse graphs delegate to the dense solver; use "
            "global_assign_sparse (or sharded_global_assign) instead"
        )
    if sgraph.weight_bytes() > config.max_weight_bytes:
        raise ValueError(
            f"sparse pair weights need {sgraph.weight_bytes() / 2**30:.2f} GiB — over "
            "max_weight_bytes; the graph is too dense for the sparse form (use the "
            "dense solver)."
        )
    tp = mesh.shape["tp"]
    N = state.num_nodes
    if N % tp:
        raise ValueError(f"num_nodes {N} must be a multiple of tp={tp}")
    return tp, sgraph.num_services, N


def _prep(state, sgraph, config, lay, mesh):
    """The solve's arrays — the single device's sparse preamble
    (``sorted_problem_arrays``, ``sparse_tables``), this shard's node
    vectors — and the budget-scaled capacities."""
    dev = state.device
    svc_valid, svc_cpu, svc_mem, cur_s, rv_s, rvu = sorted_problem_arrays(state, sgraph, lay.spx)
    cap, mem_cap = node_caps(state, config)
    prep = {
        "assign0": torch.where(svc_valid, torch.clamp(cur_s, 0, state.num_nodes - 1),
                               0).to(torch.int32),
        "w_mm": sgraph.w_local.to(_DTYPES[config.matmul_dtype]),
        "rvu": rvu, "rv_s": rv_s, "svc_valid": svc_valid, "svc_cpu": svc_cpu,
        "svc_mem": svc_mem, "e_rvw": rv_weighted_edge_w(sgraph, rv_s),
        "tables": sparse_tables(sgraph, lay, dev),
        "nodes": shard_nodes(mesh, cap, mem_cap, state.node_base_cpu, state.node_base_mem,
                             state.node_valid),
    }
    obj_true0 = input_objective(state, sparse_pod_comm_cost(state, sgraph), config, cap)
    S = sgraph.num_services
    pod_slot = torch.clamp(sgraph.inv[torch.clamp(state.pod_service, 0, S - 1).long()], 0,
                           lay.spx - 1).long()
    return prep, obj_true0, pod_slot


def sharded_sparse_assign(
    state: ClusterState,
    sgraph: SparseCommGraph,
    generator: torch.Generator | None,
    mesh: Mesh,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    *,
    plan: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """``global_assign_sparse`` with the node axis sharded over ``mesh``'s
    ``tp`` ranks. Requires ``num_nodes % tp == 0`` and at least 2 blocks
    (single-block graphs belong to the dense solver, as on one device).
    Never worse than the input placement. ``plan``: the
    ``SparseSweepPlan`` list, else drawn from ``generator``."""
    tp, _, N = _validate(state, sgraph, config, mesh)
    lay = sparse_layout(sgraph, config)
    if plan is None:
        plan = draw_sparse_plans(generator, config.sweeps, lay)
    prep, obj_true0, pod_slot = _prep(state, sgraph, config, lay, mesh)
    best_assign, best_obj = _solve_one(prep, plan, config, lay, sgraph, N, mesh)
    return solve_result(state, adopt(state, best_assign[pod_slot], best_obj, obj_true0,
                                     config.move_cost), tp=torch.tensor(tp))


def sharded_sparse_solve_with_restarts(
    state: ClusterState,
    sgraph: SparseCommGraph,
    generator: torch.Generator | None,
    mesh: Mesh,
    *,
    n_restarts: int = 1,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    plans: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """dp restarts OF tp-sharded sparse solves — the sparse twin of
    ``sharded_solver.sharded_solve_with_restarts``, with the same
    per-restart plans and the same selection (the gated, penalized value,
    the first minimum in global restart order)."""
    tp, _, N = _validate(state, sgraph, config, mesh)
    lay = sparse_layout(sgraph, config)
    mine = restart_plans(generator, plans, n_restarts, mesh,
                         lambda g: draw_sparse_plans(g, config.sweeps, lay))
    prep, obj_true0, pod_slot = _prep(state, sgraph, config, lay, mesh)
    solved = [_solve_one(prep, plan, config, lay, sgraph, N, mesh) for _, plan in mine]
    best_assign, best_raw, all_gated, best = select_restart(
        state, config, mesh, torch.stack([a for a, _ in solved]),
        torch.stack([o for _, o in solved]), pod_slot, obj_true0)
    return solve_result(state, adopt(state, best_assign[pod_slot], best_raw, obj_true0,
                                     config.move_cost),
                        restart_objectives=all_gated, best_restart=best, tp=torch.tensor(tp))
