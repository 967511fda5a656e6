"""Global solver over the sparse (block-local) pair weights — the port of
``kubernetes_rescheduling_tpu.solver.sparse_solver``.

Same optimization as :func:`~kubernetes_rescheduling_tpu_torch.solver.
global_solver.global_assign` — chunked synchronous best response over
service placements, exact cut cost plus the balance terms, never worse
than the input — but the pair weights live in the degree-sorted
block-local storage of ``core.sparsegraph`` instead of a dense SP×SP
matrix: memory O(S·Ū) instead of O(S²), so 50k services fit in about
0.4 GB where the dense form would need about 15 GB.

Two search-structure differences from the dense solver, both the JAX
package's:

1. **Hub pass.** The hub blocks (neighbor sets wider than the regular
   width) are re-placed once per sweep before the randomized chunks, in
   groups of at most KB blocks, each its own chunk step.
2. **Composition granularity.** Chunks are random sets of 256-service
   regular blocks, padded with all-zero dummy blocks. With
   ``degree_sort=False`` and no hub blocks the decisions equal the dense
   solver's inline path.

The per-sweep objective is the exact f32 cut sum over the COO edge list.

Lowerings (``kernel_lowering``): ``fused_epilogue="auto"`` runs the
kernels on CUDA tensors at any size; ``"on"`` runs the kernel lowering on
any device (through the wrappers' plain versions for CPU tensors);
``"off"`` is the plain twin (gathered matmuls and
``reference_score_admission`` with gumbel noise). The kernel lowering's
chunk step on sweeps without the swap phase is two launches that gather
nothing: ``sparse_mass_score_in_place`` reads the chunk's slabs and rows
through its block table, and ``admission_commit`` writes the assignment,
the carried loads and the move count in place. On swap sweeps it is the
gathered ``sparse_neighbor_mass`` → score → admission, plus
``sparse_neighbor_mass`` again for the chunk-local pair weights and
kernels 7 and 8; the hub pass is ``hub_neighbor_mass`` → score →
admission.

Randomness goes through a per-sweep :class:`SparseSweepPlan` (block
permutation, kernel seeds, plain-path gumbel noise), drawn from a
``torch.Generator`` or handed in by the caller: the parity tests build it
from the JAX package's key stream. A solve reads nothing back to the host
(:func:`sparse_pod_comm_cost` picks its branch on the device), so on CUDA
it runs as one replay of a CUDA graph captured per solve shape, as the
dense solve does (``solver/compiled.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kubernetes_rescheduling_tpu_torch.core.sparsegraph import (
    BLOCK_R,
    SparseCommGraph,
    edge_cut_sum,
    rv_weighted_edge_w,
    sparse_pair_comm_cost,
)
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph, _count
from kubernetes_rescheduling_tpu_torch.objectives.metrics import load_std
from kubernetes_rescheduling_tpu_torch.ops.fused_admission import (
    admission_commit,
    fused_score_admission,
    reference_score_admission,
)
from kubernetes_rescheduling_tpu_torch.ops.sparse_mass import (
    chunk_local_slabs,
    hub_mass_plain,
    hub_neighbor_mass,
    hub_tile_arrays,
    reference_sparse_mass,
    sparse_mass_score_in_place,
    sparse_neighbor_mass,
)
from kubernetes_rescheduling_tpu_torch._random import gumbel as _gumbel
from kubernetes_rescheduling_tpu_torch.solver.global_solver import (
    _DTYPES,
    GlobalSolverConfig,
    _pad_to,
    _service_aggregates,
    _stacked,
    adopt,
    auto_chunk,
    check_solve_args,
    collapsed_placement,
    global_assign,
    input_objective,
    kernel_lowering,
    node_caps,
    pct_balance_terms,
    noise_generator,
    solve_result,
    state_from_inputs,
    state_inputs,
    sweep_temps,
)
from kubernetes_rescheduling_tpu_torch.solver.compiled import CACHE, to_device
from kubernetes_rescheduling_tpu_torch.solver.swap import (
    BIG_CAP,
    chunk_swap_phase,
    commit_moves,
    scan_sweeps,
    swap_flags,
)
from kubernetes_rescheduling_tpu_torch.telemetry.phases import END, phase_mark

# The noise seed law: the fused mass+score kernel seeds 256-row block i of
# a chunk with seed + i, the standalone score kernel tile t with seed + t.
# The two streams coincide only when the score stage tiles at exactly
# BLOCK_R rows, so the solver pins its tile here.
_SCORE_BLOCK_C = 256
assert _SCORE_BLOCK_C == BLOCK_R, "the score stage must tile at BLOCK_R rows"


@dataclass(frozen=True)
class SparseLayout:
    """How a sparse graph is cut into chunk steps under a config:
    ``chunk`` (C), ``blocks_per_chunk`` (KB 256-row blocks), ``n_chunks``
    regular chunks padded with ``n_dummy`` all-zero blocks, ``spx`` (the
    service-array size with the dummy blocks), and the hub blocks in
    ``hub_groups`` of at most KB blocks each."""

    chunk: int
    blocks_per_chunk: int
    n_chunks: int
    n_dummy: int
    spx: int
    hub_groups: tuple[tuple[int, ...], ...]

    @property
    def width(self) -> int:
        """Rows of one chunk step: KB·256."""
        return self.blocks_per_chunk * BLOCK_R


def sparse_layout(sgraph: SparseCommGraph, config: GlobalSolverConfig) -> SparseLayout:
    S = sgraph.num_services
    C = min(auto_chunk(S, config.chunk_size), S)
    KB = max(1, C // BLOCK_R)
    NBR = len(sgraph.regular_blocks)
    n_chunks = max(1, -(-NBR // KB)) if NBR else 0
    n_dummy = n_chunks * KB - NBR
    hubs = sgraph.hub_blocks
    return SparseLayout(
        chunk=C,
        blocks_per_chunk=KB,
        n_chunks=n_chunks,
        n_dummy=n_dummy,
        spx=sgraph.sp + n_dummy * BLOCK_R,
        hub_groups=tuple(hubs[g:g + KB] for g in range(0, len(hubs), KB)),
    )


@dataclass(frozen=True)
class SparseSweepPlan:
    """The random decisions of one sparse sweep.

    ``block_perm`` [n_chunks·KB]: the permutation of regular block slots
    (dummies included) that composes the chunks; ``seeds`` [n_chunks +
    n_hub_groups]: the score kernels' noise seeds, chunks first, then hub
    groups (read from device memory); ``gumbel`` [n_chunks, KB·256, N] and
    ``hub_gumbel`` (one [rows_g, N] per hub group), or None: unit gumbel
    noise of the plain path (None draws it from the solver's generator)."""

    block_perm: torch.Tensor
    seeds: torch.Tensor
    gumbel: torch.Tensor | None = None
    hub_gumbel: tuple[torch.Tensor, ...] | None = None


def extended_block_tables(sgraph: SparseCommGraph, layout: SparseLayout, device):
    """The chunk steps' block tables on ``device``: every block's first W
    column tile with the dummy blocks' (the zero strip) appended,
    i32[NB + n_dummy], and the regular block ids followed by the dummy ids,
    i32[n_chunks·KB] — the slots a sweep's block permutation draws (i32,
    as the mass kernels read them: no conversion copy per chunk)."""
    toff_ext = torch.tensor(
        list(sgraph.block_toff) + [sgraph.zero_toff] * layout.n_dummy,
        dtype=torch.int32, device=device,
    )
    reg_ext = torch.tensor(
        list(sgraph.regular_blocks) + [sgraph.num_blocks + d for d in range(layout.n_dummy)],
        dtype=torch.int32, device=device,
    )
    return toff_ext, reg_ext


def draw_sparse_plans(generator: torch.Generator, sweeps: int,
                      layout: SparseLayout) -> list[SparseSweepPlan]:
    """``sweeps`` plans from ``generator`` (a CPU generator): each sweep's
    block permutation and kernel seeds."""
    plans = []
    for _ in range(sweeps):
        bp = torch.randperm(layout.n_chunks * layout.blocks_per_chunk, generator=generator)
        seeds = torch.randint(
            0, 2**31 - 1, (layout.n_chunks + len(layout.hub_groups),), generator=generator
        )
        plans.append(SparseSweepPlan(bp, seeds))
    return plans


def sparse_pod_comm_cost(
    state: ClusterState, sgraph: SparseCommGraph, *, edge_chunk: int = 16384
) -> torch.Tensor:
    """Pod-level communication cost of the ACTUAL placement (replicas may
    be split across nodes).

    Per sorted-space edge (s, t, w): cross-node pod pairs = ``rv_s·rv_t −
    Σ_n cnt[s,n]·cnt[t,n]``, subtracted per edge so the f32 error stays
    per-edge small, halved because the COO list carries each edge twice,
    scanned in edge chunks. When every service's counted pods sit on one
    node (every solver output does) the cost is the service-level cut of
    (first node, effective replicas); both forms are computed and the
    branch is picked on the device, so nothing is read back."""
    SP = sgraph.sp
    N = state.num_nodes
    S = sgraph.num_services
    pod_slot = sgraph.inv[torch.clamp(state.pod_service, 0, S - 1).long()]
    slot = torch.where(state.pod_valid, pod_slot, SP)
    node = torch.clamp(torch.where(state.pod_valid, state.pod_node, N), -1, N)
    # pods counted by the general form: valid AND placed on a real node
    placed = state.pod_valid & (node >= 0) & (node < N)
    nmin, rv_eff, collapsed = collapsed_placement(slot, node, placed, SP, N)
    fast = sparse_pair_comm_cost(sgraph, nmin, rv_eff)
    flat = torch.where(placed, slot.long() * (N + 1) + node.long(), SP * (N + 1) + N)
    cnt = _count(flat, (SP + 1) * (N + 1)).view(SP + 1, N + 1)
    cnt = cnt[:SP, :N].to(torch.float32)
    rv = cnt.sum(dim=1)
    total = torch.zeros((), dtype=torch.float32, device=cnt.device)
    E2 = sgraph.edges_src.shape[0]
    for e0 in range(0, E2, edge_chunk):
        s = sgraph.edges_src[e0:e0 + edge_chunk].long()
        t = sgraph.edges_dst[e0:e0 + edge_chunk].long()
        kept = torch.sum(cnt[s] * cnt[t], dim=1)
        cross = torch.clamp_min(rv[s] * rv[t] - kept, 0.0)
        total = total + torch.sum(sgraph.edges_w[e0:e0 + edge_chunk] * cross)
    return torch.where(collapsed, fast, 0.5 * total)


def sorted_problem_arrays(state: ClusterState, sgraph: SparseCommGraph, SPX: int):
    """Sorted-space per-service arrays and the neighbor replica columns,
    padded to ``SPX`` (the service count with the dummy chunk-padding
    blocks). Returns ``(svc_valid, svc_cpu_s, svc_mem_s, cur_s, rv_s,
    rvu)``."""
    S = sgraph.num_services
    replicas, svc_cpu, svc_mem, cur_node, has_pods = _service_aggregates(state, S)
    perm = sgraph.perm.long()
    pclip = torch.clamp(perm, 0, S - 1)
    ok = perm < S

    def sort_pad(x, fill=0.0):
        return _pad_to(torch.where(ok, x[pclip], fill), SPX, fill)

    svc_valid = _pad_to(ok & has_pods[pclip] & sgraph.service_valid, SPX, False)
    svc_cpu_s = sort_pad(svc_cpu) * svc_valid
    svc_mem_s = sort_pad(svc_mem) * svc_valid
    cur_s = torch.where(svc_valid, sort_pad(cur_node, -1), -1)
    rv_s = sort_pad(replicas) * svc_valid
    # neighbor-column replica factor, 0 on padding columns: the mass
    # kernels rely on this as the padding mask
    u = sgraph.u_ids.long()
    rvu = torch.where(u < sgraph.sp, rv_s[torch.clamp(u, 0, SPX - 1)], 0.0)
    return svc_valid, svc_cpu_s, svc_mem_s, cur_s, rv_s, rvu


def hub_slab_ids(sgraph: SparseCommGraph, blocks) -> torch.Tensor:
    """Concatenated group-local neighbor ids of the given hub ``blocks`` —
    static slices of ``u_ids``."""
    bu = sgraph.bu
    return torch.cat([
        sgraph.u_ids[sgraph.block_toff[b] * bu:(sgraph.block_toff[b] + sgraph.block_ntiles[b]) * bu]
        for b in blocks
    ])


def hub_rvu(sgraph: SparseCommGraph, u_g: torch.Tensor, rv_s: torch.Tensor, SPX: int):
    """The replica factors of a hub group's neighbor columns ``u_g`` (0 on
    padding columns)."""
    ug = u_g.long()
    return torch.where(ug < sgraph.sp, rv_s[torch.clamp(ug, 0, SPX - 1)], 0.0)


def global_assign_sparse(
    state: ClusterState,
    sgraph: SparseCommGraph,
    generator: torch.Generator | None = None,
    config: GlobalSolverConfig = GlobalSolverConfig(),
    plan: list | None = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """Sparse twin of ``global_assign``, same contract: the new state and
    solve info; never worse than the input placement. ``generator`` draws
    the per-sweep plans unless ``plan`` (:class:`SparseSweepPlan` list)
    gives them.

    Single-block graphs (≤ 256 services) delegate to the dense solver (one
    chunk per sweep would leave no sequencing between chunks, and at that
    size the dense form costs nothing); ``plan`` is then the dense
    solver's."""
    if sgraph.num_blocks <= 1 and sgraph.dense_adj is not None:
        S = sgraph.num_services
        dense = CommGraph(
            adj=sgraph.dense_adj,
            service_valid=torch.ones((S,), dtype=torch.bool, device=sgraph.dense_adj.device),
            names=sgraph.names,
        )
        new_state, info = global_assign(state, dense, generator, config, plan=plan)
        return new_state, dict(info, hub_pass=torch.tensor(False))
    return _global_assign_sparse(state, sgraph, generator, config, plan)


SPARSE_OPERANDS = ("w_local", "u_ids", "edges_src", "edges_dst", "edges_w", "perm", "inv",
                   "service_valid")


def sparse_static(sgraph: SparseCommGraph) -> tuple:
    """The graph's host metadata: with the operands' identities it keys a
    captured sparse solve."""
    return (sgraph.block_toff, sgraph.block_ntiles, sgraph.hub_blocks, sgraph.regular_blocks,
            sgraph.zero_toff, sgraph.bu, sgraph.reg_tiles, sgraph.num_services)


def sparse_plan_inputs(plan, lay: SparseLayout, config: GlobalSolverConfig, N: int, dev,
                       generator=None) -> dict[str, torch.Tensor]:
    """A sparse solve's plans as inputs, stacked over the sweeps and on
    ``dev``: ``block_perm``, ``seeds`` (i32), ``temps``; on the plain path
    with noise also ``gumbel`` [sweeps, n_chunks, KB·256, N] and one
    ``hub_gumbel_<g>`` [sweeps, rows_g, N] per hub group, drawn here from
    ``generator`` where the plan has none."""
    nb, G = lay.n_chunks * lay.blocks_per_chunk, len(lay.hub_groups)
    t = {
        "block_perm": _stacked([p.block_perm for p in plan], (0, nb), torch.int64, dev),
        "seeds": _stacked([p.seeds for p in plan], (0, lay.n_chunks + G), torch.int32, dev),
        "temps": to_device(sweep_temps(config), dev),
    }
    if kernel_lowering(config, dev) or not config.noise_temp > 0:
        return t
    noise_gen = None
    if any(p.gumbel is None or (G and p.hub_gumbel is None) for p in plan):
        noise_gen = noise_generator(generator, dev)
    chunks, hubs = [], [[] for _ in range(G)]
    for p in plan:
        for g, blocks_g in enumerate(lay.hub_groups):
            hubs[g].append(p.hub_gumbel[g].to(dev) if p.hub_gumbel is not None
                           else _gumbel((len(blocks_g) * BLOCK_R, N), noise_gen, dev))
        chunks.append(p.gumbel.to(dev) if p.gumbel is not None
                      else _gumbel((lay.n_chunks, lay.width, N), noise_gen, dev))
    t["gumbel"] = _stacked(chunks, (0, lay.n_chunks, lay.width, N), torch.float32, dev)
    for g, blocks_g in enumerate(lay.hub_groups):
        t[f"hub_gumbel_{g}"] = _stacked(hubs[g], (0, len(blocks_g) * BLOCK_R, N),
                                        torch.float32, dev)
    return t


@dataclass(frozen=True)
class SparseTables:
    """Host-built tables of a sparse solve, on the device once per solve
    shape: the extended block tables (:func:`extended_block_tables`), and
    per hub group its blocks, row ids, clamped neighbor ids, neighbor ids
    and tile arrays (:func:`hub_tile_arrays`)."""

    toff_ext: torch.Tensor
    reg_ext: torch.Tensor
    hub_groups: tuple


def sparse_tables(sgraph: SparseCommGraph, lay: SparseLayout, dev) -> SparseTables:
    toff_ext, reg_ext = extended_block_tables(sgraph, lay, dev)
    row_iota = torch.arange(BLOCK_R, device=dev)
    groups = []
    for blocks_g in lay.hub_groups:
        ids_g = torch.cat([row_iota + b * BLOCK_R for b in blocks_g])
        u_g = hub_slab_ids(sgraph, blocks_g)
        u_gi = torch.clamp(u_g.long(), 0, lay.spx - 1)
        groups.append((blocks_g, ids_g, u_gi, u_g, hub_tile_arrays(sgraph, blocks_g, dev)))
    return SparseTables(toff_ext, reg_ext, tuple(groups))


def _global_assign_sparse(state, sgraph, generator, config, plan):
    check_solve_args(config, plan, generator, "global_assign_sparse")
    if sgraph.weight_bytes() > config.max_weight_bytes:
        raise ValueError(
            f"sparse pair weights need {sgraph.weight_bytes() / 2**30:.2f} GiB — over "
            "max_weight_bytes; the graph is too dense for the sparse form (use the "
            "dense solver)."
        )
    dev = state.device
    lay = sparse_layout(sgraph, config)
    if plan is None:
        plan = draw_sparse_plans(generator, config.sweeps, lay)
    inputs = {**state_inputs(state),
              **sparse_plan_inputs(plan, lay, config, state.num_nodes, dev, generator)}

    def make_body():
        tables = sparse_tables(sgraph, lay, dev)
        return lambda t: sparse_solve(state_from_inputs(t), sgraph, config, lay, tables, t)

    out = CACHE.run("global_assign_sparse", (config, lay, sparse_static(sgraph)), inputs,
                    make_body, operands=[getattr(sgraph, k) for k in SPARSE_OPERANDS])
    return solve_result(state, out, hub_pass=torch.tensor(len(lay.hub_groups) > 0))


def sparse_solve(
    state: ClusterState,
    sgraph: SparseCommGraph,
    config: GlobalSolverConfig,
    lay: SparseLayout,
    tables: SparseTables,
    t: dict,
) -> dict[str, torch.Tensor]:
    """One sparse solve as a function of device tensors that reads nothing
    back to the host: ``t`` holds the plans (:func:`sparse_plan_inputs`).
    Returns the new ``pod_node`` and the info tensors. Marks the phases
    ``setup``, ``hubs``, ``sweeps`` / ``swap_sweeps`` and ``ranking`` a
    sweep, and ``epilogue`` (``telemetry/phases.py``)."""
    phase_mark("setup")
    dev = state.device
    f32 = torch.float32
    ow = config.overload_weight if config.enforce_capacity else 0.0
    lam = config.balance_weight
    S = sgraph.num_services
    N = state.num_nodes
    bu, reg_tiles = sgraph.bu, sgraph.reg_tiles
    n_chunks, SPX, C_eff = lay.n_chunks, lay.spx, lay.width

    svc_valid, svc_cpu_s, svc_mem_s, cur_s, rv_s, rvu = sorted_problem_arrays(state, sgraph, SPX)
    w_mm = sgraph.w_local.to(_DTYPES[config.matmul_dtype])

    node_valid = state.node_valid
    cap, mem_cap = node_caps(state, config)

    assign0 = torch.where(svc_valid, torch.clamp(cur_s, 0, N - 1), 0).to(torch.int32)
    # disruption pricing: per-service restart bill anchored at assign0
    mc_on = config.move_cost > 0
    pen_vec = config.move_cost * rv_s if mc_on else None
    pod_slot = torch.clamp(
        sgraph.inv[torch.clamp(state.pod_service, 0, S - 1).long()], 0, SPX - 1
    ).long()

    def move_penalty(assign):
        """Service-level restart bill: the cheap per-sweep ranking form;
        the adopt gate uses the exact pod-level bill."""
        return config.move_cost * torch.sum(torch.where(svc_valid & (assign != assign0), rv_s, 0.0))

    def loads(assign):
        a = torch.where(svc_valid, assign, N).long()
        z = torch.zeros((N + 1,), dtype=f32, device=dev)
        cpu = z.index_put((a,), svc_cpu_s, accumulate=True)[:N]
        mem = z.index_put((a,), svc_mem_s, accumulate=True)[:N]
        return state.node_base_cpu + cpu, state.node_base_mem + mem

    def _balance_terms(cpu_load):
        return pct_balance_terms(cpu_load, cap, node_valid, lam, ow)

    # per-edge rv-weighted weight, once per solve: each sweep's cut sum
    # then gathers only the two assign columns
    e_rvw = rv_weighted_edge_w(sgraph, rv_s)

    def objective_terms(assign, cpu_load):
        """(exact comm, ranking objective) of a sweep's placement."""
        comm = edge_cut_sum(sgraph, e_rvw, assign)
        obj = comm + _balance_terms(cpu_load)
        return comm, (obj + move_penalty(assign) if mc_on else obj)

    use_kernels = kernel_lowering(config, dev)
    use_noise = config.noise_temp > 0

    toff_ext, reg_ext = tables.toff_ext, tables.reg_ext
    row_iota = torch.arange(BLOCK_R, device=dev)
    hub_groups = []
    for blocks_g, ids_g, u_gi, u_g, tiles in tables.hub_groups:
        hub_groups.append((blocks_g, ids_g, u_gi, hub_rvu(sgraph, u_g, rv_s, SPX), tiles))

    gumbel = t.get("gumbel")
    plan = [
        SparseSweepPlan(
            t["block_perm"][i], t["seeds"][i],
            None if gumbel is None else gumbel[i],
            tuple(t[f"hub_gumbel_{g}"][i] for g in range(len(hub_groups))) if gumbel is not None
            else None,
        )
        for i in range(config.sweeps)
    ]
    temps = list(t["temps"].unbind(0)) if config.sweeps else []

    def chunk_mass(tgt_c, rvu_c, blocks, ids, nn):
        """Mass of the chunk's rows against targets ``tgt_c`` over ``nn``
        columns: node occupancy for M (nn = N), chunk position for the swap
        phase's pair-weight block Wc (nn = KB·256)."""
        mass = sparse_neighbor_mass if use_kernels else reference_sparse_mass
        raw = mass(w_mm, tgt_c, rvu_c, blocks, toff_ext, num_nodes=nn, bu=bu,
                   reg_tiles=reg_tiles)
        return raw * rv_s[ids][:, None]

    def hub_mass(assign, group):
        blocks_g, ids_g, u_gi, rvu_g, tiles = group
        mass = hub_neighbor_mass if use_kernels else hub_mass_plain
        raw = mass(w_mm, assign[u_gi], rvu_g, *tiles, num_nodes=N,
                   num_hub_blocks=len(blocks_g), bu=bu)
        return raw * rv_s[ids_g][:, None]

    def place(assign, cpu_load, mem_load, ids, M, temp, seed, gumbel):
        """Score → argmax → admission → commit for one id set (the hub
        pass and the chunks); ``assign`` is updated in place. Returns the
        new loads and the admitted mask."""
        valid_c = svc_valid[ids]
        c_cpu = svc_cpu_s[ids]
        c_mem = svc_mem_s[ids]
        cur = assign[ids]
        home = assign0[ids] if mc_on else None
        pen = pen_vec[ids] if mc_on else None
        if use_kernels:
            new_node, admitted, d_cpu, d_mem = fused_score_admission(
                M, cur, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap, node_valid,
                lam, temp, seed, overload_weight=ow, home=home, move_pen=pen,
                enforce_capacity=config.enforce_capacity, use_noise=use_noise,
                block_c=_SCORE_BLOCK_C, emit_x_rows=False,
            )
            assign[ids] = new_node
            return cpu_load + d_cpu, mem_load + d_mem, admitted
        noise = temp * gumbel if use_noise else None
        new_node, admitted = reference_score_admission(
            M, cur, c_cpu, c_mem, valid_c, cpu_load, mem_load, cap, mem_cap, node_valid,
            lam, noise, overload_weight=ow, home=home, move_pen=pen,
            enforce_capacity=config.enforce_capacity,
        )
        cpu_load, mem_load = commit_moves(cpu_load, mem_load, cur, new_node, admitted, c_cpu,
                                          c_mem)
        assign[ids] = new_node
        return cpu_load, mem_load, admitted

    # pairwise-exchange phase on flagged sweeps, per regular chunk; hub
    # groups sit it out, as in the JAX package
    use_swaps = config.swap_every > 0
    sw_flags = swap_flags(config.sweeps, config.swap_every)
    mem_cap_sw = torch.where(torch.isinf(mem_cap), BIG_CAP, mem_cap)
    chunk_pos = torch.arange(C_eff, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def chunk_steps_in_place(chunk_blocks, assign, cpu_load, mem_load, temp, seeds):
        """A plain sweep's chunk steps under the kernel lowering, two
        launches each: kernel 6 reads the chunk's slabs and rows through its
        block table, kernel 3 commits the assignment, the carried loads and
        the move count in place. Returns the sweep's chunk moves."""
        moved = torch.zeros((), dtype=torch.int64, device=dev)
        for c in range(n_chunks):
            blocks = chunk_blocks[c]
            scored = sparse_mass_score_in_place(
                w_mm, sgraph.u_ids, rvu, assign, blocks, toff_ext, rv_s,
                assign0 if mc_on else None, pen_vec, svc_cpu_s, svc_mem_s, svc_valid, cpu_load,
                mem_load, cap, mem_cap, node_valid, lam, temp, seeds[c], ow, num_nodes=N, bu=bu,
                reg_tiles=reg_tiles, enforce_capacity=config.enforce_capacity,
                use_noise=use_noise,
            )
            admission_commit(*scored, blocks, assign, svc_valid, svc_cpu_s, svc_mem_s, cpu_load,
                             mem_load, moved, num_nodes=N,
                             enforce_capacity=config.enforce_capacity)
        return moved

    def make_sweep(do_swap: bool):
        swap_now = use_swaps and do_swap
        phase = "swap_sweeps" if swap_now else "sweeps"
        in_place = use_kernels and not swap_now

        def sweep(carry, xs):
            phase_mark("hubs")
            sp, temp = xs
            assign, cpu_load, mem_load, best_assign, best_obj, best_comm = carry
            assign = assign.clone()
            seeds = sp.seeds
            moves, sws = zero, zero
            # hubs first, on the freshest loads; each group reads the
            # assignment the groups before it left
            for g, group in enumerate(hub_groups):
                M = hub_mass(assign, group)
                cpu_load, mem_load, adm = place(
                    assign, cpu_load, mem_load, group[1], M, temp, seeds[n_chunks + g],
                    None if sp.hub_gumbel is None else sp.hub_gumbel[g],
                )
                moves = moves + adm.sum()
            phase_mark(phase)
            chunk_blocks = reg_ext[sp.block_perm.long()].reshape(n_chunks, lay.blocks_per_chunk)
            if in_place:
                moves = moves + chunk_steps_in_place(chunk_blocks, assign, cpu_load, mem_load,
                                                      temp, seeds)
            else:
                chunk_ids = (chunk_blocks[:, :, None] * BLOCK_R + row_iota).reshape(
                    n_chunks, C_eff)
                for c in range(n_chunks):
                    blocks, ids = chunk_blocks[c], chunk_ids[c]
                    u_c, rvu_c = chunk_local_slabs(sgraph.u_ids, rvu,
                                                   toff_ext[blocks].long() * bu, sgraph.u_reg)
                    u_ci = torch.clamp(u_c.long(), 0, SPX - 1)
                    M = chunk_mass(assign[u_ci], rvu_c, blocks, ids, N)
                    cpu_load, mem_load, admitted = place(
                        assign, cpu_load, mem_load, ids, M, temp, seeds[c],
                        None if sp.gumbel is None else sp.gumbel[c],
                    )
                    moves = moves + admitted.sum()
                    if not swap_now:
                        continue
                    # chunk-local pair weights through the same mass step,
                    # with "node" = chunk position: Wc[i, j] = W[i, ids_j]
                    pos = torch.full((SPX,), C_eff, dtype=torch.int32, device=dev)
                    pos[ids] = chunk_pos
                    Wc = chunk_mass(pos[u_ci], rvu_c, blocks, ids, C_eff)
                    cpu_load, mem_load, n_sw = chunk_swap_phase(
                        M, Wc, None, assign, ids, svc_valid, admitted, node_valid, svc_cpu_s,
                        svc_mem_s, cpu_load, mem_load, cap, mem_cap_sw, lam, ow, pen_vec,
                        assign0 if mc_on else None, config.swap_k,
                        enforce_capacity=config.enforce_capacity, use_kernels=use_kernels)
                    sws = sws + n_sw
            # refresh the carried loads at each sweep boundary: incremental
            # f32 drift stays bounded to one sweep
            phase_mark("ranking")
            cpu_fresh, mem_fresh = loads(assign)
            comm, obj = objective_terms(assign, cpu_fresh)
            better = obj < best_obj
            best_assign = torch.where(better, assign, best_assign)
            best_obj = torch.where(better, obj, best_obj)
            best_comm = torch.where(better, comm, best_comm)
            return (assign, cpu_fresh, mem_fresh, best_assign, best_obj, best_comm), (moves, sws)

        return sweep

    # the adopt gate compares against the input's true objective
    comm_true0 = sparse_pod_comm_cost(state, sgraph)
    obj_true0 = input_objective(state, comm_true0, config, cap)
    cpu0, mem0 = loads(assign0)
    comm0, obj0 = objective_terms(assign0, cpu0)
    (_, _, _, best_assign, best_obj, best_comm), outs = scan_sweeps(
        make_sweep, (assign0, cpu0, mem0, assign0, obj0, comm0), plan, temps, sw_flags
    )
    phase_mark("epilogue")
    moves_per_sweep = torch.stack([m for m, _ in outs]) if outs else zero[None][:0]
    swaps_per_sweep = torch.stack([s for _, s in outs]) if outs else zero[None][:0]

    # under disruption pricing the adopt gate re-prices with the exact
    # pod-level restart bill; the reported objective stays raw
    raw_after = best_comm + _balance_terms(loads(best_assign)[0]) if mc_on else best_obj
    out = adopt(state, best_assign[pod_slot], raw_after, obj_true0, config.move_cost)
    out.update(
        moves_per_sweep=moves_per_sweep,
        swaps_per_sweep=swaps_per_sweep,
        # an adopted placement colocates every service's replicas, so its
        # pod-level cost is the tracked service-level cut of best_assign
        communication_cost=torch.where(out["improved"], best_comm, comm_true0),
        load_std=load_std(state.replace(pod_node=out["pod_node"])),
    )
    phase_mark(END)
    return out
