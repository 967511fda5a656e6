"""Plain reference of one sparse global solve, as the port's block-local
kernel lowering decides it.

The same optimisation as ``dense_solve`` (chunked best response, swap
phase, best state seen, adopt gate), over a different search structure:

- services are ordered by descending count of distinct neighbours (ties
  in service order) and cut into blocks of 256 such slots;
- a block whose rows reach more than ``hub_width`` distinct neighbours is
  a hub block: the hub blocks are re-placed first in every sweep, in
  groups of ``KB`` = chunk / 256 blocks, each group one step;
- the other (regular) blocks, padded with empty blocks to whole chunks,
  form ``KB``-block chunks by a random permutation each sweep;
- the per-sweep objective is the float32 cut sum over the symmetric edge
  list, each undirected edge twice, ordered by its two slots.

The neighbour mass is computed from the edge list with bfloat16-rounded
weights (as configured) summed in float32; the score, admission and swap
phase are ``dense_solve``'s. Only what the configuration states is
reproduced: plain PyTorch, nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.dense_solve import (
    BIG_CAP, COMPOSITION_BLOCK, SCORE_TILE, Result, admit, score_tile, swap_phase)

BLOCK = COMPOSITION_BLOCK


@dataclass(frozen=True)
class Structure:
    """The search structure of one graph: ``pos[s]`` the slot of service
    ``s``, the hub and regular blocks, the chunk geometry, and the
    undirected edges ``(a, b)`` (service ids) in slot-key order — the order
    the per-round weights follow."""

    services: int
    nodes: int
    pos: np.ndarray
    hub_groups: tuple[tuple[int, ...], ...]
    regular: tuple[int, ...]
    kb: int
    n_chunks: int
    n_dummy: int
    ea: np.ndarray
    eb: np.ndarray
    block_distinct: np.ndarray  # distinct neighbours of each block's rows
    block_edges: np.ndarray     # directed call pairs leaving each block's rows

    @property
    def sp(self) -> int:
        return -(-self.services // BLOCK) * BLOCK

    @property
    def spx(self) -> int:
        return self.sp + self.n_dummy * BLOCK

    @property
    def width(self) -> int:
        return self.kb * BLOCK


def structure(S: int, N: int, ii: np.ndarray, jj: np.ndarray, chunk: int,
              hub_width: int) -> Structure:
    """The structure of the graph with undirected edges ``(ii, jj)``."""
    deg = np.bincount(np.concatenate([ii, jj]), minlength=S)
    order = np.argsort(-deg, kind="stable").astype(np.int64)
    pos = np.empty(S, dtype=np.int64)
    pos[order] = np.arange(S)
    NB = -(-S // BLOCK)
    ps, pt = pos[np.concatenate([ii, jj])], pos[np.concatenate([jj, ii])]
    hub, regular = [], []
    blk = ps // BLOCK
    distinct = np.array([np.unique(pt[blk == b]).size for b in range(NB)], dtype=np.int64)
    for b in range(NB):
        (hub if distinct[b] > hub_width else regular).append(b)
    kb = max(1, chunk // BLOCK)
    n_chunks = max(1, -(-len(regular) // kb)) if regular else 0
    lo, hi = np.minimum(pos[ii], pos[jj]), np.maximum(pos[ii], pos[jj])
    key = np.argsort(lo * (NB * BLOCK) + hi, kind="stable")
    return Structure(S, N, pos,
                     tuple(tuple(hub[g:g + kb]) for g in range(0, len(hub), kb)),
                     tuple(regular), kb, n_chunks, n_chunks * kb - len(regular),
                     ii[key], jj[key], distinct, np.bincount(blk, minlength=NB))


@dataclass(frozen=True)
class Plan:
    block_perm: torch.Tensor  # i64[n_chunks * KB]
    seeds: torch.Tensor       # i64[n_chunks + hub groups]


def draw_plans(generator: torch.Generator, sweeps: int, st: Structure) -> list[Plan]:
    """As the port draws them from its CPU generator: per sweep a
    permutation of the chunk slots, then one seed a chunk and a hub group."""
    return [Plan(torch.randperm(st.n_chunks * st.kb, generator=generator),
                 torch.randint(0, 2**31 - 1, (st.n_chunks + len(st.hub_groups),),
                               generator=generator))
            for _ in range(sweeps)]


def solve(st: Structure, w: torch.Tensor, svc_cpu: torch.Tensor, svc_mem: torch.Tensor,
          node_cpu: torch.Tensor, node_mem: torch.Tensor, assign_in: torch.Tensor,
          plans: list[Plan], solver: dict, *, weight_dtype: torch.dtype,
          cost_dtype: torch.dtype) -> Result:
    """One solve from placement ``assign_in`` (i64[S], by service) under
    the undirected edges' weights ``w`` (f32[E], in ``st``'s edge order)."""
    dev = w.device
    f32 = torch.float32
    S, N, SPX, C = st.services, st.nodes, st.spx, st.width
    lam = float(solver["balance_weight"])
    enforce = bool(solver["enforce_capacity"])
    ow = float(solver["overload_weight"]) if enforce else 0.0
    frac = float(solver["capacity_frac"])
    if float(solver["move_cost"]) != 0.0:
        raise ValueError("the reference prices no moves")

    pos = torch.as_tensor(st.pos, device=dev)
    a_s, b_s = pos[torch.as_tensor(st.ea, device=dev)], pos[torch.as_tensor(st.eb, device=dev)]
    w_mass = w.to(weight_dtype).to(f32)
    w_cost = w.to(cost_dtype).to(f32)
    # directed edges by slot, each undirected edge twice
    src, dst, wm = torch.cat([a_s, b_s]), torch.cat([b_s, a_s]), torch.cat([w_mass, w_mass])

    valid = torch.zeros(SPX, dtype=torch.bool, device=dev)
    valid[:S] = True
    cpu = torch.zeros(SPX, device=dev)
    cpu[pos] = svc_cpu
    mem = torch.zeros(SPX, device=dev)
    mem[pos] = svc_mem
    assign0 = torch.zeros(SPX, dtype=torch.int64, device=dev)
    assign0[pos] = assign_in.clamp(0, N - 1)
    cap = node_cpu * frac
    mem_cap = torch.where(node_mem > 0, node_mem, float("inf")) * frac
    mem_cap_sw = torch.where(torch.isinf(mem_cap), BIG_CAP, mem_cap)

    def loads(a):
        idx = torch.where(valid, a, N)
        z = torch.zeros(N + 1, device=dev)
        return (z.index_put((idx,), cpu, accumulate=True)[:N],
                z.index_put((idx,), mem, accumulate=True)[:N])

    def balance(cpu_load):
        pct = cpu_load / cap * 100.0
        mean = pct.sum() / N
        std = torch.sqrt(((pct - mean) ** 2).sum() / N)
        return lam * std + ow * torch.clamp_min(pct - 100.0, 0.0).sum()

    def cut_cost(a):
        vals = w_cost * (a[a_s] != a[b_s]).to(f32)
        return 0.5 * torch.sum(torch.cat([vals, vals]))

    def mass(ids, a, cols, ncols):
        """M[r, col] = Σ of row ``ids[r]``'s neighbour weights whose
        neighbour sits at ``cols(neighbour)``."""
        local = torch.full((SPX,), -1, dtype=torch.int64, device=dev)
        local[ids] = torch.arange(ids.shape[0], device=dev)
        e = local[src] >= 0
        r, t, v = local[src[e]], dst[e], wm[e]
        c = cols(t)
        keep = c < ncols
        M = torch.zeros((ids.shape[0], ncols), device=dev)
        return M.index_put((r[keep], c[keep]), v[keep], accumulate=True)

    def place(a, cpu_load, mem_load, ids, M, temp, seed):
        cur = a[ids]
        valid_c, c_cpu, c_mem = valid[ids], cpu[ids], mem[ids]
        outs = [score_tile(M[t0:t0 + SCORE_TILE], cur[t0:t0 + SCORE_TILE],
                           c_cpu[t0:t0 + SCORE_TILE], c_mem[t0:t0 + SCORE_TILE],
                           valid_c[t0:t0 + SCORE_TILE], cpu_load, mem_load, cap, mem_cap,
                           lam, ow, temp, seed + t0 // SCORE_TILE, enforce)
                for t0 in range(0, ids.shape[0], SCORE_TILE)]
        prop, gain, wants, sl_cpu, sl_mem = (torch.cat(x) for x in zip(*outs))
        admitted = admit(gain, prop, wants, c_cpu, c_mem, sl_cpu, sl_mem) if enforce else wants
        new = torch.where(admitted, prop, cur)
        d_cpu, d_mem = torch.where(admitted, c_cpu, 0.0), torch.where(admitted, c_mem, 0.0)
        cpu_load = cpu_load.index_put((new,), d_cpu, accumulate=True)
        cpu_load = cpu_load.index_put((cur,), -d_cpu, accumulate=True)
        mem_load = mem_load.index_put((new,), d_mem, accumulate=True)
        mem_load = mem_load.index_put((cur,), -d_mem, accumulate=True)
        a[ids] = new
        return cpu_load, mem_load, admitted

    rows = torch.arange(BLOCK, device=dev)
    hub_ids = [torch.cat([rows + b * BLOCK for b in g]) for g in st.hub_groups]
    slots = torch.as_tensor(list(st.regular) + [st.sp // BLOCK + d for d in range(st.n_dummy)],
                            dtype=torch.int64, device=dev)
    sweeps = int(solver["sweeps"])
    temps = float(solver["noise_temp"]) * (
        1.0 - torch.arange(sweeps, dtype=f32) / max(sweeps - 1, 1))
    use_noise = float(solver["noise_temp"]) > 0
    every = int(solver["swap_every"])
    k_swap = min(int(solver["swap_k"]), C)

    assign = assign0.clone()
    cpu_load, mem_load = loads(assign)
    best_assign = assign0.clone()
    best_obj = cut_cost(assign0) + balance(cpu_load)
    for s in range(sweeps):
        plan = plans[s]
        temp = temps[s].to(dev) if use_noise else None
        do_swap = every > 0 and s % every == every - 1
        node_of = lambda t: assign[t]  # noqa: E731
        for g, ids in enumerate(hub_ids):
            M = mass(ids, assign, node_of, N)
            cpu_load, mem_load, _ = place(assign, cpu_load, mem_load, ids, M, temp,
                                          int(plan.seeds[st.n_chunks + g]))
        blocks = slots[plan.block_perm.to(dev)].reshape(st.n_chunks, st.kb)
        for c in range(st.n_chunks):
            ids = (blocks[c][:, None] * BLOCK + rows[None, :]).reshape(-1)
            M = mass(ids, assign, node_of, N)
            cpu_load, mem_load, admitted = place(assign, cpu_load, mem_load, ids, M, temp,
                                                 int(plan.seeds[c]))
            if not do_swap:
                continue
            where = torch.full((SPX,), C, dtype=torch.int64, device=dev)
            where[ids] = torch.arange(C, device=dev)
            Wc = mass(ids, assign, lambda t: where[t], C)
            cur2 = assign[ids]
            eligible = valid[ids] & ~admitted
            new, swapped = swap_phase(M, Wc, cur2, eligible, cpu[ids], mem[ids], cpu_load,
                                      mem_load, cap, mem_cap_sw, lam, ow, k_swap, enforce)
            d_c = torch.where(swapped, cpu[ids], 0.0)
            d_m = torch.where(swapped, mem[ids], 0.0)
            cpu_load = cpu_load.index_put((new,), d_c, accumulate=True)
            cpu_load = cpu_load.index_put((cur2,), -d_c, accumulate=True)
            mem_load = mem_load.index_put((new,), d_m, accumulate=True)
            mem_load = mem_load.index_put((cur2,), -d_m, accumulate=True)
            assign[ids] = new
        cpu_load, mem_load = loads(assign)
        obj = cut_cost(assign) + balance(cpu_load)
        if bool(obj < best_obj):
            best_assign, best_obj = assign.clone(), obj

    obj_in = cut_cost(assign0) + balance(loads(assign0)[0])
    improved = bool(best_obj < obj_in)
    placement = (best_assign if improved else assign0)[pos]
    return Result(placement, float(obj_in), float(best_obj if improved else obj_in), improved)
