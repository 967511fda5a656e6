"""Plain reference of one dense global solve, as the port's kernel lowering
decides it: chunked synchronous best response over service placements,
the pairwise swap phase, the best state seen, the exact re-evaluation and
the adopt gate (never worse than the input).

Written from the solver's stated semantics in plain PyTorch, with no
kernel: the neighbour mass is a float32 product of the chunk's pair-weight
rows and the one-hot occupancy, the score adds the annealing noise of the
u32 mixer the score kernel draws (seed ``s + t`` for the chunk's 256-row
tile ``t``), and the admission race is the sort-free pairwise form. One
pod a service (the benchmark's deployments), so a service's replica
weight is 1 and its node is its pod's node.

``weight_dtype`` is the pair-weight copy the mass and the swap phase read
(bfloat16 as configured); ``cost_dtype`` rounds the weights every
objective reads (float32 as configured). The control passes the next
precisions below.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

ROW_BLOCK = 2048          # rows of an S×S contraction at a time
COMPOSITION_BLOCK = 256   # the inline lowering's chunk granularity
SCORE_TILE = 256          # rows of one score tile (one noise seed each)
BIG_CAP = 3.4e38
_NEG_INF = float("-inf")
_M32 = 0xFFFFFFFF
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Layout:
    services: int
    nodes: int
    chunk: int
    n_chunks: int
    block: int  # composition granularity: 256 on the inline lowering, else 1

    @property
    def sp(self) -> int:
        return self.chunk * self.n_chunks


def layout(S: int, N: int, chunk_size: int = 0) -> Layout:
    """Chunk size ~S/10 in [1, 1024], rounded up to a multiple of 256 from
    256 on; the composition is block-granular where 256 tiles the chunk and
    the padded service count and a contraction tile (1024, 512 or 256)
    divides the latter."""
    if chunk_size:
        C = chunk_size
    else:
        C = max(1, min(1024, S // 10))
        if C >= 256:
            C = min(1024, -(-C // 256) * 256)
    C = min(C, S)
    n = -(-S // C)
    SP = n * C
    inline = (C % COMPOSITION_BLOCK == 0 and SP % COMPOSITION_BLOCK == 0
              and any(SP % b == 0 for b in (1024, 512, 256)))
    return Layout(S, N, C, n, COMPOSITION_BLOCK if inline else 1)


@dataclass(frozen=True)
class Plan:
    chunk_ids: torch.Tensor  # i64[n_chunks, C]
    seeds: torch.Tensor      # i64[n_chunks]


def draw_plans(generator: torch.Generator, sweeps: int, lay: Layout) -> list[Plan]:
    """One solve's random decisions, drawn as the port draws them from its
    CPU generator: per sweep a permutation of the composition blocks, then
    one kernel seed a chunk."""
    plans = []
    B = lay.block
    for _ in range(sweeps):
        bp = torch.randperm(lay.sp // B, generator=generator)
        ids = (bp[:, None] * B + torch.arange(B)[None, :]).reshape(lay.n_chunks, lay.chunk)
        seeds = torch.randint(0, 2**31 - 1, (lay.n_chunks,), generator=generator)
        plans.append(Plan(ids, seeds))
    return plans


def _mul32(x, k: int):
    lo = x * (k & 0xFFFF)
    hi = (x * (k >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def mixer_uniform(seed: int, rows: int, cols: int, device) -> torch.Tensor:
    """The score kernel's per-(seed, row, col) uniform in (0, 1)."""
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    x = _mul32(int(seed) & _M32, 0x9E3779B9)
    x = x ^ _mul32(r, 0x85EBCA6B) ^ _mul32(c, 0xC2B2AE35)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    mant = (x & 0x7FFFFF).to(torch.float32)
    return (mant + 0.5) * (1.0 / 8388608.0)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[1]
    col = torch.arange(n, device=x.device)[None, :]
    top = x.max(dim=1, keepdim=True).values
    return torch.clamp_max(torch.where(x == top, col, n).min(dim=1).values, n - 1)


def score_tile(m, cur, c_cpu, c_mem, valid, cpu_load, mem_load, cap, mem_cap, lam, ow,
               temp, seed, enforce):
    """One tile's proposal: first-max feasible node of the noisy score, its
    gain over the current node, whether it wants to move, and the target's
    slacks."""
    bc, n = m.shape
    col = torch.arange(n, device=m.device)[None, :]
    is_cur = col == cur[:, None]
    proj_cpu = cpu_load[None, :] + torch.where(is_cur, 0.0, c_cpu[:, None])
    proj_pct = proj_cpu / cap[None, :] * 100.0
    score = m - lam * proj_pct - ow * torch.clamp_min(proj_pct - 100.0, 0.0)
    if temp is not None:
        u = mixer_uniform(seed, bc, n, m.device)
        score = score + temp * (-torch.log(-torch.log(u)))
    if enforce:
        proj_mem = mem_load[None, :] + torch.where(is_cur, 0.0, c_mem[:, None])
        feasible = ((proj_cpu <= cap[None, :]) & (proj_mem <= mem_cap[None, :])) | is_cur
    else:
        feasible = torch.ones_like(is_cur)
    masked = torch.where(feasible, score, _NEG_INF)
    best = masked.max(dim=1, keepdim=True).values
    prop = torch.clamp_max(torch.where(masked == best, col, n).min(dim=1).values, n - 1)
    gain = best[:, 0] - torch.where(is_cur, score, 0.0).sum(dim=1)
    wants = valid & (gain > 0) & (prop != cur)
    return (prop, gain, wants, cap[prop] - cpu_load[prop] - c_cpu,
            mem_cap[prop] - mem_load[prop] - c_mem)


def admit(gain, prop, wants, c_cpu, c_mem, slack_cpu, slack_mem):
    """A proposal lands iff its target's slack covers every higher-priority
    (greater gain, ties to the lower row) arrival at that target and itself."""
    C = gain.shape[0]
    idx = torch.arange(C, device=gain.device)
    g = torch.where(wants, gain, _NEG_INF)
    before = (g[None, :] > g[:, None]) | (
        (g[None, :] == g[:, None]) & (idx[None, :] < idx[:, None]))
    pri = (before & wants[None, :] & (prop[None, :] == prop[:, None])).to(torch.float32)
    land_cpu = pri @ torch.where(wants, c_cpu, 0.0)
    land_mem = pri @ torch.where(wants, c_mem, 0.0)
    return wants & (land_cpu <= slack_cpu) & (land_mem <= slack_mem)


def swap_phase(M, Wc, cur, eligible, c_cpu, c_mem, cpu_load, mem_load, cap, mem_cap, lam,
               ow, k, enforce):
    """Pairwise exchanges within a chunk: the top-k services by desire, the
    exchange gain, mutual-best matching, the cross-swap mass coupling and
    the cross-swap capacity race. Returns ``(new_node, swapped)``."""
    C = cur.shape[0]
    dev = M.device
    f32 = torch.float32
    m_cur_all = M.gather(1, cur[:, None])[:, 0]
    if k < C:
        desire = M.max(dim=1).values - m_cur_all
        sel = torch.sort(torch.where(eligible, desire, _NEG_INF), descending=True,
                         stable=True).indices[:k]
    else:
        sel = torch.arange(C, device=dev)
    Mk, Wk = M[sel], Wc[sel][:, sel]
    cur_k, elig, cc, cm = cur[sel], eligible[sel], c_cpu[sel], c_mem[sel]
    m_own = m_cur_all[sel]
    ld_cpu, ld_mem, cap_at, mcap_at = cpu_load[cur_k], mem_load[cur_k], cap[cur_k], mem_cap[cur_k]
    K = cur_k.shape[0]
    idx = torch.arange(K, device=dev)
    M_cur = Mk[:, cur_k]
    G = M_cur + M_cur.T - m_own[:, None] - m_own[None, :] - 2.0 * Wk
    pct_new = (ld_cpu[None, :] - cc[None, :] + cc[:, None]) / cap_at[None, :] * 100.0
    pct_old = ld_cpu / cap_at * 100.0
    term_new = -lam * pct_new - ow * torch.clamp_min(pct_new - 100.0, 0.0)
    term_old = -lam * pct_old - ow * torch.clamp_min(pct_old - 100.0, 0.0)
    G = G + (term_new - term_old[:, None]) + (term_new.T - term_old[None, :])
    pair_ok = elig[:, None] & elig[None, :] & (cur_k[:, None] != cur_k[None, :])
    d_cpu_a = cc[None, :] - cc[:, None]
    d_mem_a = cm[None, :] - cm[:, None]
    free_cpu = cap_at - ld_cpu
    free_mem = mcap_at - ld_mem
    if enforce:
        fits_a = (d_cpu_a <= free_cpu[:, None]) & (d_mem_a <= free_mem[:, None])
        fits = fits_a & fits_a.T
    else:
        fits = torch.ones((K, K), dtype=torch.bool, device=dev)
    Gm = torch.where(pair_ok & fits & (G > 0), G, _NEG_INF)
    p = first_argmax(Gm)
    gbest = Gm.gather(1, p[:, None])[:, 0]
    mutual = (gbest > 0) & (p[p] == idx)
    cand = mutual & (idx < p)
    gain_c = torch.where(cand, gbest, _NEG_INF)
    before = (gain_c[None, :] > gain_c[:, None]) | (
        (gain_c[None, :] == gain_c[:, None]) & (idx[None, :] < idx[:, None]))
    pri = (before & cand[None, :]).to(f32)
    nprime = cur_k[p]
    D = ((nprime[:, None] == nprime[None, :]).to(f32)
         - (nprime[:, None] == cur_k[None, :]).to(f32)
         - (cur_k[:, None] == nprime[None, :]).to(f32)
         + (cur_k[:, None] == cur_k[None, :]).to(f32))
    A = Wk * D
    B = torch.eye(K, dtype=f32, device=dev) + (p[:, None] == idx[None, :]).to(f32)
    I_mat = (B @ A) @ B.T
    cand = cand & (gain_c + torch.sum(pri * torch.clamp_max(I_mat, 0.0), dim=1) > 0)
    gain_c = torch.where(cand, gbest, _NEG_INF)
    if enforce:
        before = (gain_c[None, :] > gain_c[:, None]) | (
            (gain_c[None, :] == gain_c[:, None]) & (idx[None, :] < idx[:, None]))
        pri = (before & cand[None, :]).to(f32)
        in_a_cpu = cc[p] - cc
        in_a_mem = cm[p] - cm
        a_of, b_of = cur_k, cur_k[p]

        def others(node_of):
            hit_a = (a_of[None, :] == node_of[:, None]).to(f32)
            hit_b = (b_of[None, :] == node_of[:, None]).to(f32)
            oc = torch.sum(pri * (hit_a * torch.clamp_min(in_a_cpu, 0.0)[None, :]
                                  + hit_b * torch.clamp_min(-in_a_cpu, 0.0)[None, :]), dim=1)
            om = torch.sum(pri * (hit_a * torch.clamp_min(in_a_mem, 0.0)[None, :]
                                  + hit_b * torch.clamp_min(-in_a_mem, 0.0)[None, :]), dim=1)
            return oc, om

        oa_cpu, oa_mem = others(a_of)
        ob_cpu, ob_mem = others(b_of)
        adm = (cand & (in_a_cpu + oa_cpu <= free_cpu) & (in_a_mem + oa_mem <= free_mem)
               & (-in_a_cpu + ob_cpu <= free_cpu[p]) & (-in_a_mem + ob_mem <= free_mem[p]))
    else:
        adm = cand
    swapped_k = adm | (mutual & adm[p])
    new_k = torch.where(swapped_k, cur_k[p], cur_k)
    new_node = cur.clone()
    new_node[sel] = new_k
    swapped = torch.zeros((C,), dtype=torch.bool, device=dev)
    swapped[sel] = swapped_k
    return new_node, swapped


@dataclass(frozen=True)
class Result:
    placement: torch.Tensor       # i64[S] each service's node after the solve
    objective_before: float
    objective_after: float
    improved: bool


def solve(adj: torch.Tensor, svc_cpu: torch.Tensor, svc_mem: torch.Tensor,
          node_cpu: torch.Tensor, node_mem: torch.Tensor, assign_in: torch.Tensor,
          plans: list[Plan], solver: dict, lay: Layout, *, weight_dtype: torch.dtype,
          cost_dtype: torch.dtype) -> Result:
    """One solve from placement ``assign_in`` (i64[S]) under pair weights
    ``adj`` (f32[S, S], symmetric, zero diagonal). ``solver`` holds the
    configuration's solver keys."""
    dev = adj.device
    f32 = torch.float32
    S, N, C, SP = lay.services, lay.nodes, lay.chunk, lay.sp
    lam = float(solver["balance_weight"])
    enforce = bool(solver["enforce_capacity"])
    ow = float(solver["overload_weight"]) if enforce else 0.0
    frac = float(solver["capacity_frac"])
    if float(solver["move_cost"]) != 0.0:
        raise ValueError("the reference prices no moves")
    adj_c = adj.to(cost_dtype).to(f32)

    valid = torch.zeros(SP, dtype=torch.bool, device=dev)
    valid[:S] = True
    cpu = torch.zeros(SP, dtype=f32, device=dev)
    cpu[:S] = svc_cpu
    mem = torch.zeros(SP, dtype=f32, device=dev)
    mem[:S] = svc_mem
    W = torch.zeros((SP, SP), dtype=torch.bfloat16 if weight_dtype != f32 else f32, device=dev)
    for r0 in range(0, S, ROW_BLOCK):
        r1 = min(r0 + ROW_BLOCK, S)
        W[r0:r1, :S] = adj[r0:r1].to(weight_dtype).to(W.dtype)

    cap = node_cpu * frac
    mem_cap = torch.where(node_mem > 0, node_mem, float("inf")) * frac
    mem_cap_sw = torch.where(torch.isinf(mem_cap), BIG_CAP, mem_cap)
    cols = torch.arange(N, device=dev)
    assign0 = torch.zeros(SP, dtype=torch.int64, device=dev)
    assign0[:S] = assign_in.clamp(0, N - 1)

    def loads(a):
        oh = ((a[:, None] == cols[None, :]) & valid[:, None]).to(f32)
        return cpu @ oh, mem @ oh

    def balance(cpu_load):
        pct = cpu_load / cap * 100.0
        mean = pct.sum() / N
        std = torch.sqrt(((pct - mean) ** 2).sum() / N)
        return lam * std + ow * torch.clamp_min(pct - 100.0, 0.0).sum()

    w_total = torch.ones(S, device=dev) @ (adj_c @ torch.ones(S, device=dev))

    def objective_fast(a, cpu_load):
        kept = torch.zeros((), dtype=f32, device=dev)
        for r0 in range(0, SP, ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, SP)
            same = a[r0:r1, None] == a[None, :]
            kept = kept + torch.where(same, W[r0:r1], 0).sum(dtype=f32)
        return 0.5 * (w_total - kept) + balance(cpu_load)

    def exact_cost(a):
        a = a[:S]
        total = torch.zeros((), dtype=f32, device=dev)
        for r0 in range(0, S, ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, S)
            total = total + torch.sum(torch.where(a[r0:r1, None] != a[None, :], adj_c[r0:r1], 0.0))
        return 0.5 * total

    sweeps = int(solver["sweeps"])
    temps = float(solver["noise_temp"]) * (
        1.0 - torch.arange(sweeps, dtype=f32) / max(sweeps - 1, 1))
    use_noise = float(solver["noise_temp"]) > 0
    every = int(solver["swap_every"])
    k_swap = min(int(solver["swap_k"]), C)

    assign = assign0.clone()
    cpu_load, mem_load = loads(assign)
    best_assign, best_obj = assign0.clone(), objective_fast(assign0, cpu_load)
    for s in range(sweeps):
        plan = plans[s]
        temp = temps[s].to(dev) if use_noise else None
        do_swap = every > 0 and C >= 2 and s % every == every - 1
        for c in range(lay.n_chunks):
            ids = plan.chunk_ids[c].to(dev)
            seed = int(plan.seeds[c])
            cur = assign[ids]
            valid_c, c_cpu, c_mem = valid[ids], cpu[ids], mem[ids]
            X = ((assign[:, None] == cols[None, :]) & valid[:, None]).to(f32)
            Wr = W[ids]
            M = Wr.to(f32) @ X
            outs = [score_tile(M[t0:t0 + SCORE_TILE], cur[t0:t0 + SCORE_TILE],
                               c_cpu[t0:t0 + SCORE_TILE], c_mem[t0:t0 + SCORE_TILE],
                               valid_c[t0:t0 + SCORE_TILE], cpu_load, mem_load, cap, mem_cap,
                               lam, ow, temp, seed + t0 // SCORE_TILE, enforce)
                    for t0 in range(0, C, SCORE_TILE)]
            prop, gain, wants, sl_cpu, sl_mem = (torch.cat(x) for x in zip(*outs))
            admitted = admit(gain, prop, wants, c_cpu, c_mem, sl_cpu, sl_mem) if enforce else wants
            new_node = torch.where(admitted, prop, cur)
            d_cpu = torch.where(admitted, c_cpu, 0.0)
            d_mem = torch.where(admitted, c_mem, 0.0)
            cpu_load = cpu_load.index_put((new_node,), d_cpu, accumulate=True)
            cpu_load = cpu_load.index_put((cur,), -d_cpu, accumulate=True)
            mem_load = mem_load.index_put((new_node,), d_mem, accumulate=True)
            mem_load = mem_load.index_put((cur,), -d_mem, accumulate=True)
            assign[ids] = new_node
            if do_swap:
                cur2 = assign[ids]
                eligible = valid_c & ~admitted
                sw_node, swapped = swap_phase(M, Wr[:, ids].to(f32), cur2, eligible, c_cpu,
                                              c_mem, cpu_load, mem_load, cap, mem_cap_sw, lam,
                                              ow, k_swap, enforce)
                d_c = torch.where(swapped, c_cpu, 0.0)
                d_m = torch.where(swapped, c_mem, 0.0)
                cpu_load = cpu_load.index_put((sw_node,), d_c, accumulate=True)
                cpu_load = cpu_load.index_put((cur2,), -d_c, accumulate=True)
                mem_load = mem_load.index_put((sw_node,), d_m, accumulate=True)
                mem_load = mem_load.index_put((cur2,), -d_m, accumulate=True)
                assign[ids] = sw_node
        cpu_load, mem_load = loads(assign)
        obj = objective_fast(assign, cpu_load)
        if bool(obj < best_obj):
            best_assign, best_obj = assign.clone(), obj

    best_val = exact_cost(best_assign) + balance(loads(best_assign)[0])
    obj_in = exact_cost(assign0) + balance(loads(assign0)[0])
    improved = bool(best_val < obj_in)
    placement = (best_assign if improved else assign0)[:S]
    return Result(placement, float(obj_in), float(best_val if improved else obj_in), improved)
