"""Pairwise-exchange (swap) phase for the chunked best-response solver — the
port of ``kubernetes_rescheduling_tpu.solver.swap``, in plain PyTorch (the
JAX package has no kernel here), and :func:`chunk_swap_phase`, the one place
a solver chunk's swap phase chooses between kernels 7 and 8
(``ops/swap.py``) on the card and this plain chain elsewhere.

Two services i and j exchange nodes (i → cur_j, j → cur_i, atomically) when
the joint move improves the objective and both directions fit. The
exchange gain is

    G[i, j] =  (M[i, cur_j] - M[i, cur_i]) + (M[j, cur_i] - M[j, cur_j])
             - 2·W[i, j] + Δbalance/overload terms + Δmove-cost terms

with departure-corrected load projections. Selection is mutual-best
matching; node capacity across several admitted swaps is resolved by the
same sort-free pairwise-priority race as single-move admission. Every
expression mirrors the JAX package term for term.

Where the JAX package contracts with one-hot matrices at HIGHEST precision
(a TPU gather runs element by element), this port gathers: a one-hot
product of finite values is an exact row or column selection, so the
values are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.ops.fused_admission import first_argmax
from kubernetes_rescheduling_tpu_torch.ops.swap import chunk_swap_kernels, takes_kernels

# stand-in for an unbounded memory budget inside feasibility arithmetic:
# inf would be correct in comparisons but can surface NaNs through masked
# sums (inf·0)
BIG_CAP = 3.4e38

_NEG_INF = float("-inf")


def swap_flags(sweeps: int, swap_every: int) -> np.ndarray:
    """Which sweeps run the swap phase: every ``swap_every``-th sweep,
    counted so the LAST sweep of a default config is included (sweeps 2,
    5, 8 for sweeps=9, swap_every=3)."""
    if swap_every <= 0:
        return np.zeros((sweeps,), dtype=bool)
    return (np.arange(sweeps) % swap_every) == (swap_every - 1)


def scan_sweeps(make_body, carry, plans, temps, flags):
    """Run the sweep loop in contiguous same-flag segments, so the swap
    phase is a fixed branch of each segment's body. ``make_body(do_swap)``
    returns ``body(carry, (plan, temp)) -> (carry, out)``. Returns
    ``(carry, outs)`` with one ``out`` per sweep, in sweep order."""
    flags = np.asarray(flags)
    bodies = {}
    outs = []
    i = 0
    while i < len(flags):
        j = i
        while j < len(flags) and flags[j] == flags[i]:
            j += 1
        flag = bool(flags[i])
        if flag not in bodies:
            bodies[flag] = make_body(flag)
        for s in range(i, j):
            carry, out = bodies[flag](carry, (plans[s], temps[s]))
            outs.append(out)
        i = j
    return carry, outs


def swap_desire(m_best, m_cur, pen_home):
    """Optimistic per-service exchange desire: best kept mass anywhere minus
    kept mass at the current node, minus the move-cost bill if the service
    still sits on its anchor."""
    return m_best - m_cur - pen_home


def swap_subset(desire, eligible, M, Wc, k):
    """Top-``k`` candidate selection and the subset's rows of ``M`` and
    ``Wc``. Returns ``(sel, M_k, Wc_k, sub)`` where ``sub`` gathers any [C]
    vector to the subset."""
    # jax.lax.top_k's order: descending, ties → lower index first — a
    # stable descending sort (torch.topk leaves the order of ties open)
    sel = torch.sort(torch.where(eligible, desire, _NEG_INF), descending=True,
                     stable=True).indices[:k]
    M_k = M[sel]
    Wc_k = Wc[sel][:, sel]
    return sel, M_k, Wc_k, (lambda v: v[sel])


def chunk_swap(
    M, Wc, cur, eligible, c_cpu, c_mem, cpu_load, mem_load, cap, mem_cap_s,
    lam, ow, pen, home, k, *, enforce_capacity,
):
    """The full swap phase for one chunk: desire-ranked top-``k`` candidate
    subset → exact pair decisions → full-width results. With ``k >= C``
    the subset is the identity.

    Returns ``(new_node[C], swapped[C], n_swaps)``."""
    C = cur.shape[0]
    cur_l = cur.long()
    m_cur = M.gather(1, cur_l[:, None])[:, 0]
    pen_home = pen * (cur == home).to(torch.float32) if pen is not None else 0.0
    if k < C:
        desire = swap_desire(M.max(dim=1).values, m_cur, pen_home)
        sel, M_k, Wc_k, sub = swap_subset(desire, eligible, M, Wc, k)
    else:
        sel = torch.arange(C, device=M.device)
        M_k, Wc_k = M, Wc
        sub = lambda v: v  # noqa: E731
    cur_k = sub(cur)
    cur_kl = cur_k.long()
    new_k, swapped_k, n_sw = swap_decisions(
        cols_at(M_k, cur_k),
        sub(m_cur),
        Wc_k, cur_k, sub(eligible), sub(c_cpu), sub(c_mem),
        cpu_load[cur_kl], mem_load[cur_kl], cap[cur_kl], mem_cap_s[cur_kl],
        lam, ow,
        pen=sub(pen) if pen is not None else None,
        home=sub(home) if home is not None else None,
        enforce_capacity=enforce_capacity,
    )
    new_node = cur.clone()
    new_node[sel] = new_k.to(cur.dtype)
    swapped = torch.zeros((C,), dtype=torch.bool, device=M.device)
    swapped[sel] = swapped_k
    return new_node, swapped, n_sw


def commit_moves(cpu_load, mem_load, cur, new_node, moved, c_cpu, c_mem):
    """A chunk's moves applied to the per-node loads (out of place): each
    moved service's demand added at its new node, then taken off its old
    one, by scatter-add. Single moves and swaps both commit through it;
    kernel 8 adds in this order too."""
    d_c = torch.where(moved, c_cpu, 0.0)
    d_m = torch.where(moved, c_mem, 0.0)
    new_l, cur_l = new_node.long(), cur.long()
    cpu_load = cpu_load.index_put((new_l,), d_c, accumulate=True)
    cpu_load = cpu_load.index_put((cur_l,), -d_c, accumulate=True)
    mem_load = mem_load.index_put((new_l,), d_m, accumulate=True)
    mem_load = mem_load.index_put((cur_l,), -d_m, accumulate=True)
    return cpu_load, mem_load


def chunk_swap_phase(
    M, W, w_ids, assign, ids, svc_valid, moved, node_valid, svc_cpu, svc_mem, cpu_load,
    mem_load, cap, mem_cap_s, lam, ow, pen, home, k, *, enforce_capacity, use_kernels,
):
    """A solver chunk's swap phase on the post-singles state, with
    ``ops.swap.chunk_swap_kernels``' arguments: ``M`` the chunk-start mass
    [C, N]; the chunk's rows are the services ``ids`` of the service arrays
    (``assign`` updated in place; ``pen`` and ``home`` None without
    move-cost pricing); rows the single phase ``moved`` sit out; the pair
    weights are ``W[w_ids[i], w_ids[j]]``, or ``W`` itself with ``w_ids``
    None. Under the kernel lowering on the card (``ops.swap.takes_kernels``)
    kernels 7 and 8 decide and commit; elsewhere the plain chain: the row
    gathers, :func:`chunk_swap`, :func:`commit_moves`, ``assign[ids] =
    new_node``. Returns ``(cpu_load, mem_load, n_swaps)``."""
    C = M.shape[0]
    k = min(k, C)
    if takes_kernels(use_kernels, M.device, C):
        _, _, n_sw, cpu_load, mem_load = chunk_swap_kernels(
            M, W, w_ids, assign, ids, svc_valid, moved, node_valid, svc_cpu, svc_mem, cpu_load,
            mem_load, cap, mem_cap_s, lam, ow, pen, home, k, enforce_capacity=enforce_capacity)
        return cpu_load, mem_load, n_sw
    cur = assign[ids]
    eligible = svc_valid[ids] & ~moved & node_valid[cur.long()]
    c_cpu, c_mem = svc_cpu[ids], svc_mem[ids]
    Wc = W if w_ids is None else W[w_ids[:, None], w_ids[None, :]].to(torch.float32)
    new_node, swapped, n_sw = chunk_swap(
        M, Wc, cur, eligible, c_cpu, c_mem, cpu_load, mem_load, cap, mem_cap_s, lam, ow,
        None if pen is None else pen[ids], None if home is None else home[ids], k,
        enforce_capacity=enforce_capacity)
    cpu_load, mem_load = commit_moves(cpu_load, mem_load, cur, new_node, swapped, c_cpu, c_mem)
    assign[ids] = new_node
    return cpu_load, mem_load, n_sw


def cols_at(M, cur):
    """``M_cur[i, j] = M[i, cur_j]``: the column gather the JAX package
    writes as a one-hot contraction (``cur`` is always a valid node)."""
    return M[:, cur.long()]


def swap_decisions(
    M_cur,        # f32[C, C]: M[i, cur_j]
    m_own,        # f32[C]: M[i, cur_i]
    Wc,           # f32[C, C]: pair weight between chunk members i and j
    cur,          # i32[C] current node per service (post single-move phase)
    eligible,     # bool[C]: valid AND not moved by this chunk's single phase
    c_cpu,        # f32[C]
    c_mem,        # f32[C]
    load_cpu_at,  # f32[C]: node CPU load at cur_i (current, incl. i)
    load_mem_at,  # f32[C]
    cap_at,       # f32[C]: budget-scaled CPU capacity at cur_i
    mem_cap_at,   # f32[C] (inf sanitized to BIG_CAP by the caller)
    lam,          # balance weight
    ow,           # overload (over-budget) weight
    pen=None,     # f32[C] move-cost bill per service (None = pricing off)
    home=None,    # i32[C] round-start anchor node (with pen)
    *,
    enforce_capacity: bool,
):
    """The swap core: exchange-gain matrix → mutual-best matching →
    pairwise-priority capacity race. Returns ``(new_node, swapped,
    n_swaps)`` where ``swapped[k]`` marks both members of every admitted
    pair and ``new_node[k] = cur[partner_k]`` there."""
    C = m_own.shape[0]
    dev = m_own.device
    idx = torch.arange(C, device=dev)
    f32 = torch.float32

    # kept-mass side of the gain
    G = M_cur + M_cur.T - m_own[:, None] - m_own[None, :] - 2.0 * Wc

    # balance/overload side, with the departure-corrected projection:
    # i lands on cur_j whose load loses j and gains i
    pct_new = (
        (load_cpu_at[None, :] - c_cpu[None, :] + c_cpu[:, None])
        / cap_at[None, :]
        * 100.0
    )                                                   # [i, j]: i at cur_j
    pct_old = load_cpu_at / cap_at * 100.0              # [C]: i resident now
    term_new = -lam * pct_new - ow * torch.clamp_min(pct_new - 100.0, 0.0)
    term_old = -lam * pct_old - ow * torch.clamp_min(pct_old - 100.0, 0.0)
    G = G + (term_new - term_old[:, None]) + (term_new.T - term_old[None, :])

    # move-cost side: each member re-anchors against its round-start node
    if pen is not None:
        off_new = (cur[None, :] != home[:, None]).to(f32)
        off_old = (cur != home).to(f32)
        P = pen[:, None] * (off_new - off_old[:, None])  # i's bill delta
        G = G - P - P.T

    pair_ok = eligible[:, None] & eligible[None, :] & (cur[:, None] != cur[None, :])
    # net load delta at cur_i if (i, j) swap: j arrives, i departs
    d_cpu_a = c_cpu[None, :] - c_cpu[:, None]
    d_mem_a = c_mem[None, :] - c_mem[:, None]
    free_cpu_at = cap_at - load_cpu_at
    free_mem_at = mem_cap_at - load_mem_at
    if enforce_capacity:
        fits_a = (d_cpu_a <= free_cpu_at[:, None]) & (d_mem_a <= free_mem_at[:, None])
        fits = fits_a & fits_a.T
    else:
        fits = torch.ones((C, C), dtype=torch.bool, device=dev)
    Gm = torch.where(pair_ok & fits & (G > 0), G, _NEG_INF)

    # mutual-best matching: first-max partner per row; pairs that pick
    # each other swap (service-disjoint by construction)
    p = first_argmax(Gm).long()
    gbest = Gm.gather(1, p[:, None])[:, 0]
    has = gbest > 0
    mutual = has & (p[p] == idx)
    cand = mutual & (idx < p)  # one representative per pair: the lower id
    gain_c = torch.where(cand, gbest, _NEG_INF)
    before = (gain_c[None, :] > gain_c[:, None]) | (
        (gain_c[None, :] == gain_c[:, None]) & (idx[None, :] < idx[:, None])
    )
    pri = (before & cand[None, :]).to(f32)  # [s, t]

    # cross-swap mass coupling: a swap must keep a positive margin after the
    # clamped-negative interactions of all higher-priority swaps
    nprime = cur[p]
    D = (
        (nprime[:, None] == nprime[None, :]).to(f32)
        - (nprime[:, None] == cur[None, :]).to(f32)
        - (cur[:, None] == nprime[None, :]).to(f32)
        + (cur[:, None] == cur[None, :]).to(f32)
    )
    A = Wc * D
    # I[s, t] = ((E+Pm) A (E+Pm)ᵀ)[s, t] with Pm the partner permutation
    Pm = (p[:, None] == idx[None, :]).to(f32)
    B = torch.eye(C, dtype=f32, device=dev) + Pm
    I_mat = (B @ A) @ B.T
    neg_i = torch.sum(pri * torch.clamp_max(I_mat, 0.0), dim=1)
    cand = cand & (gain_c + neg_i > 0)
    gain_c = torch.where(cand, gbest, _NEG_INF)

    if enforce_capacity:
        # cross-swap capacity race over the interaction-surviving candidates,
        # higher-priority swaps' node deltas clamped at >= 0
        before = (gain_c[None, :] > gain_c[:, None]) | (
            (gain_c[None, :] == gain_c[:, None]) & (idx[None, :] < idx[:, None])
        )
        pri = (before & cand[None, :]).to(f32)  # [s, t]
        in_a_cpu = c_cpu[p] - c_cpu       # net at own node a_t = cur_t
        in_b_cpu = -in_a_cpu              # net at partner node b_t = cur_{p_t}
        in_a_mem = c_mem[p] - c_mem
        in_b_mem = -in_a_mem
        a_of = cur
        b_of = cur[p]

        def pos(x):
            return torch.clamp_min(x, 0.0)

        def others(node_of):
            # Σ over higher-priority swaps t of their clamped delta at this
            # swap's node (a_t and b_t are distinct: at most one live term)
            hit_a = (a_of[None, :] == node_of[:, None]).to(f32)
            hit_b = (b_of[None, :] == node_of[:, None]).to(f32)
            oc = torch.sum(
                pri * (hit_a * pos(in_a_cpu)[None, :] + hit_b * pos(in_b_cpu)[None, :]),
                dim=1,
            )
            om = torch.sum(
                pri * (hit_a * pos(in_a_mem)[None, :] + hit_b * pos(in_b_mem)[None, :]),
                dim=1,
            )
            return oc, om

        oa_cpu, oa_mem = others(a_of)
        ob_cpu, ob_mem = others(b_of)
        adm = (
            cand
            & (in_a_cpu + oa_cpu <= free_cpu_at)
            & (in_a_mem + oa_mem <= free_mem_at)
            & (in_b_cpu + ob_cpu <= free_cpu_at[p])
            & (in_b_mem + ob_mem <= free_mem_at[p])
        )
    else:
        adm = cand

    # both members of an admitted pair move to each other's node
    swapped = adm | (mutual & adm[p])
    new_node = torch.where(swapped, cur[p], cur)
    return new_node, swapped, torch.sum(adm)
