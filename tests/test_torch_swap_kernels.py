"""Kernels 7 and 8, the chunk's swap phase on the card (``ops/swap.py``,
``ops/csrc/swap.cu``), against ``solver/swap.py``'s plain ``chunk_swap``.

On the CPU: the kernels' two reformulations are exact against the forms
``solver/swap.py`` writes — the rank-count top-k against the stable sort,
the four-gather coupling against ``(B @ A) @ B.T`` — over the seeds and
tie instances of ``tests/test_torch_swap.py``, and the wrappers refuse
what the kernels do not take.

On the card (marked ``card``; they skip without a CUDA device): the kernels
decide exactly as the plain ``chunk_swap`` does, and a solve of the
``large`` graph places alike with and without them, in the dense and the
sparse form. This file imports no JAX, so it runs where the card is:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_swap_kernels.py``.
"""

import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu_torch.ops import swap as kswap
from kubernetes_rescheduling_tpu_torch.solver import swap as tswap

NEG_INF = float("-inf")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the swap kernels run only on the card")
    return torch.device("cuda")


def swap_instance(seed, C=48, N=6, *, ties=True):
    """``tests/test_torch_swap.py``'s instance at its defaults: small-integer
    masses (with ``ties``; otherwise uniform f32 masses) and pair weights,
    integer CPU sizes and loads, so every sum is exact in f32."""
    rng = np.random.default_rng(seed)
    M = (rng.integers(0, 4, size=(C, N)) if ties else rng.random((C, N)) * 8).astype(np.float32)
    Wc = np.triu(rng.integers(0, 3, size=(C, C)), 1).astype(np.float32)
    Wc = Wc + Wc.T
    cur = rng.integers(0, N, size=C).astype(np.int32)
    eligible = rng.random(C) < 0.85
    c_cpu = (rng.integers(1, 4, size=C) * 100.0).astype(np.float32)
    c_mem = (rng.integers(0, 3, size=C) * 10.0).astype(np.float32)
    cap = np.full((N,), 1600.0, np.float32)
    cpu_load = (rng.integers(8, 17, size=N) * 100.0).astype(np.float32)
    mem_cap = np.full((N,), 400.0, np.float32)
    mem_load = (rng.integers(0, 30, size=N) * 10.0).astype(np.float32)
    pen = rng.integers(0, 3, size=C).astype(np.float32)
    home = rng.integers(0, N, size=C).astype(np.int32)
    return M, Wc, cur, eligible, c_cpu, c_mem, cpu_load, mem_load, cap, mem_cap, pen, home


def desire_keys(M, cur, eligible, pen=None, home=None):
    """``chunk_swap``'s sort keys."""
    m_cur = M.gather(1, cur.long()[:, None])[:, 0]
    pen_home = pen * (cur == home).to(torch.float32) if pen is not None else 0.0
    return torch.where(eligible, tswap.swap_desire(M.max(dim=1).values, m_cur, pen_home),
                       NEG_INF)


def sort_select(keys, k):
    return torch.sort(keys, descending=True, stable=True).indices[:k]


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [8, 16, 48])
@pytest.mark.parametrize("priced", [False, True])
def test_rank_select_is_the_stable_sort(seed, k, priced):
    M, _, cur, elig, *_, pen, home = map(torch.as_tensor, swap_instance(seed))
    keys = desire_keys(M, cur, elig, *((pen, home) if priced else ()))
    assert torch.equal(kswap.rank_select(keys, k), sort_select(keys, k))


@pytest.mark.parametrize("keys", [
    [3, 5, 5, 1, 5, 3, 0, 5],
    [NEG_INF] * 8,
    [2, NEG_INF, 2, NEG_INF, 2, 0, 0, NEG_INF],
    [-0.0, 0.0, -0.0, 1.0, 0.0, NEG_INF, 1.0, -0.0],
])
def test_rank_select_ties_go_to_the_lower_index(keys):
    keys = torch.tensor(keys, dtype=torch.float32)
    for k in range(1, len(keys) + 1):
        assert torch.equal(kswap.rank_select(keys, k), sort_select(keys, k))


def coupling_operands(seed, C):
    """``swap_decisions``' A = Wc·D and partners p, with non-integer weights
    (the identity holds for any finite values), rows that pick themselves
    (p_s = s) and rows whose all -inf gains leave them on partner 0."""
    rng = np.random.default_rng(seed)
    M, Wc, cur, *_ = swap_instance(seed, C=C)
    Wc = torch.as_tensor(Wc * rng.random((C, C)).astype(np.float32) * 7.3)
    cur = torch.as_tensor(cur).long()
    p = torch.as_tensor(rng.integers(0, C, size=C))
    p[rng.random(C) < 0.2] = 0
    self_rows = torch.as_tensor(rng.random(C) < 0.1)
    p = torch.where(self_rows, torch.arange(C), p)
    n = cur[p]
    f32 = torch.float32
    D = ((n[:, None] == n[None, :]).to(f32) - (n[:, None] == cur[None, :]).to(f32)
         - (cur[:, None] == n[None, :]).to(f32) + (cur[:, None] == cur[None, :]).to(f32))
    return Wc * D, p


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("C", [24, 48, 256])
def test_interaction_gather_is_the_two_products(seed, C):
    A, p = coupling_operands(seed, C)
    B = torch.eye(C) + (p[:, None] == torch.arange(C)[None, :]).to(torch.float32)
    assert torch.equal(kswap.interaction_gather(A, p), (B @ A) @ B.T)


def service_form(cur, elig, c_cpu, c_mem, pen, home, N, *, seed=0, moved_share=0.0,
                 invalid_nodes=0):
    """A chunk's rows as the solvers hold them: services ``ids`` (a random
    set of a twice as wide service axis) of ``assign``, ``svc_valid``,
    ``svc_cpu``, ``svc_mem``, ``pen`` and ``home``; rows the single phase
    moved (a ``moved_share`` of them) and nodes marked invalid (the first
    ``invalid_nodes``) sit out too. Returns that form and the chunk's
    ``eligible`` as the solvers' plain path works it out."""
    C, dev = cur.shape[0], cur.device
    g = torch.Generator().manual_seed(seed)
    ids = torch.randperm(2 * C, generator=g)[:C].to(dev)

    def spread(v, fill):
        out = torch.full((2 * C,), fill, dtype=v.dtype, device=dev)
        out[ids] = v
        return out

    moved = (torch.rand(C, generator=g) < moved_share).to(dev)
    node_valid = torch.arange(N, device=dev) >= invalid_nodes
    svc = dict(assign=spread(cur, 0), ids=ids, svc_valid=spread(elig, False), moved=moved,
               node_valid=node_valid, svc_cpu=spread(c_cpu, 0.0), svc_mem=spread(c_mem, 0.0),
               pen=None if pen is None else spread(pen, 0.0),
               home=None if home is None else spread(home, 0))
    return svc, elig & ~moved & node_valid[cur.long()]


def cpu_operands(C=16, N=4):
    M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap, pen, home = map(
        torch.as_tensor, swap_instance(0, C=C, N=N))
    svc, _ = service_form(cur, elig, c_cpu, c_mem, None, None, N)
    return dict(M=M, Wc=Wc, cl=cl, ml=ml, cap=cap, mcap=mcap, keys=torch.zeros(C), **svc)


def desire(o, k=8, **change):
    o = {**o, **change}
    return kswap.swap_desire(o["M"], o["assign"], o["ids"], o["svc_valid"], o["moved"],
                             o["node_valid"], None, None, k)


def decide(o, k=8, **change):
    o = {**o, **change}
    return kswap.swap_decide(o["M"], o["keys"], o["Wc"], None, o["assign"], o["ids"],
                             o["svc_valid"], o["moved"], o["node_valid"], o["svc_cpu"],
                             o["svc_mem"], o["cl"], o["ml"], o["cap"], o["mcap"], 0.5, 10.0,
                             None, None, k, enforce_capacity=True)


@pytest.mark.parametrize("wrapper", [desire, decide])
def test_wrappers_refuse_cpu_tensors(wrapper):
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(cpu_operands())


@pytest.mark.parametrize("wrapper", [desire, decide])
@pytest.mark.parametrize("name,dtype", [("M", torch.float64), ("ids", torch.int32),
                                        ("svc_valid", torch.uint8), ("moved", torch.uint8)])
def test_wrappers_refuse_wrong_dtypes(wrapper, name, dtype):
    o = cpu_operands()
    with pytest.raises(ValueError, match="must be torch"):
        wrapper(o, **{name: o[name].to(dtype)})


def test_wrappers_refuse_other_weight_key_assign_and_pricing_operands():
    o = cpu_operands()
    with pytest.raises(ValueError, match="bf16 or f32"):
        decide(o, Wc=o["Wc"].to(torch.float16))
    with pytest.raises(ValueError, match="keys must be torch.float32"):
        decide(o, keys=torch.zeros(16, dtype=torch.float64))
    with pytest.raises(ValueError, match="svc_cpu must be torch.float32"):
        decide(o, svc_cpu=o["svc_cpu"].double())
    with pytest.raises(ValueError, match="assign must be a contiguous i32"):
        desire(o, assign=o["assign"].long())
    with pytest.raises(ValueError, match="pen and home"):
        kswap.swap_desire(o["M"], o["assign"], o["ids"], o["svc_valid"], o["moved"],
                          o["node_valid"], torch.zeros(32), None, 8)


def test_wrappers_refuse_k_past_1024():
    o = cpu_operands(C=1024)
    with pytest.raises(ValueError, match="k=1025"):
        desire(o, k=1025)
    with pytest.raises(ValueError, match="k=1025"):
        decide(o, k=1025)
    with pytest.raises(ValueError, match="C <= 1024"):
        desire(cpu_operands(C=1025), k=8)


def test_kernels_are_taken_on_cuda_under_the_lowering_only():
    assert kswap.takes_kernels(True, "cuda", 1024)
    assert kswap.takes_kernels(True, torch.device("cuda", 0), 2)
    assert not kswap.takes_kernels(True, "cuda", 1025)
    assert not kswap.takes_kernels(True, "cuda", 1)
    assert not kswap.takes_kernels(True, "cpu", 256)
    assert not kswap.takes_kernels(False, "cuda", 256)


def chunk_rows(assign, ids, svc_valid, moved, node_valid, pen, home):
    """The chunk's rows as the solvers' plain path gathers them."""
    cur = assign[ids]
    eligible = svc_valid[ids] & ~moved & node_valid[cur.long()]
    return (cur, eligible, None if pen is None else pen[ids],
            None if home is None else home[ids])


def plain_desire(M, assign, ids, svc_valid, moved, node_valid, pen, home, k):
    """Kernel 7 in plain PyTorch: ``chunk_swap``'s keys."""
    cur, eligible, pen_c, home_c = chunk_rows(assign, ids, svc_valid, moved, node_valid, pen,
                                              home)
    return desire_keys(M, cur, eligible, pen_c, home_c)


def plain_decide(M, keys, W, w_ids, assign, ids, svc_valid, moved, node_valid, svc_cpu,
                 svc_mem, cpu_load, mem_load, cap, mem_cap, lam, ow, pen, home, k, *,
                 enforce_capacity):
    """Kernel 8 in plain PyTorch: the rank-count subset, the weights read
    through ``w_ids`` at the subset alone, ``swap_decisions``, the results
    at full width, ``commit_swaps`` and the assignment's rows."""
    cur, eligible, pen, home = chunk_rows(assign, ids, svc_valid, moved, node_valid, pen, home)
    c_cpu, c_mem = svc_cpu[ids], svc_mem[ids]
    C = cur.shape[0]
    s = kswap.rank_select(keys, k) if k < C else torch.arange(C)
    rows = s if w_ids is None else w_ids[s]
    cur_k = cur[s]
    ck = cur_k.long()
    new_k, swapped_k, n = tswap.swap_decisions(
        tswap.cols_at(M[s], cur_k), M[s].gather(1, ck[:, None])[:, 0],
        W[rows[:, None], rows[None, :]].to(torch.float32), cur_k, eligible[s], c_cpu[s],
        c_mem[s], cpu_load[ck], mem_load[ck], cap[ck], mem_cap[ck], lam, ow,
        pen=None if pen is None else pen[s], home=None if home is None else home[s],
        enforce_capacity=enforce_capacity)
    new_node = cur.clone()
    new_node[s] = new_k.to(cur.dtype)
    swapped = torch.zeros_like(eligible)
    swapped[s] = swapped_k
    assign[ids] = new_node
    return (new_node, swapped, n,
            *tswap.commit_swaps(cpu_load, mem_load, cur, new_node, swapped, c_cpu, c_mem))


@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("swap_k", [8, 4096])
def test_solvers_kernel_route_places_as_the_plain_route(form, swap_k, monkeypatch):
    """The solvers' route through kernels 7 and 8, with plain stand-ins for
    the two launches, on the CPU: the same placements and swaps as the plain
    ``chunk_swap`` route, for a subset smaller than the chunk and for the
    whole chunk. This holds the arguments the solvers hand the wrappers."""
    from kubernetes_rescheduling_tpu_torch.bench import harness
    from kubernetes_rescheduling_tpu_torch.core import sparsegraph
    from kubernetes_rescheduling_tpu_torch.solver import global_solver as gs
    from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as ss

    backend = harness.make_backend("powerlaw", 0, device="cpu")
    state, graph = backend.monitor(), backend.comm_graph()
    # a tight budget and a balance term: single moves stall, swaps happen
    cfg = gs.GlobalSolverConfig(sweeps=3, swap_every=1, swap_k=swap_k, move_cost=0.5,
                                capacity_frac=0.3, balance_weight=0.5, fused_epilogue="on")
    module = gs if form == "dense" else ss
    sgraph = sparsegraph.from_comm_graph(graph) if form == "sparse" else None

    def solve():
        if form == "dense":
            return gs.global_assign(state, graph, torch.Generator().manual_seed(3), cfg)
        return ss.global_assign_sparse(state, sgraph, torch.Generator().manual_seed(3), cfg)

    st_p, info_p = solve()
    routed = []
    monkeypatch.setattr(module, "takes_kernels", lambda *a: True)
    monkeypatch.setattr(kswap, "swap_desire", lambda *a: routed.append(1) or plain_desire(*a))
    monkeypatch.setattr(kswap, "swap_decide", plain_decide)
    st_k, info_k = solve()
    assert len(routed) > 0
    assert int(info_p["swaps_per_sweep"].sum()) > 0
    assert torch.equal(info_k["swaps_per_sweep"], info_p["swaps_per_sweep"])
    assert torch.equal(st_k.pod_node, st_p.pod_node)


# ----------------------------------------------------------------- the card


def plain_and_kernels(M, W, w_ids, Wc, chunk, nodes, lam, ow, k, enforce, *, seed=0,
                      moved_share=0.0, invalid_nodes=0):
    """The plain chain — the solvers' gathers, ``chunk_swap``,
    ``commit_swaps``, ``assign[ids] = new_node`` — and kernels 7 and 8 on
    one chunk, each on its own copy of the service arrays. ``chunk``:
    ``(cur, eligible, c_cpu, c_mem, pen, home)``; ``nodes``: ``(cpu_load,
    mem_load, cap, mem_cap)``."""
    svc, _ = service_form(*chunk, M.shape[1], seed=seed, moved_share=moved_share,
                          invalid_nodes=invalid_nodes)
    a = svc.pop("assign")
    assign_p, assign_k = a.clone(), a.clone()
    cl, ml, cap, mcap = nodes
    ids = svc["ids"]
    cur, eligible, pen, home = chunk_rows(assign_p, ids, svc["svc_valid"], svc["moved"],
                                          svc["node_valid"], svc["pen"], svc["home"])
    c_cpu, c_mem = svc["svc_cpu"][ids], svc["svc_mem"][ids]
    new_node, swapped, n = tswap.chunk_swap(M, Wc, cur, eligible, c_cpu, c_mem, cl, ml, cap,
                                            mcap, lam, ow, pen, home, k,
                                            enforce_capacity=enforce)
    assign_p[ids] = new_node
    want = (new_node, swapped, n, *tswap.commit_swaps(cl, ml, cur, new_node, swapped, c_cpu,
                                                      c_mem), assign_p)
    got = (*kswap.chunk_swap_kernels(
        M, W, w_ids, assign_k, ids, svc["svc_valid"], svc["moved"], svc["node_valid"],
        svc["svc_cpu"], svc["svc_mem"], cl, ml, cap, mcap, lam, ow, svc["pen"], svc["home"], k,
        enforce_capacity=enforce), assign_k)
    return want, got


def card_case(seed, C, N, k, *, priced, enforce, big_cap, dense_w, ties, dev):
    """One instance through both; the dense form reads bf16 weights of a
    wider W through ids, the sparse form an f32 Wc of the chunk. A tenth of
    the rows were moved by the single phase and one node is invalid."""
    M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap, pen, home = (
        torch.as_tensor(a, device=dev) for a in swap_instance(seed, C=C, N=N, ties=ties))
    if big_cap:
        mcap = torch.full_like(mcap, tswap.BIG_CAP)
    w_ids, W = None, Wc
    if dense_w:
        g = torch.Generator().manual_seed(seed + 100)
        w_ids = torch.randperm(2 * C, generator=g)[:C].to(dev)
        W = torch.zeros((2 * C, 2 * C), dtype=torch.bfloat16, device=dev)
        W[w_ids[:, None], w_ids[None, :]] = Wc.to(torch.bfloat16)
        Wc = W[w_ids[:, None], w_ids[None, :]].to(torch.float32)
    pen, home = (pen, home) if priced else (None, None)
    return plain_and_kernels(M, W, w_ids, Wc, (cur, elig, c_cpu, c_mem, pen, home),
                             (cl, ml, cap, mcap), 0.5, 10.0, min(k, C), enforce, seed=seed,
                             moved_share=0.1, invalid_nodes=1)


NAMES = ("new_node", "swapped", "n_swaps", "cpu_load", "mem_load", "assign")


@pytest.mark.card
@pytest.mark.parametrize("C", [64, 1024, 1000])
@pytest.mark.parametrize("N", [400, 2000])
@pytest.mark.parametrize("k", [8, 48, 256, "C"])
def test_kernels_decide_as_the_plain_chunk_swap(card, C, N, k):
    k = C if k == "C" else k
    launches0 = kswap.swap_desire.launches, kswap.swap_decide.launches
    cases = 0
    for seed in range(2):
        for priced in (False, True):
            for enforce in (True, False):
                for big_cap in (False, True):
                    for dense_w in (True, False):
                        for ties in (True, False):
                            want, got = card_case(
                                seed, C, N, k, priced=priced, enforce=enforce, big_cap=big_cap,
                                dense_w=dense_w, ties=ties, dev=card)
                            what = (f"seed={seed} priced={priced} enforce={enforce} "
                                    f"big_cap={big_cap} dense_w={dense_w} ties={ties}")
                            for name, w, g in zip(NAMES, want, got):
                                assert g.dtype == w.dtype and torch.equal(g, w), (name, what)
                            cases += 1
    torch.cuda.synchronize()
    assert (kswap.swap_desire.launches - launches0[0],
            kswap.swap_decide.launches - launches0[1]) == (cases, cases)


@pytest.mark.card
@pytest.mark.parametrize("N", [3, 40, 400])
def test_commit_is_index_puts_on_non_integer_demands(card, N):
    """The loads kernel 8 commits are ``commit_swaps``' bit for bit on
    demands and loads with full mantissas, where the order of the adds
    shows: at N = 3 each node holds about 340 of the chunk's rows (runs of
    whole passes of 32 and a rest), at N = 400 a few."""
    C = 1024
    g = torch.Generator(device=card).manual_seed(N)
    rand = lambda *shape: torch.rand(shape, generator=g, device=card)  # noqa: E731
    for trial in range(3):
        M = rand(C, N) * 8
        Wc = torch.where(rand(C, C) < 0.01, rand(C, C), 0.0)
        Wc = Wc + Wc.T
        chunk = ((rand(C) * N).to(torch.int32), rand(C) < 0.9, 50 + rand(C) * 100,
                 rand(C) * 1e3, None, None)
        nodes = (rand(N) * 1e5, rand(N) * 1e6, torch.full((N,), 1e9, device=card),
                 torch.full((N,), tswap.BIG_CAP, device=card))
        want, got = plain_and_kernels(M, Wc, None, Wc, chunk, nodes, 0.0, 10.0, 256, True,
                                      seed=trial)
        assert int(want[2]) > 0
        for name, w, gt in zip(NAMES, want, got):
            assert torch.equal(gt, w), (name, trial)


@pytest.mark.card
def test_ties_self_partners_and_empty_rows(card):
    """Every desire and gain tied, an ineligible row 0 (its all -inf row
    picks itself, p_0 = 0), a chunk with no eligible row at all."""
    C, N = 256, 4
    for elig_share in (0.0, 0.5, 1.0):
        M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap, pen, home = (
            torch.as_tensor(a, device=card) for a in swap_instance(5, C=C, N=N))
        M = torch.ones_like(M)
        Wc = torch.ones_like(Wc) - torch.eye(C, device=card)
        elig = torch.rand(C, generator=torch.Generator().manual_seed(1)).to(card) < elig_share
        elig[0] = False
        for k in (16, C):
            want, got = plain_and_kernels(M, Wc, None, Wc, (cur, elig, c_cpu, c_mem, None, None),
                                          (cl, ml, cap, mcap), 0.0, 0.0, k, True)
            for name, w, g in zip(NAMES, want, got):
                assert torch.equal(g, w), (name, elig_share, k)


def large_solves(form, dev, monkeypatch):
    """One fixed plan on the ``large`` graph, solved op by op with the swap
    kernels and with the plain ``chunk_swap`` (every other kernel on)."""
    from kubernetes_rescheduling_tpu_torch.bench import harness
    from kubernetes_rescheduling_tpu_torch.core import sparsegraph
    from kubernetes_rescheduling_tpu_torch.solver import compiled
    from kubernetes_rescheduling_tpu_torch.solver import global_solver as gs
    from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as ss

    backend = harness.make_backend("large", 0, device=dev)
    state, graph = backend.monitor(), backend.comm_graph()
    cfg = gs.GlobalSolverConfig(sweeps=6, fused_epilogue="on")
    if form == "dense":
        lay = gs.dense_layout(graph.num_services, state.num_nodes, cfg, dev)
        plan = gs.draw_plans(torch.Generator().manual_seed(7), cfg.sweeps, lay.sp, lay.chunk,
                             lay.n_chunks, gs.COMPOSITION_BLOCK)
        module, solve = gs, lambda: gs.global_assign(state, graph, None, cfg, plan=plan)
    else:
        sgraph = sparsegraph.from_comm_graph(graph)
        plan = ss.draw_sparse_plans(torch.Generator().manual_seed(7), cfg.sweeps,
                                    ss.sparse_layout(sgraph, cfg))
        module, solve = ss, lambda: ss.global_assign_sparse(state, sgraph, None, cfg, plan=plan)
    runs = {}
    with compiled.eager():
        n0 = kswap.swap_decide.launches
        runs["kernels"] = solve()
        launched = kswap.swap_decide.launches - n0
        monkeypatch.setattr(module, "takes_kernels", lambda *a: False)
        runs["plain"] = solve()
        monkeypatch.undo()
    return runs, launched


@pytest.mark.card
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_large_solve_places_alike_with_and_without_the_kernels(card, form, monkeypatch):
    runs, launched = large_solves(form, card, monkeypatch)
    (st_k, info_k), (st_p, info_p) = runs["kernels"], runs["plain"]
    assert launched > 0
    assert torch.equal(info_k["swaps_per_sweep"], info_p["swaps_per_sweep"])
    assert int(info_k["swaps_per_sweep"].sum()) > 0
    assert torch.equal(st_k.pod_node, st_p.pod_node)
