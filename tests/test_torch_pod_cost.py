"""Kernel 9 (``ops/pod_cost.py``): each directed edge's cross-node pod
pairs over the pods' run lists, against its plain twin, the dense count
grid.

On the CPU the run lists are checked, and a line-by-line Python copy of the
kernel's walk (the shorter range's node runs, each found in the longer range
by a binary search that starts after the previous match) is held to the
grid form with ``torch.equal``: replicas 1–7 spread over one to all nodes,
slots with more pods than nodes, pods at node −1 and N, invalid pods, empty
slots, self-edges and edges to hub slots. On the card (marked ``card``; they
skip without a CUDA device) the kernel is held to the twin the same way,
``sparse_pod_comm_cost`` to the grid form on both branches, a captured sparse
solve launches the kernel once, and the call allocates a few MB where the
grid needs more than 1 GB. This file imports no JAX, so it runs where the
card is: ``python -m pytest --noconftest -p no:cacheprovider -m card
tests/test_torch_pod_cost.py``.
"""

import bisect

import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu_torch import ops
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg
from kubernetes_rescheduling_tpu_torch.core import topology as ttopo
from kubernetes_rescheduling_tpu_torch.ops import pod_cost
from kubernetes_rescheduling_tpu_torch.solver import global_solver as tgs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as tss


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: kernel 9 runs only on the card")
    return torch.device("cuda")


def pod_arrays(seed: int, case: str = "split", SP: int = 400, N: int = 24, E2: int = 3000,
               unit_weights: bool = False, device="cpu") -> dict:
    """Pods of ``SP`` slots on ``N`` nodes and ``E2`` directed edges.
    ``split``: 1–7 pods a slot on one, two, three or any of the nodes, three
    hub slots of 3N, N + 5 and 2N pods at the head of a fifth of the edges,
    six empty slots, 4% of pods at node −1 and 4% at N, 5% invalid (their
    slot ids out of range), pods in no order, a few self-edges. ``unplaced``:
    the same with every pod at −1 or N."""
    rng = np.random.default_rng(seed)
    reps = rng.integers(1, 8, size=SP)
    reps[:3] = (3 * N, N + 5, 2 * N)
    reps[3:9] = 0
    slot = np.repeat(np.arange(SP), reps)
    P = slot.size
    spread = rng.choice([1, 2, 3, N], size=SP)
    home = rng.integers(0, N, size=(SP, 3))
    pick = np.minimum(rng.integers(0, 3, size=P), spread[slot] - 1)
    node = np.where(spread[slot] == N, rng.integers(0, N, size=P), home[slot, pick])
    off = rng.random(P)
    node[off < 0.04] = -1
    node[(off >= 0.04) & (off < 0.08)] = N
    if case == "unplaced":
        node = np.where(off < 0.5, -1, N)
    valid = rng.random(P) > 0.05
    slot = np.where(valid, slot, rng.integers(SP, 4 * SP, size=P))
    perm = rng.permutation(P)
    slot, node, valid = slot[perm], node[perm], valid[perm]
    src = rng.integers(0, SP, size=E2)
    dst = rng.integers(0, SP, size=E2)
    src[:E2 // 10] = rng.integers(0, 3, size=E2 // 10)
    dst[E2 // 10:E2 // 5] = rng.integers(0, 3, size=E2 // 5 - E2 // 10)
    dst[-20:] = src[-20:]
    w = np.ones(E2) if unit_weights else rng.lognormal(0.0, 1.0, size=E2)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)  # noqa: E731
    return dict(
        slot=as_t(slot, torch.int32), node=as_t(node, torch.int32),
        placed=as_t(valid & (node >= 0) & (node < N), torch.bool),
        edges_src=as_t(src, torch.int32), edges_dst=as_t(dst, torch.int32),
        edges_w=as_t(w, torch.float32), num_slots=SP, num_nodes=N,
    )


def kernel_walk(keys, offs, edges_src, edges_dst, edges_w, num_nodes):
    """``pod_cross_kernel`` line by line in Python over the run lists: each
    edge's walk in integers, then its three f32 operations in torch (each
    rounded on its own, as the kernel's ``_rn`` intrinsics round them)."""
    keys, offs = keys.tolist(), offs.tolist()
    n1 = num_nodes + 1
    na_l, nb_l, kept_l = [], [], []
    for s, t in zip(edges_src.tolist(), edges_dst.tolist()):
        a, a_end, b, b_end = offs[s], offs[s + 1], offs[t], offs[t + 1]
        na, nb = a_end - a, b_end - b
        if na > nb:
            a, a_end, b, b_end, s, t = b, b_end, a, a_end, t, s
        to_b = (t - s) * n1
        kept = 0
        while a < a_end and b < b_end:
            key = keys[a]
            run_end = a + 1
            while run_end < a_end and keys[run_end] == key:
                run_end += 1
            target = key + to_b
            b = bisect.bisect_left(keys, target, b, b_end)
            match_end = b
            while match_end < b_end and keys[match_end] == target:
                match_end += 1
            kept += (run_end - a) * (match_end - b)
            a, b = run_end, match_end
        na_l.append(na)
        nb_l.append(nb)
        kept_l.append(kept)
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    cross = torch.clamp_min(f(na_l) * f(nb_l) - f(kept_l), 0.0)
    return edges_w * cross


def plain(x: dict) -> torch.Tensor:
    return pod_cost.pod_pair_cross_plain(**x)


# ------------------------------------------------------------------- the CPU


@pytest.mark.parametrize("case", ["split", "unplaced"])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_lists_hold_each_slot_sorted_by_node(seed, case):
    x = pod_arrays(seed, case)
    SP, N = x["num_slots"], x["num_nodes"]
    keys, offs = pod_cost.run_lists(x["slot"], x["node"], x["placed"], SP, N)
    placed = x["placed"]
    counts = torch.bincount(x["slot"][placed].long(), minlength=SP)
    assert torch.equal(offs[1:] - offs[:-1], counts)
    assert int(offs[0]) == 0 and int(offs[-1]) == int(placed.sum())
    assert bool((keys[1:] >= keys[:-1]).all())
    assert bool((keys[int(offs[-1]):] == SP * (N + 1)).all())
    slot_of = torch.repeat_interleave(torch.arange(SP), counts)
    head = keys[:int(offs[-1])]
    assert torch.equal(head // (N + 1), slot_of)
    assert bool((head % (N + 1) < N).all())
    if case == "unplaced":
        assert int(offs[-1]) == 0


@pytest.mark.parametrize("unit_weights", [True, False])
@pytest.mark.parametrize("case", ["split", "unplaced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_kernels_walk_equals_the_grid_form(seed, case, unit_weights):
    """With unit weights the terms are the edges' cross-node pod pairs
    themselves; the walk gives them exactly, and the weighted terms bit for
    bit."""
    x = pod_arrays(seed, case, unit_weights=unit_weights)
    keys, offs = pod_cost.run_lists(x["slot"], x["node"], x["placed"], x["num_slots"],
                                    x["num_nodes"])
    got = kernel_walk(keys, offs, x["edges_src"], x["edges_dst"], x["edges_w"], x["num_nodes"])
    want = plain(x)
    assert torch.equal(got, want)
    if case == "split":
        assert int((want > 0).sum()) > 0


def test_the_grid_form_counts_cross_node_pairs():
    """Two slots of three placed pods: slot 0 on nodes 0, 0, 1, slot 1 on 0,
    1, 1 and a fourth pod at node −1. Of their 3·3 pairs 2·1 + 1·2 share a
    node, so 5 cross; a self-edge of slot 0 keeps 2·2 + 1·1 of 9."""
    x = dict(slot=torch.tensor([0, 0, 0, 1, 1, 1, 1], dtype=torch.int32),
             node=torch.tensor([0, 0, 1, 0, 1, 1, -1], dtype=torch.int32),
             edges_src=torch.tensor([0, 1, 0], dtype=torch.int32),
             edges_dst=torch.tensor([1, 0, 0], dtype=torch.int32),
             edges_w=torch.tensor([2.0, 3.0, 1.0]), num_slots=2, num_nodes=2)
    x["placed"] = x["node"] >= 0
    want = torch.tensor([2.0 * 5, 3.0 * 5, 1.0 * 4])
    assert torch.equal(plain(x), want)
    keys, offs = pod_cost.run_lists(x["slot"], x["node"], x["placed"], 2, 2)
    assert torch.equal(kernel_walk(keys, offs, x["edges_src"], x["edges_dst"], x["edges_w"], 2),
                       want)


def test_the_wrapper_takes_the_plain_twin_on_the_cpu():
    x = pod_arrays(3)
    ops.reset_launch_counts()
    assert torch.equal(pod_cost.pod_pair_cross(**x), plain(x))
    assert ops.launch_counts()["pod_pair_cross"] == 0
    empty = dict(x, edges_src=x["edges_src"][:0], edges_dst=x["edges_dst"][:0],
                 edges_w=x["edges_w"][:0])
    assert pod_cost.pod_pair_cross(**empty).shape == (0,)


def test_the_wrapper_refuses_other_devices():
    x = pod_arrays(4)
    x["edges_w"] = x["edges_w"].to("meta")
    with pytest.raises(ValueError):
        pod_cost.pod_pair_cross(**x)


# ------------------------------------------------------------------ the card


def split_scenario(device, seed: int = 5, collapse: bool = False):
    """A power-law mesh of 900 one-pod services on 8 nodes, its pods dealt
    to random services (0 to about 7 pods each, so some hold more pods than
    there are nodes) on random nodes, 5% at node −1 and 5% invalid; with
    ``collapse`` each service's pods on its first pod's node."""
    scn = ttopo.synthetic_scenario(n_pods=900, n_nodes=8, powerlaw=True, seed=seed,
                                   device=device)
    rng = np.random.default_rng(seed)
    P, S = scn.state.num_pods, scn.graph.num_services
    svc = rng.integers(0, S // 2, size=P)
    nodes = rng.integers(0, 8, size=P)
    nodes[rng.random(P) < 0.05] = -1
    if collapse:
        first = {}
        nodes = np.asarray([first.setdefault(int(s), int(n)) for s, n in zip(svc, nodes)])
    state = scn.state.replace(
        pod_service=torch.as_tensor(svc, dtype=scn.state.pod_service.dtype, device=device),
        pod_node=torch.as_tensor(nodes, dtype=torch.int32, device=device),
        pod_valid=scn.state.pod_valid & torch.as_tensor(rng.random(P) > 0.05, device=device))
    return state, tsg.from_comm_graph(scn.graph, bu=128, reg_tiles=2, device=device)


@pytest.mark.card
@pytest.mark.parametrize("unit_weights", [True, False])
@pytest.mark.parametrize("case", ["split", "unplaced"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_equals_its_plain_twin_on_the_card(card, seed, case, unit_weights):
    x = pod_arrays(seed, case, unit_weights=unit_weights, device=card)
    got = pod_cost.pod_pair_cross(**x)
    again = pod_cost.pod_pair_cross(**x)
    want = plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.card
@pytest.mark.parametrize("collapse", [False, True])
def test_sparse_pod_comm_cost_on_the_card_equals_the_grid_form(card, monkeypatch, collapse):
    """Bit for bit against the grid form on the card (one sum over the same
    terms), and within rel 1e-6 of the CPU's."""
    state, sgraph = split_scenario(card, collapse=collapse)
    ops.reset_launch_counts()
    got = tss.sparse_pod_comm_cost(state, sgraph)
    assert ops.launch_counts()["pod_pair_cross"] == 1
    cpu = tss.sparse_pod_comm_cost(*split_scenario("cpu", collapse=collapse))
    monkeypatch.setattr(tss, "pod_pair_cross", pod_cost.pod_pair_cross_plain)
    want = tss.sparse_pod_comm_cost(state, sgraph)
    assert torch.equal(got, want)
    assert float(got) == pytest.approx(float(cpu), rel=1e-6)
    assert float(got) > 0


@pytest.mark.card
def test_one_launch_per_captured_sparse_solve(card):
    from kubernetes_rescheduling_tpu_torch.solver import compiled

    state, sgraph = split_scenario(card)
    cfg = tgs.GlobalSolverConfig(sweeps=3)
    compiled.CACHE.clear()
    for seed in (0, 1):  # the capture, then a replay
        ops.reset_launch_counts()
        tss.global_assign_sparse(state, sgraph, torch.Generator().manual_seed(seed), cfg)
        torch.cuda.synchronize()
        assert ops.launch_counts()["pod_pair_cross"] == 1
    assert compiled.CACHE.latest() is not None


@pytest.mark.card
def test_the_call_allocates_megabytes_where_the_grid_needs_gigabytes(card):
    from kubernetes_rescheduling_tpu_torch.bench.harness import sparse_problem

    state, sgraph = sparse_problem(40_000, 5_000, seed=0, device=card)
    N = state.num_nodes
    assert (sgraph.sp + 1) * (N + 1) * 8 > 2**30  # the grid's int64 counts alone
    gen = torch.Generator(device=card).manual_seed(0)
    state = state.replace(pod_node=torch.randint(-1, N, (state.num_pods,), generator=gen,
                                                 device=card, dtype=torch.int32))
    tss.sparse_pod_comm_cost(state, sgraph)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    cost = tss.sparse_pod_comm_cost(state, sgraph)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - m0 < 64 * 2**20
    assert float(cost) > 0
